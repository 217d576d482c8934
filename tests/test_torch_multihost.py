"""The port's multi-process group (parallel/multihost.py) on the CPU: two
gloo ranks started by spawn_local meet through a FileStore in a
temporary directory — no port is bound and released first, the race of
tests/test_multihost.py — and run selftest's sum (rank r contributes
r + 1 in each of 4 slots: 12 in all). The ranks live in
tests/torch_dist_workers.py, which imports no jax.
"""
import time

import pytest
import torch
import torch.distributed as dist

from ar_orbslam2_tpu_torch.parallel import multihost

import torch_dist_workers as W

SPAWN_LIMIT_S = 120      # each group's own time limit, start-up included


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_two_rank_selftest_through_a_file_store(tmp_path):
    multihost.spawn_local(2, W.selftest_rank, str(tmp_path),
                          timeout=SPAWN_LIMIT_S)
    assert [(tmp_path / f"rank{r}.rc").read_text() for r in (0, 1)] \
        == ["0", "0"]
    assert not dist.is_initialized()          # the group lived in children


def test_nothing_announced_starts_no_group(monkeypatch, capsys):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_from_env() is False
    assert multihost.selftest(device="cpu") == 2
    assert "no group configured" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_a_failing_rank_raises(tmp_path):
    with pytest.raises(Exception, match="rank 1 gives up"):
        multihost.spawn_local(2, W.failing_rank, timeout=SPAWN_LIMIT_S)


def test_every_failed_rank_is_named():
    """Both ranks raise, each its own message, after the group is set up:
    the error names both ranks with their own messages."""
    with pytest.raises(RuntimeError) as err:
        multihost.spawn_local(2, W.both_failing_rank, timeout=SPAWN_LIMIT_S)
    text = str(err.value)
    assert "2 of 2 ranks failed" in text
    for r in (0, 1):
        assert f"rank {r} failed in fn" in text
        assert f"ValueError: rank {r} has its own complaint" in text


def test_a_rank_stuck_in_tear_down_is_stopped(monkeypatch):
    """fn returned on both ranks; rank 1 hangs in the group's tear-down:
    spawn_local stops it within its grace, raises nothing, and warns,
    naming rank 1 alone with the stack it hung in."""
    monkeypatch.setattr(multihost, "EXIT_GRACE_S", 2.0)
    t0 = time.monotonic()
    with pytest.warns(multihost.RankStoppedWarning) as caught:
        multihost.spawn_local(2, W.lingering_rank, 600.0,
                              timeout=SPAWN_LIMIT_S)
    assert time.monotonic() - t0 < 60.0
    text = "\n".join(str(w.message) for w in caught
                     if w.category is multihost.RankStoppedWarning)
    assert text.startswith("rank 1 returned from fn but was still running")
    assert "rank 0" not in text
    assert "in slow" in text            # the hook it was sleeping in


def test_a_stalled_rank_fails_at_the_deadline():
    """Rank 1 sleeps far past a short deadline: spawn_local stops the
    ranks within seconds of it and names rank 1."""
    deadline = 10.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank 1\b.*did not finish "
                       r"within 10\.0 s") as err:
        multihost.spawn_local(2, W.stalled_rank, 600.0, timeout=deadline)
    assert time.monotonic() - t0 < deadline + 10.0
    assert "in stalled_rank" in str(err.value)     # where it was stopped
