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


def test_a_stalled_rank_fails_at_the_deadline():
    """Rank 1 sleeps far past a short deadline: spawn_local stops the
    ranks within seconds of it and names rank 1."""
    deadline = 10.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"rank 1\b.*did not finish "
                       r"within 10\.0 s"):
        multihost.spawn_local(2, W.stalled_rank, 600.0, timeout=deadline)
    assert time.monotonic() - t0 < deadline + 10.0
