"""The port's multi-process group (parallel/multihost.py) on the CPU: two
gloo ranks started by spawn_local meet through a FileStore in a
temporary directory — no port is bound and released first, the race of
tests/test_multihost.py — and run selftest's sum (rank r contributes
r + 1 in each of 4 slots: 12 in all). The ranks live in
tests/torch_dist_workers.py, which imports no jax.
"""
import pytest
import torch.distributed as dist

from ar_orbslam2_tpu_torch.parallel import multihost

import torch_dist_workers as W


def test_two_rank_selftest_through_a_file_store(tmp_path):
    multihost.spawn_local(2, W.selftest_rank, str(tmp_path))
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
        multihost.spawn_local(2, W.failing_rank)
