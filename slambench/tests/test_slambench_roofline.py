"""The Hamming search's work count against a brute-force count of the
windowed pairs on tiny inputs."""
import itertools

import numpy as np
import pytest
import torch

from slambench.roofline import hamming as RH
from slambench.roofline import peaks


def _inputs(rng, n, m, batch=None, radius_tensor=True, octaves=True):
    b = () if batch is None else (batch,)
    q_uv = torch.tensor(rng.uniform(0, 60, b + (n, 2)), dtype=torch.float32)
    kp_uv = torch.tensor(rng.uniform(0, 60, (m, 2)), dtype=torch.float32)
    r = torch.tensor(rng.uniform(2, 15, b + (n,)), dtype=torch.float32) \
        if radius_tensor else 7.5
    olo = torch.tensor(rng.integers(0, 3, b + (n,)), dtype=torch.int32)
    ohi = olo + torch.tensor(rng.integers(0, 3, b + (n,)), dtype=torch.int32)
    kp_oct = torch.tensor(rng.integers(0, 6, m), dtype=torch.int32)
    q_valid = torch.tensor(rng.random(b + (n,)) < 0.8)
    kp_valid = torch.tensor(rng.random(m) < 0.9)
    q_desc = torch.zeros(b + (n, 32), dtype=torch.uint8)
    kp_desc = torch.zeros((m, 32), dtype=torch.uint8)
    return (q_desc, q_uv, r, olo if octaves else None,
            ohi if octaves else None, q_valid, kp_desc, kp_uv, kp_oct,
            kp_valid)


def _brute(args):
    (_, q_uv, r, olo, ohi, q_valid, _, kp_uv, kp_oct, kp_valid) = args
    q_uv = q_uv.numpy()
    batch = q_uv.shape[:-2]
    total = 0
    for bi in itertools.product(*[range(s) for s in batch]):
        for i, j in itertools.product(range(q_uv.shape[-2]),
                                      range(kp_uv.shape[0])):
            rad = float(r[bi][i]) if torch.is_tensor(r) else r
            if not (q_valid[bi][i] and kp_valid[j]):
                continue
            if abs(q_uv[bi][i][0] - float(kp_uv[j, 0])) > rad or \
                    abs(q_uv[bi][i][1] - float(kp_uv[j, 1])) > rad:
                continue
            if olo is not None and not (int(olo[bi][i]) <= int(kp_oct[j])
                                        <= int(ohi[bi][i])):
                continue
            total += 1
    return total


@pytest.mark.parametrize("batch,radius_tensor,octaves", [
    (None, True, True), (None, False, False), (3, True, True)])
def test_pairs_match_a_brute_force_count(batch, radius_tensor, octaves):
    args = _inputs(np.random.default_rng(1), 17, 23, batch, radius_tensor,
                   octaves)
    pairs, nbytes = RH.work(args)
    assert pairs == _brute(args)
    b = 1 if batch is None else batch
    per_q = 32 + 8 + 1 + (4 if radius_tensor else 0) + (8 if octaves else 0)
    assert nbytes == b * 17 * per_q + 23 * (32 + 8 + 4 + 1) + b * 2 * 17 * 4


def test_least_time_is_the_larger_bound():
    s, by = RH.least_seconds(10 ** 9, 10)
    assert by == "operations"
    assert s == pytest.approx(8e9 / (16 * 132 * 1.98e9))
    s, by = RH.least_seconds(1, 3.35e9)
    assert by == "bytes" and s == pytest.approx(1e-3)
    assert peaks.POPC_PER_S == 16 * 132 * 1.98e9
