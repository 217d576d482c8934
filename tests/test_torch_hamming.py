"""Parity of the port's Hamming ops and windowed top-2 search with the JAX
package (ops/hamming.py, ops/pallas_hamming.py).

Every comparison here is exact: the outputs are integers (distances,
indices), and the port's tie rules (argmin first index, stable sorts) are
built to reproduce lax.top_k's lowest-index-first order. Inputs come from
numpy with a fixed seed and go through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.ops import hamming as JH
from ar_orbslam2_tpu.ops.pallas_hamming import fused_windowed_top2 as jax_top2
from ar_orbslam2_tpu_torch.ops import cuda_hamming as CH
from ar_orbslam2_tpu_torch.ops import hamming as TH
from test_torch_cuda_kernel import _problem


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args):
    return [torch.as_tensor(a) for a in args]


def test_pack_unpack_and_signs_match():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (37, 256)).astype(np.uint8)
    np.testing.assert_array_equal(TH.pack_bits(bits), JH.pack_bits(bits))
    packed = JH.pack_bits(bits)
    np.testing.assert_array_equal(TH.unpack_bits(packed),
                                  JH.unpack_bits(packed))
    np.testing.assert_array_equal(
        TH.pack_bits_device(torch.as_tensor(bits)).numpy(),
        np.asarray(JH.pack_bits_device(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        TH.signs_from_packed(torch.as_tensor(packed)).numpy(),
        np.asarray(JH.signs_from_packed(jnp.asarray(packed))))
    np.testing.assert_array_equal(
        TH.packed_from_signs(TH.to_signs(bits)).numpy(), packed)


def test_hamming_matrix_and_best_match_ties():
    """best_match on a tie-heavy matrix: distances in [0, 4), so most rows
    hold several equal minima — the first-index rule decides them."""
    rng = np.random.default_rng(1)
    a = (rng.integers(0, 2, (50, 256)) * 2 - 1).astype(np.int8)
    b = (rng.integers(0, 2, (70, 256)) * 2 - 1).astype(np.int8)
    va, vb = rng.random(50) > 0.2, rng.random(70) > 0.2
    np.testing.assert_array_equal(
        TH.hamming_matrix(*_torch([a, b, va, vb])).numpy(),
        np.asarray(JH.hamming_matrix(*_jax([a, b, va, vb]))))
    dist = rng.integers(0, 4, (64, 48)).astype(np.int32)
    for th, ratio in ((2, 1.0), (3, 0.9), (257, 1.0)):
        i_t, d_t = TH.best_match(torch.as_tensor(dist), th, ratio)
        i_j, d_j = JH.best_match(jnp.asarray(dist), th, ratio)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


def test_mutual_filter_and_rotation_consistency_ties():
    rng = np.random.default_rng(2)
    idx_ab = rng.integers(-1, 40, 60).astype(np.int32)
    idx_ba = rng.integers(-1, 60, 40).astype(np.int32)
    np.testing.assert_array_equal(
        TH.mutual_filter(*_torch([idx_ab, idx_ba])).numpy(),
        np.asarray(JH.mutual_filter(*_jax([idx_ab, idx_ba]))))
    # angles on the 12-degree bin grid: the 30-bin histogram has equal
    # counts in many bins, so the top-3 choice is decided by tie order
    ang_a = (rng.integers(0, 30, 200) * 12.0).astype(np.float32)
    ang_b = (rng.integers(0, 30, 150) * 12.0).astype(np.float32)
    match = rng.integers(-1, 150, 200).astype(np.int32)
    np.testing.assert_array_equal(
        TH.rotation_consistency(*_torch([ang_a, ang_b, match])).numpy(),
        np.asarray(JH.rotation_consistency(*_jax([ang_a, ang_b, match]))))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("mutual", [False, True])
@pytest.mark.parametrize("n,m", [(128, 256), (200, 131)])
def test_windowed_top2_reference_matches_xla(n, m, ties, mutual):
    """The port's plain version equals the JAX XLA path exactly, on
    aligned and ragged shapes, tie-free and tie-heavy."""
    args = _problem(n, m, ties, seed=n + m)
    idx_j, d0_j = jax_top2(*_jax(args), th=JH.TH_HIGH, nn_ratio=0.9,
                           mutual=mutual, force="xla")
    idx_t, d0_t = CH.fused_windowed_top2_reference(
        *_torch(args), th=JH.TH_HIGH, nn_ratio=0.9, mutual=mutual)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d0_t.numpy(), np.asarray(d0_j))
    assert (idx_t >= 0).sum() > 10
    # on CPU tensors the public wrapper takes the plain version
    idx_w, d0_w = CH.fused_windowed_top2(*_torch(args), th=JH.TH_HIGH,
                                         nn_ratio=0.9, mutual=mutual)
    assert torch.equal(idx_w, idx_t) and torch.equal(d0_w, d0_t)


@pytest.mark.parametrize("ties", [False, True])
def test_windowed_top2_reference_matches_pallas(ties):
    """Against the Pallas kernel itself (interpret mode on the CPU)."""
    args = _problem(128, 128, ties, seed=5)
    idx_j, d0_j = jax_top2(*_jax(args), th=JH.TH_HIGH, nn_ratio=0.9,
                           mutual=True, force="pallas")
    idx_t, d0_t = CH.fused_windowed_top2_reference(
        *_torch(args), th=JH.TH_HIGH, nn_ratio=0.9, mutual=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(d0_t.numpy(), np.asarray(d0_j))


def test_packed_descriptors_give_the_same_result():
    args = _torch(_problem(96, 80, True, seed=9))
    want = CH.fused_windowed_top2_reference(*args)
    packed = list(args)
    packed[0] = TH.packed_from_signs(args[0])
    packed[6] = TH.packed_from_signs(args[6])
    got = CH.fused_windowed_top2_reference(*packed)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
