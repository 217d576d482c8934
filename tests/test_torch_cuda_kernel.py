"""The hand-written Hamming top-2 kernel (csrc/cuda_hamming.cu) against its
plain PyTorch version.

This file imports neither jax nor the JAX package, so the card tests run on
a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernel.py

(``--noconftest`` skips tests/conftest.py, which imports jax.) Without a GPU
the card tests skip; the CPU tests check what the wrapper does with CPU
tensors. Every comparison is exact: the outputs are integer distances and
indices, and both versions follow the same first-index tie rules.
"""
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu_torch.ops import cuda_hamming as CH
from ar_orbslam2_tpu_torch.ops import hamming as TH


def _problem(n, m, ties, seed):
    """Windowed-search inputs as numpy arrays, in the argument order of
    fused_windowed_top2. ties=True repeats every keypoint (descriptor, uv,
    octave) 4x and every query 2x, so rows and columns tie exactly."""
    rng = np.random.default_rng(seed)
    if ties:
        base = rng.integers(0, 2, (-(-m // 4), 256))
        kp_bits = np.repeat(base, 4, axis=0)[:m]
        kp_uv = np.repeat(rng.uniform([0, 0], [640, 480], (len(base), 2)),
                          4, axis=0)[:m]
        kp_oct = np.repeat(rng.integers(0, 8, len(base)), 4)[:m]
        src = np.repeat(rng.integers(0, m, -(-n // 2)), 2)[:n]
        q_bits, q_uv = kp_bits[src].copy(), kp_uv[src].copy()
    else:
        kp_bits = rng.integers(0, 2, (m, 256))
        kp_uv = rng.uniform([0, 0], [640, 480], (m, 2))
        kp_oct = rng.integers(0, 8, m)
        src = rng.integers(0, m, n)
        q_bits = kp_bits[src] ^ (rng.random((n, 256)) < 0.1)
        q_uv = kp_uv[src] + rng.normal(0, 3, (n, 2))
    q_oct = kp_oct[src]
    return [(q_bits * 2 - 1).astype(np.int8), q_uv.astype(np.float32),
            rng.uniform(4, 25, n).astype(np.float32),
            (q_oct - 1).astype(np.int32), (q_oct + 1).astype(np.int32),
            rng.random(n) > 0.1, (kp_bits * 2 - 1).astype(np.int8),
            kp_uv.astype(np.float32), kp_oct.astype(np.int32),
            rng.random(m) > 0.05]


def _torch(args, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in args]


def test_kernel_launcher_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        CH.top2_cuda(*_torch(_problem(16, 16, False, seed=3)))


def test_wrapper_takes_the_plain_version_on_cpu_without_counting():
    args = _torch(_problem(40, 30, False, seed=4))
    before = CH.fused_windowed_top2.launches
    got = CH.fused_windowed_top2(*args)
    want = CH.fused_windowed_top2_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert CH.fused_windowed_top2.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,m", [(1024, 1024), (2048, 1024), (4096, 1024),
                                 (1000, 997)])
def test_kernel_matches_plain_on_card(cuda_device, n, m, ties):
    """The CUDA kernel is bit-identical to its plain version on the card."""
    args = _torch(_problem(n, m, ties, seed=n), cuda_device)
    got = CH.top2_cuda(*args)
    want = CH.top2_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mutual", [False, True])
def test_wrapper_launches_the_kernel_on_card(cuda_device, mutual):
    """On CUDA tensors the public wrapper launches the kernel (the count
    rises by one) and equals the plain version, on signs and on packed
    descriptors."""
    args = _torch(_problem(300, 257, True, seed=11), cuda_device)
    packed = list(args)
    packed[0] = TH.packed_from_signs(args[0])
    packed[6] = TH.packed_from_signs(args[6])
    want = CH.fused_windowed_top2_reference(*args, nn_ratio=0.9,
                                            mutual=mutual)
    for inputs in (args, packed):
        before = CH.fused_windowed_top2.launches
        got = CH.fused_windowed_top2(*inputs, nn_ratio=0.9, mutual=mutual)
        torch.cuda.synchronize()
        assert CH.fused_windowed_top2.launches == before + 1
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_no_queries_launch_nothing(cuda_device):
    """With no query rows there is nothing to launch, so the count holds;
    every keypoint keeps the all-INF column's (INF, row 0)."""
    args = _torch(_problem(8, 20, False, seed=13), cuda_device)
    empty = [a[:0] if i < 6 else a for i, a in enumerate(args)]
    before = CH.fused_windowed_top2.launches
    idx0, d0, d1, kp_best_d, kp_best_q = CH.top2_cuda(*empty)
    assert CH.fused_windowed_top2.launches == before
    assert idx0.numel() == d0.numel() == d1.numel() == 0
    assert bool((kp_best_d == CH.INF).all()) and bool((kp_best_q == 0).all())


@pytest.mark.cuda
def test_kernel_launcher_checks_its_inputs(cuda_device):
    args = _torch(_problem(64, 64, False, seed=12), cuda_device)
    bad_dtype = list(args)
    bad_dtype[1] = args[1].double()
    with pytest.raises(TypeError):
        CH.top2_cuda(*bad_dtype)
    bad_layout = list(args)
    bad_layout[7] = args[7].t().contiguous().t()   # (M, 2), not contiguous
    with pytest.raises(ValueError):
        CH.top2_cuda(*bad_layout)
