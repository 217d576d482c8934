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


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


@pytest.mark.cuda
def test_graph_replay_runs_the_kernel_and_counts_it(cuda_device):
    """A windowed search recorded into a CUDA graph: the capture launches
    nothing and counts in `captured`; every replay runs the kernel, gives
    what the eager call gives on the inputs of that moment, and adds the
    step's launches to `launches`. State named in `restore` survives the
    warm-up and the capture."""
    from ar_orbslam2_tpu_torch.system.graph import N_WARMUP, GraphRunner
    args = _torch(_problem(1024, 1024, False, seed=21), cuda_device)
    args[0] = TH.packed_from_signs(args[0])
    args[6] = TH.packed_from_signs(args[6])
    out = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    calls = torch.zeros((), dtype=torch.int32, device=cuda_device)

    def step():
        idx, _ = CH.fused_windowed_top2(*args, nn_ratio=0.9)
        out.copy_(idx)
        calls.add_(1)

    runner = GraphRunner(step, cuda_device, restore=[calls])
    launched, captured = (CH.fused_windowed_top2.launches,
                          CH.fused_windowed_top2.captured)
    runner.capture()
    assert (runner.captures, runner.launches_per_replay) == (1, 1)
    assert CH.fused_windowed_top2.captured == captured + 1
    assert CH.fused_windowed_top2.launches == launched + N_WARMUP
    assert int(calls) == 0 and runner.n_nodes >= 3
    launched = CH.fused_windowed_top2.launches
    for shift in (0.0, 40.0):            # new inputs in the same buffers
        args[1].add_(shift)
        runner.run()
        want, _ = CH.fused_windowed_top2_reference(*args, nn_ratio=0.9)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert int(calls) == 2 and runner.replays == 2 and runner.captures == 1
    assert CH.fused_windowed_top2.launches == launched + 2


def _batched_problem(n, m, n_batch, seed, device):
    """One query descriptor set against n_batch keypoint sets, each with its
    own query geometry: the fuse's shape (one landmark bundle projected
    into several keyframes)."""
    items = [_torch(_problem(n, m, b % 2 == 1, seed=seed + b), device)
             for b in range(n_batch)]
    args = []
    for i in range(10):
        args.append(items[0][0] if i == 0
                    else torch.stack([it[i] for it in items]))
    return args


def test_batched_plain_version_is_single_calls_stacked():
    args = _batched_problem(48, 40, 3, seed=30, device="cpu")
    for mutual in (False, True):
        got = CH.fused_windowed_top2(*args, nn_ratio=0.8, mutual=mutual)
        assert got[0].shape == got[1].shape == (3, 48)
        for b in range(3):
            want = CH.fused_windowed_top2_reference(
                *CH._item(args, b), nn_ratio=0.8, mutual=mutual)
            assert torch.equal(got[0][b], want[0])
            assert torch.equal(got[1][b], want[1])
    raw = CH.top2(*args)
    for b in range(3):
        for a, w in zip(raw, CH.top2_reference(*CH._item(args, b))):
            assert torch.equal(a[b], w)


def test_scalar_radius_and_no_octave_gate_equal_the_tensor_forms():
    args = _torch(_problem(40, 30, False, seed=31))
    n = 40
    full = list(args)
    full[2] = torch.full((n,), 12.5)
    full[3] = torch.full((n,), -(10 ** 6), dtype=torch.int32)
    full[4] = torch.full((n,), 10 ** 6, dtype=torch.int32)
    short = list(args)
    short[2], short[3], short[4] = 12.5, None, None
    for a, b in zip(CH.fused_windowed_top2(*short),
                    CH.fused_windowed_top2(*full)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nn_ratio", [1.0, 0.8])
@pytest.mark.parametrize("mutual", [False, True])
def test_fused_filter_matches_plain_on_card(cuda_device, mutual, nn_ratio,
                                            ties):
    """Threshold, ratio and mutual-best run inside the one launch and give
    the plain version's (idx, d0) exactly, twice in a row on one workspace
    (the kernel leaves it reset)."""
    for n, m in ((4096, 1024), (1000, 997), (64, 2500)):
        args = _torch(_problem(n, m, ties, seed=n + 5), cuda_device)
        want = CH.fused_windowed_top2_reference(*args, nn_ratio=nn_ratio,
                                                mutual=mutual)
        for _ in range(2):
            got = CH.fused_windowed_top2(*args, nn_ratio=nn_ratio,
                                         mutual=mutual)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_workspace_is_left_reset_on_card(cuda_device):
    args = _torch(_problem(2048, 1024, True, seed=41), cuda_device)
    CH.fused_windowed_top2(*args)
    CH.top2_cuda(*args)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    ws = CH._STREAM_WS[(args[1].device.index, stream)]
    assert bool((ws.keys == 2 ** 31 - 1).all())
    assert bool((ws.counter == 0).all())


@pytest.mark.cuda
def test_batched_launch_matches_single_calls_on_card(cuda_device):
    """B = 5 searches in one launch (grid.y) equal five single launches and
    the plain version; the launch count rises by one."""
    args = _batched_problem(2048, 1024, 5, seed=50, device=cuda_device)
    args[0] = TH.packed_from_signs(args[0])
    args[6] = TH.packed_from_signs(args[6])
    before = CH.fused_windowed_top2.launches
    got = CH.fused_windowed_top2(*args, th=50, nn_ratio=1.0)
    raw = CH.top2_cuda(*args)
    torch.cuda.synchronize()
    assert CH.fused_windowed_top2.launches == before + 2
    for b in range(5):
        item = CH._item(args, b)
        single = CH.fused_windowed_top2(*item, th=50, nn_ratio=1.0)
        want = CH.fused_windowed_top2_reference(*item, th=50, nn_ratio=1.0)
        for g, s_, w in zip(got, single, want):
            assert torch.equal(g[b], s_) and torch.equal(s_, w)
        for g, w in zip(raw, CH.top2_reference(*item)):
            assert torch.equal(g[b], w)


@pytest.mark.cuda
def test_scalar_radius_and_no_octave_gate_on_card(cuda_device):
    args = _torch(_problem(1024, 1024, False, seed=61), cuda_device)
    args[2], args[3], args[4] = 30.0, None, None
    got = CH.fused_windowed_top2(*args, nn_ratio=0.9)
    want = CH.fused_windowed_top2_reference(*args, nn_ratio=0.9)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_unaligned_inputs_on_card(cuda_device):
    """Keypoint arrays that start off a 16-byte boundary take the kernel's
    plain-load staging and give the same result."""
    args = _torch(_problem(512, 301, False, seed=71), cuda_device)
    args[0] = TH.packed_from_signs(args[0])
    args[6] = TH.packed_from_signs(args[6])
    want = CH.fused_windowed_top2_reference(*args)
    shifted = list(args)
    for i in (7, 8, 9):             # a view one row into a larger buffer
        buf = torch.cat([args[i][:1], args[i]])
        shifted[i] = buf[1:]
    flat = torch.cat([args[6].new_zeros(4), args[6].reshape(-1)])
    shifted[6] = flat[4:].view(301, 32)         # 4 bytes off the boundary
    assert shifted[6].data_ptr() % 16 == 4
    got = CH.fused_windowed_top2(*shifted)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
