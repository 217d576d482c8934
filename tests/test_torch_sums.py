"""The port's ordered indexed sum (core/sums.py) and the solvers built on it.

Every floating-point indexed sum of the port goes through
``sums.IndexSum``, whose order is fixed by its inputs on the CPU and on
the card: the same input gives the same bits on every run, as the JAX
package's one-hot matmuls do. Tolerances and why:

* IndexSum against ``index_add_``: 1e-6 relative, per entry, to the sum
  of the magnitudes of its terms (float32 sums of the same terms in two
  orders; the sum itself may cancel); its CUDA route, planned once,
  against a sorted ``index_put_(accumulate=True)`` per block made at each
  call: bit for bit (the same additions in the same order);
* schur_blocks against the JAX function: the JAX package assembles Hcc and
  S with bf16 operands (~0.4 % relative per product, its MXU trade), so
  S is held to 1e-2 of its largest entry; b_s (float32 in both) and the
  per-landmark pieces to 1e-5. Against a float64 one-hot sum, S is held to
  1e-5.

The static guard fails when an ``index_add``, ``scatter_add``,
``scatter_reduce`` or ``index_put_(..., accumulate=True)`` is called
outside core/sums.py, unless the allow-list names the call and why its
sum cannot depend on the order (integer data) or never runs on the
system's path (eval/sum_routes.py's comparison routes). The card test
runs the helper and a local BA twice each on the GPU and compares the
bits; it skips without a card. Only the JAX comparison imports jax, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_sums.py
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from ar_orbslam2_tpu_torch.core import sums
from ar_orbslam2_tpu_torch.estimation import ba_core as TBC
from ar_orbslam2_tpu_torch.eval.sum_routes import sorted_sum_each_call

PORT = pathlib.Path(__file__).resolve().parents[1] / "ar_orbslam2_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _segments(case, E, n, rng):
    """Indices for one case: repeated indices over every row, most rows
    empty, or one index that takes everything."""
    if case == "repeated":
        return rng.integers(0, n, E)
    if case == "empty_segments":
        return rng.choice(np.array([1, 4, n - 1]), E)
    return np.full(E, n // 2)


@pytest.mark.parametrize("shape", [(), (6, 6)])
@pytest.mark.parametrize("case", ["repeated", "empty_segments", "one_index"])
def test_index_sum_equals_index_add(case, shape):
    rng = np.random.default_rng(len(case) * 7 + len(shape))
    E, n = 5000, 17                      # 20 blocks of sums.RUN
    idx = torch.as_tensor(_segments(case, E, n, rng))
    vals = torch.as_tensor(rng.normal(0, 3, (E,) + shape).astype(np.float32))
    want = torch.zeros((n,) + shape).index_add_(0, idx, vals)
    # two orders of one float32 sum differ by a multiple of eps times the
    # sum of the terms' magnitudes (not of the sum, which may cancel)
    scale = torch.zeros((n,) + shape).index_add_(0, idx, vals.abs())
    planned = sums.IndexSum(idx, n)
    for route in (planned, planned.segmented,
                  lambda v: sorted_sum_each_call(idx, n, v)):
        got = route(vals)
        assert got.shape == want.shape and got.dtype == torch.float32
        assert bool(((got - want).abs() <= 1e-6 * scale).all()), route
        untouched = np.setdiff1d(np.arange(n), idx.numpy())
        assert not got[untouched].any()


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("case", ["repeated", "empty_segments", "one_index"])
def test_the_planned_route_adds_as_a_sorted_index_put(case, levels,
                                                      monkeypatch):
    """The CUDA route plans its sort once and reuses it: each call must
    add the same terms in the same order as a sort made for it, for values
    of any width through one plan (on the CPU at one thread, where
    index_put_ adds in input order; the card test repeats this there)."""
    if levels == 1:                      # too many rows for two blocks
        monkeypatch.setattr(sums, "MAX_PARTIALS", 17)
    rng = np.random.default_rng(len(case) + levels)
    E, n = 5000, 17
    idx = torch.as_tensor(_segments(case, E, n, rng))
    planned = sums.IndexSum(idx, n)
    for shape in ((36,), (6,), (36,)):
        vals = torch.as_tensor(rng.normal(0, 3, (E,) + shape).astype(
            np.float32))
        assert torch.equal(planned.segmented(vals),
                           sorted_sum_each_call(idx, n, vals)), shape


def test_index_sum_repeats_its_bits_on_several_threads():
    """On the CPU, index_put_(accumulate=True) adds floats with atomics
    once several threads share a large sum; IndexSum's CPU route walks
    the indices in order, so three runs at 4 threads give one result."""
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(0, 40, 200_000))
    vals = torch.as_tensor(rng.normal(0, 1, (200_000, 36)).astype(np.float32))
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = [sums.IndexSum(idx, 40)(vals) for _ in range(3)]
    finally:
        torch.set_num_threads(before)
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def _schur_problem(P=96, OPP=5, C=7, seed=11):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    oc = rng.integers(0, C, (P, OPP))
    oc[:, 1] = oc[:, 0]                  # a landmark seen twice by a camera
    w = rng.uniform(0, 1, (P, OPP)).astype(np.float32)
    w[:, -1] = 0.0                       # padded observations
    return f(P, OPP, 3), f(P, OPP, 3, 6), f(P, OPP, 3, 3), w, oc, C


def test_schur_blocks_matches_jax_and_a_float64_sum():
    import jax.numpy as jnp     # here, so the card runs this file without jax

    from ar_orbslam2_tpu.estimation import ba_core as JBC
    r, Jc, Jpt, w, oc, C = _schur_problem()
    lam = np.float32(1e-3)
    want = JBC.schur_blocks(jnp.asarray(r), jnp.asarray(Jc), jnp.asarray(Jpt),
                            jnp.asarray(w), jnp.asarray(oc), C, lam)
    got = TBC.schur_blocks(*(torch.as_tensor(a) for a in (r, Jc, Jpt, w)),
                           torch.as_tensor(oc), C, torch.tensor(lam))
    S = got["S"].numpy()
    S_j = np.asarray(want["S"])
    assert np.abs(S - S_j).max() <= 1e-2 * np.abs(S_j).max()
    for k in ("b_s", "Hpp_inv", "Wb", "b_p"):
        a, b = got[k].numpy(), np.asarray(want[k])
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0), k
    # the same S from float64 one-hot sums of the port's own pieces
    oh = np.eye(C)[oc]                                   # (P,OPP,C)
    JcW = Jc * w[..., None, None]
    Wb = np.einsum("pori,porj->poij", JcW, Jpt).astype(np.float64)
    Y = np.einsum("poij,pjk->poik", Wb, got["Hpp_inv"].numpy())
    U = np.einsum("poc,poik->pcik", oh, Y)
    V = np.einsum("poc,poik->pcik", oh, Wb)
    Hcc = np.einsum("poc,pori,porj->cij", oh, JcW.astype(np.float64), Jc)
    S64 = -np.einsum("pcik,pdjk->cdij", U, V)
    S64 += np.eye(C)[:, :, None, None] * Hcc[:, None]
    assert np.abs(S - S64).max() <= 1e-5 * np.abs(S64).max()


# ---------------------------------------------------------------------------
# static guard: no float indexed sum outside core/sums.py
# ---------------------------------------------------------------------------
SCATTERS = {"index_add", "index_add_", "scatter_add", "scatter_add_",
            "scatter_reduce", "scatter_reduce_"}

# (file, enclosing function): why the call's sum cannot depend on the order
ALLOWED = {
    ("system/fused.py", "_refresh_step"):
        "int32 visit/found counters carried to their landmark's new slot "
        "(two calls): integer addition is exact in any order",
    ("ops/hamming.py", "rotation_consistency"):
        "int32 orientation histogram: integer addition is exact in any "
        "order",
    ("loop/place_recognition.py", "_transform"):
        "bag-of-words counts: float32 sums of 0.0 and 1.0 over at most a "
        "frame's keypoints are exact integers (< 2**24) in any order",
    ("eval/sum_routes.py", "atomic_sum"):
        "a measurement tool's comparison route (the sums the port "
        "replaced), never on the system's path",
    ("eval/sum_routes.py", "sorted_sum_each_call"):
        "a measurement tool's comparison route (IndexSum's additions "
        "sorted at each call), never on the system's path",
}


PUTS = {"index_put_", "index_put", "put_", "put"}


def _accumulates(call):
    """Whether an index_put/put call may accumulate: its accumulate
    argument, by keyword or third positional argument of the method form
    (fourth of torch.f(x, ...)), is anything but a literal False."""
    pos = 3 if isinstance(call.func.value, ast.Name) \
        and call.func.value.id == "torch" else 2
    args = [k.value for k in call.keywords if k.arg == "accumulate"] \
        + call.args[pos:pos + 1]
    return any(not (isinstance(a, ast.Constant) and a.value is False)
               for a in args)


def _indexed_sums(source):
    """(enclosing function, line, call) of every indexed-sum call."""
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Call) \
                    and isinstance(child.func, ast.Attribute):
                name = child.func.attr
                if name in SCATTERS or (name in PUTS
                                        and _accumulates(child)):
                    found.append((fn, child.lineno, name))
            visit(child, fn)

    visit(ast.parse(source), None)
    return found


def test_the_guard_sees_an_indexed_sum():
    src = ("def f(x, i, v, acc):\n    x.index_add_(0, i, v)\n"
           "    torch.scatter_add(x, 0, i, v)\n"
           "    x.index_put_((i,), v, accumulate=True)\n"
           "    x.index_put_((i,), v, True)\n"
           "    x.put_(i, v, acc)\n"
           "    torch.index_put(x, (i,), v, True)\n"
           "    x.index_put_((i,), v)\n"
           "    x.index_put_((i,), v, False)\n"
           "    x.put_(i, v, accumulate=False)\n"
           "    torch.index_put(x, (i,), v)\n")
    assert [(line, c) for _, line, c in _indexed_sums(src)] == [
        (2, "index_add_"), (3, "scatter_add"), (4, "index_put_"),
        (5, "index_put_"), (6, "put_"), (7, "index_put")]


def test_no_float_indexed_sum_outside_index_sum():
    bad, used = [], set()
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel == "core/sums.py":
            continue
        for fn, line, call in _indexed_sums(path.read_text()):
            if (rel, fn) in ALLOWED:
                used.add((rel, fn))
            else:
                bad.append(f"{rel}:{line} {call} in {fn}")
    assert not bad, ("indexed sums outside core/sums.py (their order "
                     "changes from run to run on the card): " + ", ".join(bad))
    assert used == set(ALLOWED), set(ALLOWED) - used    # no stale entries


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs an NVIDIA GPU: compares bits of two runs "
                           "on the card")
def test_index_sum_and_local_ba_repeat_their_bits_on_the_card():
    from ar_orbslam2_tpu_torch.core.camera import Camera
    from ar_orbslam2_tpu_torch.estimation import local_ba
    rng = np.random.default_rng(5)
    idx = torch.as_tensor(rng.integers(0, 30, 100_000), device="cuda")
    vals = torch.as_tensor(rng.normal(0, 1, (100_000, 36)).astype(np.float32),
                           device="cuda")
    a, b = (sums.IndexSum(idx, 30)(vals) for _ in range(2))
    assert torch.equal(a, b)
    # the plan made once adds as a sort made for each call, at a local
    # BA's camera and pair sums (two levels, one level) and global BA's
    for n_idx, E, width in ((32, 32768, 48), (4096 * 32, 32768, 36),
                            (128, 786432, 48)):
        i = torch.as_tensor(rng.integers(0, n_idx, E), device="cuda")
        i[: E // 3] = 0                  # a padded camera's long run
        v = torch.as_tensor(rng.normal(0, 1, (E, width)).astype(np.float32),
                            device="cuda")
        planned = sums.IndexSum(i, n_idx)
        assert torch.equal(planned(v), sorted_sum_each_call(i, n_idx, v))
        assert torch.equal(planned(v), planned(v))
    want = torch.zeros(30, 36, dtype=torch.float64).index_add_(
        0, idx.cpu(), vals.cpu().double())
    assert float((a.cpu().double() - want).abs().max()) \
        <= 1e-5 * float(want.abs().max())

    cam = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640,
                 height=480)
    C, P, OPP = 8, 2048, 6
    ang = np.linspace(0, 0.4, C)
    R = np.stack([[[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                   [-np.sin(t), 0, np.cos(t)]] for t in ang]).astype(np.float32)
    t = np.stack([[-0.3 * k, 0.02 * k, 0.0] for k in range(C)]).astype(
        np.float32)
    X = np.column_stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                         rng.uniform(4, 7, P)]).astype(np.float32)
    oc = np.stack([rng.choice(C, OPP, replace=False) for _ in range(P)])
    xc = np.einsum("poij,pj->poi", R[oc], X) + t[oc]
    uv = np.stack([500 * xc[..., 0] / xc[..., 2] + 320,
                   500 * xc[..., 1] / xc[..., 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    X0 = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    T = lambda x: torch.as_tensor(x, device="cuda")
    args = (T(R), T(t), T(fixed), T(np.ones(C, bool)), T(X0),
            T(np.ones(P, bool)), T(oc.astype(np.int32)), T(uv),
            T(np.zeros((P, OPP), np.int32)), T(np.ones((P, OPP), bool)), cam)
    runs = [local_ba.bundle_adjust(*args) for _ in range(2)]
    for k in ("cam_R", "cam_t", "pts", "obs_inlier", "cost"):
        assert torch.equal(runs[0][k], runs[1][k]), k
    moved = (runs[0]["pts"].cpu().numpy() - X).std()
    assert moved < 0.5 * (X0 - X).std()       # and the BA did its work
