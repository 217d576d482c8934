"""Essential-graph optimization — Gauss-Newton over Sim(3) vertices.

Port of ar_orbslam2_tpu/estimation/pose_graph.py (the redesign of
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc): per-edge residuals
r_e = log(S_ji_meas · S_i · S_j^{-1}) with forward-mode Jacobians (7-dof
tangent blocks), batched over the edges. Two linear-solver paths, as in
the JAX package:

  * K <= CG_THRESHOLD vertices: dense (7K, 7K) assembly + direct solve;
  * larger graphs (the default MapConfig.max_keyframes = 1024): matrix-free
    block-Jacobi-preconditioned conjugate gradient over the edge blocks.

The JAX package gathers and sums edge blocks into vertices with one-hot
matmuls (a TPU choice: scatters serialize there); here the sums are
``core.sums.IndexSum``, planned once per graph, so they agree with the
reference to float32 rounding, not bit for bit, and like the matmuls they
add in an order fixed by the inputs: one graph gives the same bits on
every run. Plain torch (the JAX package has no hand kernel here);
float32, no TF32, no host read.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd

from ..core import lie
from ..core.sums import IndexSum

# above this vertex count the dense (7K, 7K) system is replaced by
# block-Jacobi-preconditioned CG (memory O(E) instead of O(K^2))
CG_THRESHOLD = 128
CG_ITERS = 80


def _scatter_rows(rows, blocks_i, blocks_j):
    """sum of blocks_i[e] into row ei[e] and of blocks_j[e] into row ej[e]:
    two (E, ...) -> (K, ...), one sum; rows = IndexSum(cat([ei, ej]), K)."""
    return rows(torch.cat([blocks_i, blocks_j]))


def _solve_pcg(Hii, Hjj, Hij, ei, ej, b, free, damping, rows):
    """Matrix-free PCG on the edge-block normal system. Solves H x = b over
    free vertices (fixed rows behave as identity). Returns x (K, 7) such
    that the GN update is -x."""
    K = b.shape[0]
    free_f = free.to(torch.float32)[:, None]
    eye7 = torch.eye(7, dtype=torch.float32, device=b.device)

    def Hv(v):
        vi = v[ei]
        vj = v[ej]
        out_i = (torch.einsum("eij,ej->ei", Hii, vi)
                 + torch.einsum("eij,ej->ei", Hij, vj))
        out_j = (torch.einsum("eij,ej->ei", Hjj, vj)
                 + torch.einsum("eji,ej->ei", Hij, vi))
        out = _scatter_rows(rows, out_i, out_j)
        # damping everywhere; fixed rows act as identity
        return torch.where(free[:, None], out + damping * v, v)

    # block-Jacobi preconditioner from per-vertex diagonal blocks
    D = _scatter_rows(rows, Hii, Hjj)
    D = D + (damping + 1e-8) * eye7
    D = torch.where(free[:, None, None], D, eye7)
    D_inv = torch.linalg.inv_ex(D).inverse      # _ex: no host sync

    def precond(v):
        return torch.einsum("kij,kj->ki", D_inv, v) * free_f

    b = b * free_f
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    for _ in range(CG_ITERS):
        Hp = Hv(p)
        rz = (r * z).sum()
        alpha = rz / torch.clamp((p * Hp).sum(), min=1e-12)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        beta = (r * z).sum() / torch.clamp(rz, min=1e-12)
        p = z + beta * p
    return x    # x ≈ H^-1 b; the caller applies dv = -x


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rm, tm, sm, vi, vj):
    """r = log(S_m · exp(vi) S_i · (exp(vj) S_j)^-1), (E, 7)."""
    Si = lie.sim3_mul(*lie.sim3_exp(vi), Ri, ti, si)
    Sj = lie.sim3_mul(*lie.sim3_exp(vj), Rj, tj, sj)
    Sij = lie.sim3_mul(*Si, *lie.sim3_inv(*Sj))
    return lie.sim3_log(*lie.sim3_mul(Rm, tm, sm, *Sij))


@torch.no_grad()
def _dense_solve(Hii, Hjj, Hij, b, free, damping, blocks):
    """blocks: IndexSum of the edges' (ii, jj, ij, ji) blocks into the
    (K*K) block grid."""
    K = b.shape[0]
    Hb = blocks(torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)])
                ).reshape(K, K, 7, 7)
    Hd = Hb.permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
    bd = b.reshape(7 * K)
    # pin fixed/invalid vertices with identity rows
    pin = (~free).repeat_interleave(7)
    keep = (~pin).to(torch.float32)
    Hd = Hd * keep[:, None] * keep[None, :]
    Hd = Hd + torch.diag(pin.to(torch.float32)) \
        + damping * torch.eye(7 * K, dtype=torch.float32, device=b.device)
    bd = torch.where(pin, torch.zeros_like(bd), bd)
    return torch.linalg.solve_ex(Hd, bd).result.reshape(K, 7)   # no sync


def optimize_essential_graph(R, t, s, vert_valid, fixed,
                             edge_i, edge_j, edge_R, edge_t, edge_s,
                             edge_valid, edge_weight=None,
                             n_iters=20, fix_scale=False, damping=1e-6):
    """Optimize Sim3 keyframe poses against relative-pose constraints.

    Args:
      R (K,3,3), t (K,3), s (K,): vertex Sim3 S_iw (world->kf).
      vert_valid (K,) bool: padding mask. fixed (K,) bool: held constant
        (parity: the loop keyframe is fixed).
      edge_i/edge_j (E,) int: endpoint vertex ids.
      edge_R/t/s: (E,...) measured S_ji (S_j · S_i^-1 at measurement time).
      edge_valid (E,) bool; edge_weight (E,) optional.
      fix_scale: True for stereo/RGB-D.
    Returns dict(R, t, s, cost) of tensors.
    """
    K = R.shape[0]
    E = edge_i.shape[0]
    dev = R.device
    if edge_weight is None:
        edge_weight = torch.ones(E, dtype=torch.float32, device=dev)
    w_e = torch.where(edge_valid, edge_weight, torch.zeros_like(edge_weight))
    sw = torch.sqrt(w_e)
    ei = torch.clamp(edge_i.long(), min=0)
    ej = torch.clamp(edge_j.long(), min=0)
    free = vert_valid & ~fixed
    free_f = free.to(torch.float32)
    z = torch.zeros(7, dtype=torch.float32, device=dev)
    # tangent perturbations are shared by every edge: the residual of edge
    # e depends on its own endpoints only, so d r_e / d v is edge e's block
    zE = torch.zeros((E, 7), dtype=torch.float32, device=dev)
    # the graph's sums, planned once: into the vertices, and (dense path)
    # into the (K, K) block grid
    rows = IndexSum(torch.cat([ei, ej]), K)
    if K <= CG_THRESHOLD:
        grid = IndexSum(torch.cat([ei, ej, ei, ej]) * K
                        + torch.cat([ei, ej, ej, ei]), K * K)

    cost = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(n_iters):
        Ri, ti, si = R[ei], t[ei], s[ei]
        Rj, tj, sj = R[ej], t[ej], s[ej]

        def res(vi, vj):
            return _edge_residual(Ri, ti, si, Rj, tj, sj,
                                  edge_R, edge_t, edge_s, vi, vj)

        Ji = jacfwd(lambda v: res(v.expand(E, 7), zE))(z)      # (E,7,7)
        Jj = jacfwd(lambda v: res(zE, v.expand(E, 7)))(z)
        with torch.no_grad():
            r = res(zE, zE)
            # zero jacobians of fixed/invalid vertices
            Ji = Ji * free_f[ei][:, None, None]
            Jj = Jj * free_f[ej][:, None, None]
            if fix_scale:
                Ji[:, :, 6] = 0.0
                Jj[:, :, 6] = 0.0
            Ji = Ji * sw[:, None, None]
            Jj = Jj * sw[:, None, None]
            rw = r * sw[:, None]

            Hii = torch.einsum("eri,erj->eij", Ji, Ji)
            Hjj = torch.einsum("eri,erj->eij", Jj, Jj)
            Hij = torch.einsum("eri,erj->eij", Ji, Jj)
            bi = torch.einsum("eri,er->ei", Ji, rw)
            bj = torch.einsum("eri,er->ei", Jj, rw)
            b = _scatter_rows(rows, bi, bj)
            b = torch.where(free[:, None], b, torch.zeros_like(b))

            if K <= CG_THRESHOLD:
                dv = -_dense_solve(Hii, Hjj, Hij, b, free, damping, grid)
            else:
                dv = -_solve_pcg(Hii, Hjj, Hij, ei, ej, b, free, damping,
                                 rows)
            if fix_scale:
                dv[:, 6] = 0.0
            dv = torch.where(free[:, None], dv, torch.zeros_like(dv))
            R, t, s = lie.sim3_mul(*lie.sim3_exp(dv), R, t, s)
            cost = (rw * rw).sum()
    return dict(R=R, t=t, s=s, cost=cost)
