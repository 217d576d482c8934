"""Binary-descriptor Hamming distance and match bookkeeping in torch.

Port of ar_orbslam2_tpu/ops/hamming.py. Canonical representations are
the same as the JAX package's:

  * bits:  (N, 256) uint8 in {0, 1}   — host/interop format
  * signs: (N, 256) int8  in {-1, +1} — dense-matmul format
  * packed:(N, 32)  uint8, LSB-first  — storage (the reference's 32-byte
                                        cv::Mat rows) and the CUDA kernel's
                                        input (read as 8 u32 words)

hamming(a, b) = (256 - <±1(a), ±1(b)>) / 2. The dense form runs as a
float32 matmul: every partial sum is an integer of magnitude <= 256, so it
is exact in f32 (TF32 is off package-wide) on the CPU and on the card,
where integer matmuls are not available.

Tie rules. The JAX package takes top-2 with ``lax.top_k``, which returns
the LOWEST index first among equal values; ``torch.topk`` promises no
order for ties on CUDA. Top-2 is therefore built from ``argmin`` (first
index, documented) + a masked ``min``, and the rotation histogram's top-3
from a stable sort.
"""
from __future__ import annotations

import numpy as np
import torch

DESC_BITS = 256
DESC_BYTES = 32
# matching thresholds, parity with ORBmatcher (src/ORBmatcher.cc TH_LOW/TH_HIGH)
TH_LOW = 50
TH_HIGH = 100


def pack_bits(bits):
    """(N, 256) {0,1} -> (N, 32) uint8 (LSB-first within each byte). Host."""
    bits = np.asarray(bits, np.uint8).reshape(-1, DESC_BYTES, 8)
    return np.packbits(bits, axis=-1, bitorder="little").reshape(-1, DESC_BYTES)


def unpack_bits(packed):
    """(N, 32) uint8 -> (N, 256) {0,1} uint8. Host."""
    packed = np.asarray(packed, np.uint8)
    return np.unpackbits(packed, axis=-1, bitorder="little")


def _bit_weights(device):
    # built on the device: a host-made tensor would cost a stream sync
    return 1 << torch.arange(8, dtype=torch.int32, device=device)


def pack_bits_device(bits):
    """Device-side pack: (..., 256) {0,1} -> (..., 32) uint8, LSB-first —
    same byte layout as pack_bits/unpack_bits."""
    b = bits.to(torch.int32).reshape(bits.shape[:-1] + (DESC_BYTES, 8))
    return (b * _bit_weights(bits.device)).sum(-1).to(torch.uint8)


def unpack_bits_device(packed):
    """Device-side unpack: (..., 32) uint8 -> (..., 256) {0,1} uint8,
    LSB-first (same layout as unpack_bits)."""
    w = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> w) & 1
    return bits.reshape(packed.shape[:-1] + (DESC_BITS,))


def to_signs(bits, device=None):
    """{0,1} bits (numpy or tensor) -> ±1 int8 tensor (dense format)."""
    b = torch.as_tensor(np.asarray(bits) if not torch.is_tensor(bits)
                        else bits, device=device)
    return (b.to(torch.int8) * 2 - 1).to(torch.int8)


def signs_from_packed(packed):
    """Packed (..., 32) uint8 descriptors -> ±1 int8 signs, on device."""
    return unpack_bits_device(packed).to(torch.int8) * 2 - 1


def packed_from_signs(signs):
    """±1 int8 signs (..., 256) -> packed (..., 32) uint8, on device."""
    return pack_bits_device(signs > 0)


def hamming_matrix(signs_a, signs_b, valid_a=None, valid_b=None,
                   invalid_dist=DESC_BITS + 1):
    """All-pairs Hamming distances (exact f32 matmul of the ±1 signs).

    Args:
      signs_a: (N, 256) int8 ±1. signs_b: (M, 256) int8 ±1.
      valid_a/valid_b: optional bool masks; invalid rows/cols get
        `invalid_dist` so downstream argmin/threshold logic ignores them.
    Returns:
      (N, M) int32 Hamming distances in [0, 256].
    """
    dot = signs_a.to(torch.float32) @ signs_b.to(torch.float32).T
    d = (DESC_BITS - dot.to(torch.int32)) >> 1
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, invalid_dist)
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, invalid_dist)
    return d


def top2_min(dist):
    """Per-row (d0, idx0, d1): the row minimum, the FIRST column attaining
    it, and the minimum over every other column — ``lax.top_k(-d, 2)``'s
    values and first index, tie order included."""
    idx0 = torch.argmin(dist, dim=1)
    d0 = torch.gather(dist, 1, idx0[:, None])[:, 0]
    big = torch.iinfo(dist.dtype).max
    masked = dist.scatter(1, idx0[:, None], big)
    d1 = masked.min(dim=1).values
    return d0, idx0.to(torch.int32), d1


def best_match(dist, th=TH_LOW, nn_ratio=1.0):
    """Per-row best column under threshold + Lowe ratio test.

    Parity with ORBmatcher's best/secondbest bookkeeping (mfNNratio).
    Returns (idx (N,) int32 with -1 for no match, best_dist (N,) int32).
    """
    d0, idx0, d1 = top2_min(dist)
    ok = (d0 <= th) & (d0.to(torch.float32)
                       <= nn_ratio * d1.to(torch.float32))
    return torch.where(ok, idx0, torch.full_like(idx0, -1)), d0


def mutual_filter(idx_ab, idx_ba):
    """Keep only mutual nearest-neighbour matches.

    idx_ab: (N,) best b for each a; idx_ba: (M,) best a for each b.
    """
    n = idx_ab.shape[0]
    back = torch.where(idx_ab >= 0,
                       idx_ba[torch.clamp(idx_ab, min=0).long()],
                       torch.full_like(idx_ab, -2))
    mutual = back == torch.arange(n, device=idx_ab.device)
    return torch.where(mutual, idx_ab, torch.full_like(idx_ab, -1))


def rotation_consistency(angles_a, angles_b, match_idx, n_bins=30, top_k=3):
    """Orientation-histogram filter, parity with ORBmatcher's 30-bin
    rotHist keeping the top-3 bins (ComputeThreeMaxima).

    Args:
      angles_a: (N,) degrees; angles_b: (M,) degrees;
      match_idx: (N,) index into b or -1.
    Returns: (N,) int32 match_idx with inconsistent matches set to -1.
    """
    matched = match_idx >= 0
    rot = angles_a - angles_b[torch.clamp(match_idx, min=0).long()]
    rot = torch.where(rot < 0, rot + 360.0, rot)
    factor = n_bins / 360.0
    bin_idx = torch.remainder(torch.round(rot * factor).to(torch.int32),
                              n_bins)
    hist = torch.zeros(n_bins, dtype=torch.int32, device=rot.device)
    hist = hist.index_add(0, bin_idx.long(), matched.to(torch.int32))
    # top-3 bins, lowest bin first among equal counts (lax.top_k order)
    top_vals, top_bins = torch.sort(hist, descending=True, stable=True)
    top_vals, top_bins = top_vals[:top_k], top_bins[:top_k]
    cut = torch.clamp((0.1 * top_vals[0].to(torch.float32)).to(torch.int32),
                      min=1)
    keep_bin = top_vals >= cut
    in_top = ((bin_idx[:, None] == top_bins[None, :])
              & keep_bin[None, :]).any(dim=1)
    return torch.where(matched & in_top, match_idx,
                       torch.full_like(match_idx, -1))
