"""Binary k-medians codebook training for place recognition.

Port of ar_orbslam2_tpu/loop/vocab_train.py. place_recognition.py replaces
DBoW2's vocabulary tree with a flat codebook evaluated as ONE Hamming
matmul; this module trains that codebook from the map's own descriptors
with binary k-medians (Hamming assignment + per-bit majority vote), the
binary-descriptor analog of the k-means DBoW2 runs per tree level.

The assignment runs on the device as fixed-size chunks of a float32
Hamming matmul + argmin (the first index among equals, as ``jnp.argmin``);
the majority vote stays numpy, sort + ``np.add.reduceat`` (``np.add.at``
is an unbuffered scalar loop that holds the GIL for seconds at this size,
and this runs on the mapping worker beside the tracking thread).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops import hamming as H


def assign_words(desc_signs, word_signs, chunk=8192):
    """Nearest word per descriptor (Hamming argmin), chunked matmuls.

    desc_signs: (N, 256) ±1 int8, numpy or a tensor; word_signs: (W, 256)
    ±1 int8 tensor on the device that runs the matmuls. Chunks are padded
    to one size, so every call has the same shapes. Returns (N,) int64
    numpy word ids."""
    words = word_signs.to(torch.float32)
    dev = words.device
    desc = torch.as_tensor(np.asarray(desc_signs) if not torch.is_tensor(
        desc_signs) else desc_signs)
    n = desc.shape[0]
    out = []
    for lo in range(0, n, chunk):
        block = torch.zeros((chunk, H.DESC_BITS), dtype=torch.float32,
                            device=dev)
        part = desc[lo:lo + chunk]
        block[:len(part)] = part.to(dev, torch.float32)
        dist = (H.DESC_BITS - (block @ words.T).to(torch.int32)) >> 1
        out.append(torch.argmin(dist, dim=1)[:len(part)])
    if not out:
        return np.zeros(0, np.int64)
    return torch.cat(out).cpu().numpy()


def train_codebook(desc_bits, n_words=4096, n_iters=6, seed=0, device=None):
    """Binary k-medians over {0,1}^256 descriptors.

    Args:
      desc_bits: (N, 256) uint8 training descriptors.
      device: where the assignment matmuls run (None: the card; no GPU
        raises, as core.device says).
    Returns:
      (n_words, 256) uint8 codebook bits.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    desc_bits = np.asarray(desc_bits, np.uint8)
    n = len(desc_bits)
    if n < n_words:                     # degenerate: pad with random words
        pad = (rng.random((n_words - n, H.DESC_BITS)) < 0.5).astype(np.uint8)
        desc_bits = np.concatenate([desc_bits, pad])
        n = len(desc_bits)
    # k-means++-lite init: random distinct training descriptors
    words = desc_bits[rng.choice(n, n_words, replace=False)].copy()
    signs = torch.as_tensor(desc_bits.astype(np.int8) * 2 - 1, device=device)
    for _ in range(n_iters):
        a = assign_words(signs, H.to_signs(words, device=device))
        # per-word majority bit vote (the binary median), sort-based
        order = np.argsort(a, kind="stable")
        a_sorted = a[order]
        starts = np.nonzero(np.r_[True, a_sorted[1:] != a_sorted[:-1]])[0]
        seg_sums = np.add.reduceat(desc_bits[order].astype(np.int32),
                                   starts, axis=0)
        sums = np.zeros((n_words, H.DESC_BITS), np.int32)
        sums[a_sorted[starts]] = seg_sums
        counts = np.bincount(a, minlength=n_words)
        nz = counts > 0
        maj = np.zeros_like(words)
        maj[nz] = (2 * sums[nz] >= counts[nz, None]).astype(np.uint8)
        # empty words: re-seed from random descriptors
        n_empty = int((~nz).sum())
        if n_empty:
            maj[~nz] = desc_bits[rng.choice(n, n_empty, replace=False)]
        if np.array_equal(maj, words):
            break
        words = maj
    return words
