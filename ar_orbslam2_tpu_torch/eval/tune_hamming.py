"""Time the Hamming search kernel built with other tunables.

Run on a machine with an NVIDIA GPU and nvcc, from the repository root:

    python -m ar_orbslam2_tpu_torch.eval.tune_hamming

Builds csrc/cuda_hamming.cu once per variant (``-DWARPS=..
-DSCAN_UNROLL=..``, the source's defaults first) into the package's
git-ignored build directory, checks each against the plain version at 1024,
2048 and 4096 queries x 1024 keypoints, and prints the device time of one
search call (chip_smoke's ``device_ms``: calls queued behind a sleep kernel,
CUDA events) with and without the mutual-best pass, and of one launch of a
batch of 5 searches. Every variant is timed twice, in turns, within the one
process, so the rows compare on one card.
"""
from __future__ import annotations

import os
import subprocess
import sys

import torch

from ..ops import cuda_hamming as CH

VARIANTS = {"default": [], "w8u2": ["-DWARPS=8", "-DSCAN_UNROLL=2"],
            "w8u4": ["-DWARPS=8", "-DSCAN_UNROLL=4"],
            "w16u2": ["-DWARPS=16", "-DSCAN_UNROLL=2"],
            "w16u8": ["-DWARPS=16", "-DSCAN_UNROLL=8"],
            "w32u4": ["-DWARPS=32", "-DSCAN_UNROLL=4"]}


def _build(tag, flags):
    os.makedirs(CH._BUILD_DIR, exist_ok=True)
    so = os.path.join(CH._BUILD_DIR, f"libcuda_hamming_tune_{tag}.so")
    cmd = [CH._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
           CH._SRC] + flags
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{res.stderr}")
    return so


def _use(so):
    """Bind the wrapper to another build of the kernel."""
    CH._LIB = None
    build, CH.build_kernel = CH.build_kernel, lambda: so
    try:
        CH._library()
    finally:
        CH.build_kernel = build


def main():
    if not torch.cuda.is_available():
        raise SystemExit("tune_hamming needs a GPU")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as S                  # its inputs and its timer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    inputs = {}
    for n in (1024, 2048, 4096):
        pk = list(S.make_inputs(torch, n, 1024, False, seed=7).values())
        pk[0] = CH.H.packed_from_signs(pk[0])
        pk[6] = CH.H.packed_from_signs(pk[6])
        inputs[n] = pk
    batch = S.batched_inputs(torch, CH, 4096, 1024, S.BATCH, seed=90)
    libs = {tag: _build(tag, flags) for tag, flags in VARIANTS.items()}
    for turn in (1, 2):
        for tag, so in libs.items():
            _use(so)
            cells = []
            for n, pk in inputs.items():
                want = CH.fused_windowed_top2_reference(*pk)
                got = CH.fused_windowed_top2(*pk)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise SystemExit(f"{tag}: differs from plain at n={n}")
                on = S.device_ms(torch, lambda: CH.fused_windowed_top2(*pk))
                off = S.device_ms(torch, lambda: CH.fused_windowed_top2(
                    *pk, mutual=False))
                cells.append(f"n={n} mutual_us={on * 1e3:.2f} "
                             f"not_mutual_us={off * 1e3:.2f}")
            b = S.device_ms(torch, lambda: CH.fused_windowed_top2(
                *batch, th=50))
            print(f"[tune] turn={turn} variant={tag} " + " ".join(cells)
                  + f" batch{S.BATCH}_us={b * 1e3:.2f}", flush=True)
    CH._LIB = None


if __name__ == "__main__":
    main()
