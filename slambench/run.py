"""Run one benchmark cell on the card and print its result line.

    python -m slambench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a run with host spans
and a torch.profiler session over a sub-window after the timed one. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit);
the last lines of standard error are the same numbers. Exits 2 without a
card (or fewer cards than the cell asks for), 3 if JAX or the JAX package
was loaded, 1 on any other failure, without a result line in each case.
"""
import os
import time

T_START = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE = os.path.join(_ROOT, ".bench_cache")
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
# PyTorch's NVRTC-compiled elementwise kernels (otherwise under ~/.cache)
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = os.path.join(_CACHE, "torch_kernels")
os.makedirs(os.environ["PYTORCH_KERNEL_CACHE_PATH"], exist_ok=True)

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from . import bench
    from .catalog import Catalog

    cat = Catalog()
    chips = int(cat.workload(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"slambench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    with bench.stdout_to_stderr():
        cell = bench.load_cell(args.workload, cat)
        out = bench.Run(cell, args.seed, args.seconds, bool(args.trace),
                        t_start=T_START).execute()
        line = bench.result_line(args.workload, out, bool(args.trace), cat)
    found = bench.forbidden_modules()
    if found:
        print(f"slambench: loaded {', '.join(found)}, which the benchmark "
              "must not load", file=sys.stderr)
        return 3
    err = sys.stderr
    print(f"[run] {args.workload} seed={args.seed} init_frames="
          f"{out['init_frames']} window_frames={out['window_frames']} "
          f"window_s={out['window_s']:.3f} captures_after_warmup="
          f"{out['captures_after_warmup']} readings="
          f"{json.dumps(out['readings'])}", file=err)
    if out["roofline"] is not None:
        least, spent, bounds = out["roofline"]
        print(f"[run] hamming least_s={least!r} kernel_s={spent!r} "
              f"bound_by={bounds}", file=err)
    for name, value, limit, passed in out["lines"]:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if passed else 'FAILED'}", file=err)
    sys.stdout.write(json.dumps(line) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        import traceback
        traceback.print_exc()
        code = 1
    sys.exit(code)
