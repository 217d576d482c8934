"""ar_orbslam2_tpu_torch — the PyTorch/CUDA port of ar_orbslam2_tpu.

Same subpackage layout as the JAX package, same function names and
signatures where the idiom allows; plain functions on tensors, with the
device carried explicitly (entry points run on the GPU unless the caller
passes ``device="cpu"``) and every random draw taken from an explicit
``torch.Generator``. The one hand kernel (the windowed Hamming top-2
search) lives in ``csrc/cuda_hamming.cu`` and
is bound by ``ops/cuda_hamming.py``.

This package never imports jax or the JAX package.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry is precision-critical (triangulation turns reduced-precision
# matmul error into landmark error): no TF32 anywhere, mirroring the JAX
# package's global "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
