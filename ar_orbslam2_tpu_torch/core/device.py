"""The port's device rule."""
from __future__ import annotations

import torch


def resolve_device(device):
    """``None`` means the card, and there is no quiet move to the CPU:
    entry points raise when no GPU is present, and callers that want the
    CPU say so (``device="cpu"``, as the CPU tests do)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: ar_orbslam2_tpu_torch runs on the GPU "
                "unless asked otherwise; pass device='cpu' to run on the "
                "CPU")
        device = "cuda"
    return torch.device(device)
