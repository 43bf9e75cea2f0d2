"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: with no
GPU and no explicit ``device="cpu"`` they raise instead of quietly
carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device with no GPU present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev
