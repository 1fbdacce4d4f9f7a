"""Which device the port runs on.

The rule: a caller that names no device gets the CUDA card, and a
machine without one is an error, never a quiet switch to the CPU. Only
an explicit `device="cpu"` runs the plain PyTorch versions of the
kernels (the CPU tests do that).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .log import LightGBMError


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means "cuda"; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "CUDA is not available, and lightgbm_tpu_torch runs on "
                "the CUDA card unless told otherwise; pass device='cpu' "
                "to run the plain (CPU) versions of its kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise LightGBMError("device must be 'cuda' or 'cpu' (got %r)"
                        % (device,))
