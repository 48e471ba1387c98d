"""The explicit device rule of the port.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  There is
no fallback: if CUDA is absent and the caller did not ask for the CPU,
:func:`resolve_device` raises.  On the CPU every kernel wrapper runs its
plain PyTorch version, which is how the tests run.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available (``None`` means the default, ``"cuda"``)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions of the "
            "kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
