"""Device resolution for the port.

The counterpart of `mxnet_tpu/context.py`, cut to what the port needs: the
port's entry points run on the CUDA card unless the caller asks for the CPU,
and they refuse to run without a card rather than carry on quietly on the
CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """Return the device an entry point runs on: ``cuda`` when ``device`` is
    None, else ``device`` itself. Raises RuntimeError when that device is a
    CUDA device and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
