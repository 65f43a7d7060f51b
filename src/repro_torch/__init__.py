"""PyTorch/CUDA port of ``repro``: the OVSF serving stack on an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``core.ovsf``, ``kernels``, ``models``, ``serving``,
``launch``) so each module's counterpart is easy to find. It imports
``torch`` and never ``jax`` or anything of ``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU present they raise instead of falling back (``resolve_device``).
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default) raises when
    no GPU is present: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (--device "
                "cpu) to run the port's plain CPU path")
        if dev.index is None:   # compare equal to the devices tensors report
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
