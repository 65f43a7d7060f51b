"""The unnormalised Walsh-Hadamard transform along the last axis: the Hopper
kernel and its plain version (port of ``repro.kernels.fwht``).

``fwht(x)`` transforms each length-L row of a (..., L) float32 or bfloat16
tensor, L a power of two, accumulating in fp32 and returning x's type, as
``fwht_pallas`` does. On a CUDA tensor it launches ``csrc/fwht.cu`` (design
and bound in the source's header note) or raises; on a CPU tensor it runs
``fwht_plain``. ``fwht.launches`` counts kernel launches. The kernel keeps a
row in shared memory, so L is at most ``MAX_L``; there is no fallback above
it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ovsf
from repro_torch.kernels import build

MAX_L = 1 << 15               # L fp32 of one row in a block's 227 KB
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _check(x: torch.Tensor) -> int:
    """The row length L of ``x``, after the checks every device shares."""
    if x.dim() == 0:
        raise ValueError("fwht: x must have a last axis to transform")
    L = x.shape[-1]
    if L < 1 or L & (L - 1):
        raise ValueError(f"FWHT length must be a power of two, got {L}")
    if L > MAX_L:
        raise ValueError(f"fwht: L={L} above the kernel's limit {MAX_L} "
                         "(one row in a block's shared memory)")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fwht: x {x.dtype} must be float32 or bfloat16")
    return L


def fwht_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: upcast to fp32, the radix-2 butterflies of
    ``core.ovsf.fwht`` (the kernel's passes in the kernel's order), cast
    back to x's type."""
    return ovsf.fwht(x.float(), dim=-1).to(x.dtype)


def fwht(x: torch.Tensor) -> torch.Tensor:
    """WHT along the last axis of (..., L) x (== x @ H_L), L a power of two
    up to ``MAX_L``; fp32 arithmetic, output in x's type."""
    L = _check(x)
    if x.device.type == "cpu":
        return fwht_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"fwht: unsupported device {x.device}")
    x = x.contiguous()
    y = torch.empty_like(x)
    M = x.numel() // L
    if M == 0:
        return y
    if M >= 2**31:
        raise ValueError(f"fwht: {M} rows, the kernel takes fewer than 2**31")
    err = build.launcher("fwht", _ARGTYPES)(
        x.data_ptr(), y.data_ptr(), M, L, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fwht: CUDA launch failed (cudaError {err})")
    fwht.launches += 1
    return y


fwht.launches = 0
