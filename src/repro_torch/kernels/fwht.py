"""The unnormalised Walsh-Hadamard transform along the last axis: the Hopper
kernel and its plain version (port of ``repro.kernels.fwht``).

``fwht(x)`` transforms each length-L row of a (..., L) float32 or bfloat16
tensor, L a power of two, accumulating in fp32 and returning x's type, as
``fwht_pallas`` does. On a CUDA tensor it launches ``csrc/fwht.cu`` (design
and bound in the source's header note) or raises; on a CPU tensor it runs
``fwht_plain``. ``fwht.launches`` counts kernel launches. The kernel keeps a
row in shared memory, so L is at most ``MAX_L``; there is no fallback above
it.

``wht_plan(L, elem_bytes)`` fixes the block shape of the register-radix WHT
body that ``csrc/fwht.cu`` and ``csrc/ovsf_decompress.cu`` share
(``csrc/wht.cuh``); both wrappers pass its fields to their kernel.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core import ovsf
from repro_torch.kernels import build

MAX_L = 1 << 15               # L fp32 of one row in a block's 227 KB
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

# the body, as in csrc/wht.cuh
SMEM_MAX = 227 * 1024         # dynamic shared memory a block may opt in to
BLOCK_THREADS = 128           # threads a block at least, where rows allow
# The exchange buffer's swizzle: flat element i sits at word i ^ (s << 2),
# s the XOR of SWIZZLE[b] over the set bits b of the line index i >> 5 (bits
# above 4 add nothing): every warp-wide access of the plans below is free of
# bank conflicts (tests/test_torch_wht_sm90.py checks each one).
SWIZZLE = (1, 2, 4, 3, 5)


@dataclasses.dataclass(frozen=True)
class WhtPlan:
    """The block shape of the WHT body for rows of length L = 2**n.

    A block transforms ``rows`` consecutive rows, viewed as one flat array of
    rows * L elements; ``threads`` threads each hold 2**``log2_regs`` of them
    in registers. Stage s holds, in register bit m, flat bit p + m, and runs
    the radix-2 passes of flat bits [lo, hi) (``stages[s] = (p, lo, hi)``);
    the thread's other flat bits are its own index, low bits first. Between
    two stages the rows go once through shared memory (an exchange); the
    first exchange stays within each warp (``__syncwarp``), the second, where
    a row spans warps, takes one block barrier (``block_wide``). ``staged``
    (fwht's fp32 rows that take an exchange, as ``csrc/fwht.cu`` decides at
    compile time): the rows reach shared memory by 16-byte ``cp.async``
    before stage 1; else each thread loads its stage-1 elements into
    registers. ``swizzle``: ``SWIZZLE``, as ``csrc/wht.cuh`` has it.
    """
    L: int
    log2_regs: int
    stages: tuple
    block_wide: tuple
    rows: int
    threads: int
    smem_bytes: int
    staged: bool

    @property
    def swizzle(self) -> tuple:
        return SWIZZLE

    @property
    def regs(self) -> int:
        return 1 << self.log2_regs

    @property
    def exchanges(self) -> int:
        return len(self.stages) - 1


@functools.lru_cache(maxsize=None)
def wht_plan(L: int, elem_bytes: int, tile: int = 0) -> WhtPlan:
    """The plan for rows of length L (a power of two up to ``MAX_L``) in
    elements of ``elem_bytes`` (4: fp32, 2: bf16). A block takes at least
    ``BLOCK_THREADS`` threads where one row is shorter, and at least
    ``tile`` rows: the decompress's column tile (one row a column), which
    also keeps a shared-memory row buffer; 0 for fwht.

    A thread holds 32 elements (64 at L = 64, whose two 32-element stages
    could not exchange free of bank conflicts): stages of 5 bits, so one
    warp-local exchange up to L = 1024 and two from L = 2048 to 32768.
    """
    if L < 1 or L & (L - 1) or L > MAX_L:
        raise ValueError(f"wht_plan: L={L} must be a power of two in "
                         f"1..{MAX_L}")
    n = L.bit_length() - 1
    b = 6 if n == 6 else 5
    regs = 1 << b
    if n <= b:
        stages = ((0, 0, n),)
    else:
        stages = [(0, 0, b), (min(b, n - b), b, min(n, 2 * b))]
        if n > 2 * b:
            stages.append((n - b, 2 * b, n))
        stages = tuple(stages)
    max_threads = 1024 if b == 5 else 256     # the kernels' launch bounds
    warp_rows = max(1, 32 * regs // L)        # a warp is 32 * regs elements
    rows = max(tile, BLOCK_THREADS * regs // L, warp_rows)
    rows = min(rows, max(warp_rows, max_threads * regs // L),
               max(1, SMEM_MAX // (4 * L)))
    buffered = tile > 0 or len(stages) > 1
    return WhtPlan(L=L, log2_regs=b, stages=stages,
                   block_wide=tuple(s > 0 for s in range(len(stages) - 1)),
                   rows=rows, threads=rows * L // regs,
                   smem_bytes=4 * rows * L if buffered else 0,
                   staged=elem_bytes == 4 and tile == 0 and len(stages) > 1)


def plan_args(plan: WhtPlan) -> tuple:
    """The plan as the kernels take it: (log2 regs, rows, threads, shared
    bytes, p of stage 2, p of stage 3; -1 where absent)."""
    ps = [p for p, _lo, _hi in plan.stages[1:]] + [-1, -1]
    return (plan.log2_regs, plan.rows, plan.threads, plan.smem_bytes,
            ps[0], ps[1])


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
    if x.data_ptr() % 16:                       # 16-byte loads
        x = x.clone()
    y = torch.empty_like(x)
    M = x.numel() // L
    if M == 0:
        return y
    if M >= 2**31:
        raise ValueError(f"fwht: {M} rows, the kernel takes fewer than 2**31")
    plan = wht_plan(L, x.element_size())
    err = build.launcher("fwht", _ARGTYPES)(
        x.data_ptr(), y.data_ptr(), M, L, int(x.dtype == torch.bfloat16),
        *plan_args(plan), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fwht: CUDA launch failed (cudaError {err})")
    fwht.launches += 1
    return y


fwht.launches = 0
