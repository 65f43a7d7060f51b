"""Fused on-the-fly OVSF GEMM: the Hopper kernel and its plain version.

``ovsf_gemm(x, alphas, idx)`` computes y = x @ W with
W[k, n] = sum_j (-1)^popcount(idx[j] & k') * alphas[j, n] (see
``kernels.ref.ovsf_matmul_ref``). On a CUDA tensor it launches
``csrc/ovsf_gemm.cu`` (the port of the Pallas ``repro.kernels.ovsf_gemm:
ovsf_gemm``; design and bound in the source's header note) or raises; on a
CPU tensor it runs the plain version. ``ovsf_gemm.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ovsf_matmul_ref

# The plain PyTorch version of this kernel (CPU path and on-card reference).
ovsf_gemm_plain = ovsf_matmul_ref

_BK = 64                      # k rows per k-block, as in the CUDA source
_BN = 64                      # output columns per block
_BLOCKS_PER_SM = 2            # split-K target occupancy
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _lib():
    lib = build.load("ovsf_gemm")
    fn = lib.ovsf_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def tiling(M: int, K: int, N: int, n_sms: int) -> tuple[int, int, int]:
    """(rows per block, k-blocks per split, splits): row tiles of 4/16/64,
    and the K range split until about two blocks per SM are in flight —
    decode (M = 4) has only N/64 column tiles to spread over the SMs."""
    bm = 4 if M <= 4 else 16 if M <= 16 else 64
    tiles = -(-M // bm) * -(-N // _BN)
    nkb = -(-K // _BK)
    want = max(1, min(nkb, -(-_BLOCKS_PER_SM * n_sms // tiles)))
    kb_per_split = -(-nkb // want)
    return bm, kb_per_split, -(-nkb // kb_per_split)


def ovsf_gemm(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor, *,
              alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """y = x @ W(alphas, idx). x: (M, d_in); alphas: (J, d_out); idx: (J,)
    monolithic or (n_seg, n_keep) segmented int32 code ids -> (M, d_out) in
    x.dtype, accumulated in fp32."""
    if x.device.type == "cpu":
        return ovsf_gemm_plain(x, alphas, idx, alpha_scale=alpha_scale,
                               alpha_dtype=alpha_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ovsf_gemm: unsupported device {x.device}")
    if alpha_dtype:
        raise NotImplementedError("int8/int4 epilogue of ovsf_gemm: "
                                  "next slice")
    if x.dim() != 2 or alphas.dim() != 2:
        raise ValueError(f"ovsf_gemm: x {tuple(x.shape)} and alphas "
                         f"{tuple(alphas.shape)} must be 2-D")
    if x.dtype not in (torch.float32, torch.bfloat16) or alphas.dtype != x.dtype:
        raise ValueError(f"ovsf_gemm: x {x.dtype} and alphas {alphas.dtype} "
                         "must share one type, float32 or bfloat16")
    for name, t in (("alphas", alphas), ("idx", idx)):
        if t.device != x.device:
            raise ValueError(f"ovsf_gemm: {name} on {t.device}, x on "
                             f"{x.device}")
    M, K = x.shape
    J, N = alphas.shape
    seg = n_keep = 0
    if idx.dim() == 2:
        ns, n_keep = idx.shape
        if ns * n_keep != J or K % ns:
            raise ValueError(f"ovsf_gemm: idx {tuple(idx.shape)} does not "
                             f"tile J={J} rows over d_in={K}")
        seg = K // ns
    elif idx.dim() != 1 or idx.shape[0] != J:
        raise ValueError(f"ovsf_gemm: idx {tuple(idx.shape)} vs J={J}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    x = x.contiguous()
    alphas = alphas.contiguous()
    idx = idx.to(torch.int32).contiguous()
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    bm, kb_per_split, splits = tiling(M, K, N, n_sms)
    partial = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    err = _lib()(x.data_ptr(), alphas.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), M, K, N, J, seg, n_keep,
                 bm, splits, kb_per_split, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ovsf_gemm: CUDA launch failed (cudaError {err})")
    ovsf_gemm.launches += 1
    return out


ovsf_gemm.launches = 0
