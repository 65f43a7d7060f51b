"""Paged flash-decode attention: the Hopper kernel and its plain version.

``paged_flash_decode`` is packed-token GQA attention over paged K/V pools
(see ``kernels.ref.paged_decode_attn_ref``). On a CUDA tensor it launches
``csrc/paged_decode_attn.cu`` (the port of the Pallas
``repro.kernels.decode_attn:paged_flash_decode``; design and bound in the
source's header note) or raises; on a CPU tensor it runs the plain version.
``paged_flash_decode.launches`` counts kernel launches.

The contiguous-cache ``flash_decode_attn`` is not ported yet; its plain
version is ``kernels.ref.decode_attn_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_decode_attn_ref

# The plain PyTorch version of this kernel (CPU path and on-card reference).
paged_flash_decode_plain = paged_decode_attn_ref

_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       slot_ids: torch.Tensor, positions: torch.Tensor
                       ) -> torch.Tensor:
    """Packed-token GQA attention over paged K/V pools.

    q: (T, H, hd); k_pool/v_pool: (P, ps, Hkv, hd); page_table:
    (n_slots + 1, max_pages) int32, sentinel entries carry P; slot_ids /
    positions: (T,) with positions >= 0. Returns (T, H, hd) in q.dtype.
    """
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, k_pool, v_pool, page_table,
                                        slot_ids, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    T, H, hd = q.shape
    P, ps, Hkv, hd_kv = k_pool.shape
    if hd_kv != hd or H % Hkv:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)} vs pools "
                         f"{tuple(k_pool.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"paged_flash_decode: q {q.dtype}, pools "
                         f"{k_pool.dtype}/{v_pool.dtype} must share one "
                         "type, float32 or bfloat16")
    if page_table.dim() != 2 or slot_ids.shape != (T,) or \
            positions.shape != (T,):
        raise ValueError("paged_flash_decode: page_table must be 2-D and "
                         "slot_ids/positions (T,)")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("slot_ids", slot_ids),
                    ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"paged_flash_decode: {name} on {t.device}, q "
                             f"on {q.device}")
        if t.dtype in (torch.float32, torch.bfloat16) and \
                not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {name} must be contiguous")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if T == 0:
        return out
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    sid = slot_ids.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    err = build.launcher("paged_decode_attn", _ARGTYPES)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
        sid.data_ptr(), pos.data_ptr(), out.data_ptr(), T, H, Hkv, hd, P, ps,
        pt.shape[1], pt.shape[0], int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_flash_decode: CUDA launch failed "
                           f"(cudaError {err})")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
