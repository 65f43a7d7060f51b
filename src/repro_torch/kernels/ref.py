"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``).

They are the CPU execution path, and on the card the ground truth each
hand-written kernel is held against. They must stay boring and obviously
correct.
"""
from __future__ import annotations

import torch

from repro_torch.core import ovsf


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised WHT along the last axis (== x @ H_L)."""
    return ovsf.fwht(x, dim=-1)


def dequant_ref(alphas: torch.Tensor, alpha_scale, alpha_dtype: str
                ) -> torch.Tensor:
    """Quantised-storage alphas -> fp32 (identity when alpha_dtype is '')."""
    if not alpha_dtype:
        return alphas
    return ovsf.dequantize_alphas(alphas, alpha_scale, alpha_dtype)


def ovsf_decompress_ref(alphas: torch.Tensor, idx: torch.Tensor, d_in: int, *,
                        alpha_scale=None, alpha_dtype: str = ""
                        ) -> torch.Tensor:
    """(J, d_out) alphas + code ids -> dense (d_in, d_out) W.

    Monolithic idx (J,): W[k, n] = sum_j H[idx[j], k] * alphas[j, n], k < d_in.
    Segmented idx (n_seg, n_keep): block-diagonal basis — each segment's
    codes only touch its own length-L0 slice of k.
    """
    alphas = dequant_ref(alphas, alpha_scale, alpha_dtype)
    idx = idx.long()
    if idx.dim() == 2:
        ns, nk = idx.shape
        L0 = d_in // ns
        al = alphas.reshape(ns, nk, alphas.shape[-1])
        S = ovsf.hadamard_matrix(L0, alphas.dtype, alphas.device)[idx]
        w = torch.einsum("sjl,sjd->sld", S, al)              # (ns, L0, d_out)
        return w.reshape(d_in, alphas.shape[-1])
    L = ovsf.next_pow2(d_in)
    S = ovsf.hadamard_matrix(L, alphas.dtype, alphas.device)[idx, :d_in]
    return S.T @ alphas


def ovsf_matmul_ref(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor,
                    *, alpha_scale=None, alpha_dtype: str = ""
                    ) -> torch.Tensor:
    """Fused on-the-fly GEMM: y = x @ W(alphas, idx), computed in fp32 and
    returned in x.dtype. x: (M, d_in) -> (M, d_out)."""
    d_in = x.shape[-1]
    alphas = dequant_ref(alphas, alpha_scale, alpha_dtype)
    W = ovsf_decompress_ref(alphas.to(torch.float32), idx, d_in)
    return (x.to(torch.float32) @ W).to(x.dtype)


# The int8 KV cache's static scale (``repro.models.attention._KV_SCALE``):
# attention values are O(1) after the norms.
KV_SCALE = 127.0 / 8.0


def quant_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` stored as a cache of type ``dtype``: int8 is round(x * 127/8)
    in fp32 (half to even, as ``jnp.round``), clipped to +-127; any other
    type is a cast."""
    if dtype == torch.int8:
        return torch.round(x.to(torch.float32) * KV_SCALE).clamp(
            -127, 127).to(torch.int8)
    return x.to(dtype)


def dequant(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A cache read back in ``dtype``: int8 to fp32, a true division by the
    scale, then a cast; any other type is a cast."""
    if x.dtype == torch.int8:
        return (x.to(torch.float32) / KV_SCALE).to(dtype)
    return x.to(dtype)


def decode_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos) -> torch.Tensor:
    """Single-token GQA attention over a contiguous cache.

    q: (B, H, hd); k/v: (B, T, Hkv, hd); pos: fill level (scalar or (B,)).
    Columns ``>= pos`` are masked (exclusive). fp32 throughout.
    """
    B, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qf = q.reshape(B, Hkv, G, hd).to(torch.float32) / float(hd) ** 0.5
    s = torch.einsum("bngd,btnd->bngt", qf, k.to(torch.float32))
    pos = torch.as_tensor(pos, device=q.device).reshape(-1, 1, 1, 1)
    mask = torch.arange(T, device=q.device)[None, None, None, :] < pos
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngt,btnd->bngd", p, v.to(torch.float32))
    return o.reshape(B, H, hd).to(q.dtype)


def paged_decode_attn_ref(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          slot_ids: torch.Tensor, positions: torch.Tensor
                          ) -> torch.Tensor:
    """Packed-token GQA attention over paged K/V pools.

    q: (T, H, hd); k_pool/v_pool: (P, page_size, Hkv, hd); page_table:
    (n_slots + 1, max_pages) int32 with sentinel entries = P; slot_ids /
    positions: (T,). Token t reads its slot's pages in list order (the
    virtual contiguous buffer) and masks columns ``> positions[t]``
    (inclusive: its own K/V is already written). Sentinel page ids clamp to
    P-1; the mask excludes everything they could contribute.
    """
    T, H, hd = q.shape
    P, ps, Hkv, _ = k_pool.shape
    G = H // Hkv
    npg = page_table.shape[1]
    pages = page_table.long()[slot_ids.long()].clamp(0, P - 1)   # (T, npg)
    kt = k_pool[pages].reshape(T, npg * ps, Hkv, hd)
    vt = v_pool[pages].reshape(T, npg * ps, Hkv, hd)
    qf = q.reshape(T, Hkv, G, hd).to(torch.float32) / float(hd) ** 0.5
    s = torch.einsum("tngd,tcnd->tngc", qf, kt.to(torch.float32))
    mask = (torch.arange(npg * ps, device=q.device)[None, None, None, :]
            <= positions.reshape(-1, 1, 1, 1))
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("tngc,tcnd->tngd", p, vt.to(torch.float32))
    return o.reshape(T, H, hd).to(q.dtype)


def decode_attn_int8_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos) -> torch.Tensor:
    """``decode_attn_ref`` over an int8 cache: K/V dequantised to q's type
    first, as the reference's ``_dequant`` before its attention."""
    return decode_attn_ref(q, dequant(k, q.dtype), dequant(v, q.dtype), pos)


def paged_decode_attn_int8_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor, page_table: torch.Tensor,
                               slot_ids: torch.Tensor, positions: torch.Tensor
                               ) -> torch.Tensor:
    """``paged_decode_attn_ref`` over int8 pools, dequantised to q's type
    first."""
    return paged_decode_attn_ref(q, dequant(k_pool, q.dtype),
                                 dequant(v_pool, q.dtype), page_table,
                                 slot_ids, positions)
