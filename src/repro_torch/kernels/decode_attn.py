"""Flash-decode attention: the Hopper kernels and their plain versions.

``flash_decode_attn`` is single-token GQA attention over a contiguous
(B, T, Hkv, hd) cache under the exclusive mask ``col < pos[b]`` (see
``kernels.ref.decode_attn_ref``); it launches ``csrc/flash_decode_attn.cu``,
the port of the Pallas ``repro.kernels.decode_attn:flash_decode_attn``.
``paged_flash_decode`` is packed-token GQA attention over paged K/V pools
under the inclusive mask ``col <= positions[t]`` (see
``kernels.ref.paged_decode_attn_ref``); it launches
``csrc/paged_decode_attn.cu``, the port of the Pallas
``paged_flash_decode``. Both kernels share ``csrc/decode_attn.cuh``: a grid
of (token, kv-head x head chunk, split) blocks, each split a run of pages or
rows; ``split_plan`` sets the run from the shapes alone, and the splits
merge in the same launch (design and bound in each source's header note).
K/V are of q's type or int8 (the int8 KV cache,
``ModelConfig.kv_cache_dtype``): the kernels dequantise each int8 element
as they load it, as the reference dequantises the cache before its
attention (``kernels.ref.dequant``); the plain versions over int8 are
``dequant`` and then the float ones.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version; any other device raises. Shapes, types and the
head-dim limit are checked on every device first. ``<wrapper>.launches``
counts kernel launches; ``flash_decode_attn.launches_unmasked`` counts
those of its launches given an int ``pos`` at or past T, in which every
row reads every column (cross attention's reads).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ovsf_gemm import ticket_buffer
from repro_torch.kernels.ref import (decode_attn_int8_ref, decode_attn_ref,
                                     paged_decode_attn_int8_ref,
                                     paged_decode_attn_ref)

# The plain PyTorch versions of the kernels (CPU path and on-card
# reference), over K/V of q's type and over int8 K/V.
flash_decode_attn_plain = decode_attn_ref
paged_flash_decode_plain = paged_decode_attn_ref
flash_decode_attn_int8_plain = decode_attn_int8_ref
paged_flash_decode_int8_plain = paged_decode_attn_int8_ref

MAX_HD = 256                  # largest head dim either kernel takes
HEADS_PER_BLOCK = 8           # query heads a block holds; more: head chunks
ROW_UNIT = 16                 # rows of a contiguous split's unit
SPLIT_TARGET_CAP = 32         # splits stay below twice this (the kernels'
                              # MAX_SPLITS, 64)
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 12
             + [ctypes.c_void_p])
_FLASH_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])


def head_chunks(H: int, Hkv: int) -> int:
    """Blocks that share one (token, kv-head): ceil(G / 8) for G = H / Hkv."""
    return -(-(H // Hkv) // HEADS_PER_BLOCK)


def split_plan(pairs: int, units: int, n_sms: int) -> tuple[int, int]:
    """(units per split, splits) for ``pairs`` (token or row, kv-head, head
    chunk) triples, each over ``units`` pages (paged) or 16-row units
    (contiguous). Each pair's units are split until the blocks fill one wave
    of the card, ``pairs * splits >= n_sms``, with as many units a split as
    that allows; one split where the pairs fill it alone. From the shapes
    alone, never from the positions, so a launch needs no host sync."""
    want = max(1, min(SPLIT_TARGET_CAP, -(-n_sms // max(pairs, 1))))
    per = max(1, units // want)
    return per, max(1, -(-units // per))


def paged_plan(T: int, H: int, Hkv: int, npg: int, ps: int,
               n_sms: int) -> tuple[int, int, int]:
    """The paged kernel's (columns per split, splits, blocks)."""
    pairs = T * Hkv * head_chunks(H, Hkv)
    per, splits = split_plan(pairs, npg, n_sms)
    return per * ps, splits, pairs * splits


def flash_plan(B: int, H: int, Hkv: int, T: int,
               n_sms: int) -> tuple[int, int, int]:
    """The contiguous kernel's (rows per split, splits, blocks)."""
    pairs = B * Hkv * head_chunks(H, Hkv)
    per, splits = split_plan(pairs, -(-T // ROW_UNIT), n_sms)
    return per * ROW_UNIT, splits, pairs * splits


def sm_count(device) -> int:
    """The card's SMs: one wave of the plans."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _scratch(out: torch.Tensor, splits: int):
    """The splits' fp32 partials for out (T, H, hd): (acc (T * H, splits,
    hd rounded up to 4), (m, l) (T * H, splits, 2)); with one split they
    are unread and out stands in. Under CUDA-graph capture they come from
    the graph's memory pool, which lives as long as the graph."""
    if splits == 1:
        return out, out
    rows, hdp = out.shape[0] * out.shape[1], -(-out.shape[2] // 4) * 4
    return (torch.empty(rows * splits * hdp, dtype=torch.float32,
                        device=out.device),
            torch.empty(rows * splits * 2, dtype=torch.float32,
                        device=out.device))


def _check_types(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """q float32 or bfloat16; K and V both of q's type or both int8."""
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != v.dtype \
            or k.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"{name}: q {q.dtype}, k/v {k.dtype}/{v.dtype}: q "
                         "float32 or bfloat16; K and V of one type, q's or "
                         "int8")


def _check_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> None:
    """What the kernel takes, checked on every device, so that a path that
    passes on the CPU does not meet a refusal on the card."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode_attn: q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_decode_attn: q {tuple(q.shape)} vs k/v "
                         f"{tuple(k.shape)}")
    if hd > MAX_HD:
        raise ValueError(f"flash_decode_attn: head dim {hd} above the "
                         f"kernel's limit {MAX_HD}")
    _check_types("flash_decode_attn", q, k, v)


def flash_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos) -> torch.Tensor:
    """Single-token GQA attention over a contiguous cache.

    q: (B, H, hd), hd <= ``MAX_HD``; k/v: (B, T, Hkv, hd); q float32 or
    bfloat16, k and v of q's type or int8 (dequantised as loaded, see
    ``kernels.ref.dequant``); pos: the fill level per row, a (B,) or
    0-dim int tensor on q's device, or an int. Columns ``>= pos[b]`` are
    masked; ``pos >= T`` reads all T rows, ``pos <= 0`` gives the mean of
    V. Returns (B, H, hd) in q's type.
    """
    _check_flash(q, k, v)
    if q.device.type == "cpu":
        if k.dtype == torch.int8:
            return flash_decode_attn_int8_plain(q, k, v, pos)
        return flash_decode_attn_plain(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_attn: unsupported device {q.device}")
    B, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    unmasked = not isinstance(pos, torch.Tensor) and int(pos) >= T
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_decode_attn: {name} on {t.device}, q "
                             f"on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_decode_attn: {name} must be contiguous")
    if isinstance(pos, torch.Tensor):
        if pos.device != q.device or pos.dim() > 1 or \
                pos.dim() == 1 and pos.shape[0] != B or \
                pos.dtype.is_floating_point:
            raise ValueError(f"flash_decode_attn: pos must be an int tensor "
                             f"of shape (B,) or () on {q.device}, got "
                             f"{pos.dtype} {tuple(pos.shape)} on "
                             f"{pos.device}")
        pos = pos.to(torch.int32).expand(B).contiguous()
    else:
        pos = torch.full((B,), int(pos), dtype=torch.int32, device=q.device)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    if B == 0:
        return out
    q = q.contiguous()
    rows_per_split, splits, _ = flash_plan(B, H, Hkv, T, sm_count(q.device))
    part_acc, part_ml = _scratch(out, splits)
    tickets = ticket_buffer(q.device, B * Hkv * head_chunks(H, Hkv))
    err = build.launcher("flash_decode_attn", _FLASH_ARGTYPES)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        tickets.data_ptr(), B,
        T, H, Hkv, hd, rows_per_split, splits,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.int8),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode_attn: CUDA launch failed "
                           f"(cudaError {err})")
    flash_decode_attn.launches += 1
    flash_decode_attn.launches_unmasked += int(unmasked)
    return out


flash_decode_attn.launches = 0
flash_decode_attn.launches_unmasked = 0


def _check_paged(q: torch.Tensor, k_pool: torch.Tensor,
                 v_pool: torch.Tensor, page_table: torch.Tensor,
                 slot_ids: torch.Tensor, positions: torch.Tensor) -> None:
    """What the kernel takes, checked on every device, so that a path that
    passes on the CPU does not meet a refusal on the card."""
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    T, H, hd = q.shape
    Hkv, hd_kv = k_pool.shape[2], k_pool.shape[3]
    if hd_kv != hd or H % Hkv:
        raise ValueError(f"paged_flash_decode: q {tuple(q.shape)} vs pools "
                         f"{tuple(k_pool.shape)}")
    if hd > MAX_HD:
        raise ValueError(f"paged_flash_decode: head dim {hd} above the "
                         f"kernel's limit {MAX_HD}")
    _check_types("paged_flash_decode", q, k_pool, v_pool)
    if page_table.dim() != 2 or slot_ids.shape != (T,) or \
            positions.shape != (T,):
        raise ValueError("paged_flash_decode: page_table must be 2-D and "
                         "slot_ids/positions (T,)")


def paged_flash_decode(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       slot_ids: torch.Tensor, positions: torch.Tensor
                       ) -> torch.Tensor:
    """Packed-token GQA attention over paged K/V pools.

    q: (T, H, hd), hd <= ``MAX_HD``, float32 or bfloat16; k_pool/v_pool:
    (P, ps, Hkv, hd), of q's type or int8 (dequantised as loaded);
    page_table: (n_slots + 1, max_pages) int32, sentinel entries carry P;
    slot_ids / positions: (T,) with positions >= 0. Returns (T, H, hd) in
    q.dtype.
    """
    _check_paged(q, k_pool, v_pool, page_table, slot_ids, positions)
    if q.device.type == "cpu":
        plain = (paged_flash_decode_int8_plain if k_pool.dtype == torch.int8
                 else paged_flash_decode_plain)
        return plain(q, k_pool, v_pool, page_table, slot_ids, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode: unsupported device {q.device}")
    T, H, hd = q.shape
    P, ps, Hkv, _ = k_pool.shape
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("slot_ids", slot_ids),
                    ("positions", positions)):
        if t.device != q.device:
            raise ValueError(f"paged_flash_decode: {name} on {t.device}, q "
                             f"on {q.device}")
        if t.dtype in (torch.float32, torch.bfloat16, torch.int8) and \
                not t.is_contiguous():
            raise ValueError(f"paged_flash_decode: {name} must be contiguous")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if T == 0:
        return out
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    sid = slot_ids.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    npg = pt.shape[1]
    cols_per_split, splits, _ = paged_plan(T, H, Hkv, npg, ps,
                                           sm_count(q.device))
    part_acc, part_ml = _scratch(out, splits)
    tickets = ticket_buffer(q.device, T * Hkv * head_chunks(H, Hkv))
    err = build.launcher("paged_decode_attn", _ARGTYPES)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pt.data_ptr(),
        sid.data_ptr(), pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), tickets.data_ptr(), T, H, Hkv, hd, P, ps, npg,
        pt.shape[0], cols_per_split, splits, int(q.dtype == torch.bfloat16),
        int(k_pool.dtype == torch.int8),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_flash_decode: CUDA launch failed "
                           f"(cudaError {err})")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0
