"""Decoder trunk over the serving caches (port of the dense, MoE, SSM,
hybrid, encoder-decoder and VLM families of ``repro.models.transformer``).

A MoE block's MLP is ``models.moe.moe_apply`` over the block's tokens as
the reference routes them: the packed, paged (packed and window) and
prefill steps route the whole step's tokens together, sentinel padding
included (so a real token's output depends on the bucket it rides in, as
in the reference); the contiguous decode and window steps route each slot
alone (``per_row``), as the reference's engine vmaps them over slots.

The reference's ``lax.scan`` over stacked ``blocks`` becomes a Python loop
over a list of per-layer param dicts. The caches stay stacked over layers
and are written in place: the contiguous cache's K/V are ``(n_layers, B, T,
Hkv, hd)`` with a per-slot ``pos`` (B,) (the reference's natural layout;
its engine vmaps single-slot caches where the port batches the slots), the
paged pools ``(n_layers, P, page_size, Hkv, hd)``. ``init_cache`` and
``init_paged_cache`` allocate each as the view of a buffer with one more
row a layer (``"k_rows"`` / ``"v_rows"``): the scratch row that dropped
writes go to (``attention.drop_write``), which no read addresses.

K/V are stored in ``cfg.kv_dtype``: the model dtype, or int8 under
``kv_cache_dtype="int8"`` (``attention``).

The encoder-decoder (``whisper_tiny``) adds a cross-attention sub-block
(``norm_x``, ``cross``) after each decoder layer's self-attention, and a
bidirectional encoder (``params["encoder"]``) over stub audio frames. Its
caches carry a second, constant pair beside K/V: ``xk`` / ``xv``
(n_layers, B, Te, Hkv, hd), the encoder's K/V a layer, always in the model
dtype (never ``kv_cache_dtype``) and with no scratch row (no step writes
them); the paged cache keeps them per slot, dense. ``serve_prefill`` with
``frames`` runs the encoder once and fills them, as deep as the frames;
without frames they stay zero, and cross attention over zero K/V adds
exactly 0 (``cross.o`` has no bias): the engine, which passes tokens
only, as the reference's does, serves the family so. The VLM
(``llava_next_34b``) is the dense stack; ``image_embeds`` replace the
first ``n_img`` embedded positions of a prefill.

The SSM family (``falcon_mamba_7b``: Mamba-1 blocks) and the hybrid
(``zamba2_1_2b``: runs of ``attn_every`` Mamba-2 blocks, each full run
followed by one weight-shared attention + MLP block, ``params
["shared_attn"]``) carry a recurrent state: ``conv`` (n_layers, B, K-1, C)
in the model dtype and ``ssm`` (n_layers, B, ...) in fp32, beside the
hybrid's K/V of (n_apps, B, T, Hkv, hd), one per application of the shared
block. Every state update is copied into the cache's buffers in place (a
replayed decode step reads and writes them at fixed addresses). Their
state would run through padding, so they are served only by the legacy
engine's exact prefill (``serve_prefill``) and all-slot decode
(``serve_step``); every padded entry point (ragged prefill, window,
packed, paged, multi-model) refuses them, as the reference's callers gate
them out.

``model_apply`` and ``lm_loss`` are the training forward and loss over a
whole (B, S) sequence with no cache (causal attention at positions
``arange(S)``, nothing written in place), for every family: a MoE block
returns its load-balance aux, summed over the stack in fp32; the Mamba
blocks run their chunked scans from a zero state; the hybrid applies its
shared block after each full group; an encoder-decoder batch's
``frames`` run the encoder, and each decoder layer's cross attention
reads ``make_cross_cache`` of its output; a VLM batch's
``image_embeds`` take the first positions. When ``cfg.remat`` and
``train``, each stacked block (the encoder's included) runs under
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` wraps
its scan bodies; the hybrid's shared block is applied outside it, as the
reference applies it.

The steps return ``pos`` as a new tensor, as the reference does; a caller
that replays a step as a CUDA graph copies it into its own (the engine).
The legacy engine's prefills (``serve_prefill``, ``serve_prefill_ragged``)
fill a fresh cache of their own and return it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SSM

_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
_RECURRENT = ("ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port serves the dense, MoE, SSM, hybrid, encoder-decoder "
            f"and VLM families, got {cfg.family!r}")


def _check_padded(cfg: ModelConfig, what: str) -> None:
    """The padded entry points take the KV-cache families only."""
    _check_family(cfg)
    if cfg.family in _RECURRENT:
        raise NotImplementedError(
            f"{what} requires a KV-cache family, got {cfg.family!r}: "
            f"recurrent state would run through the padding")


def _mlp_apply(p: dict, cfg: ModelConfig, x: torch.Tensor,
               mids: Optional[torch.Tensor] = None) -> torch.Tensor:
    u = L.linear_apply(p["up"], x, cfg, "mlp_up", mids)
    if cfg.mlp_gated:
        g = L.linear_apply(p["gate"], x, cfg, "mlp_gate", mids)
        h = (torch.nn.functional.silu(g.to(torch.float32))
             * u.to(torch.float32)).to(x.dtype)
    else:
        # jax.nn.gelu's default: the tanh approximation
        h = torch.nn.functional.gelu(u.to(torch.float32),
                                     approximate="tanh").to(x.dtype)
    return L.linear_apply(p["down"], h, cfg, "mlp_down", mids)


def _layer(cache: dict, li: int) -> dict:
    """Layer ``li``'s K/V (and their scratch-row buffers, where allocated);
    the cross caches are read through ``_cross_at`` / ``_packed_cross_at``."""
    return {name: t[li] for name, t in cache.items()
            if name not in ("pos", "xk", "xv")}


def _block(p: dict, cfg: ModelConfig, x: torch.Tensor, attn, *,
           per_row: bool = False, cross=None, **kw
           ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-norm attention + MLP (or MoE) block: (x, the MoE block's fp32
    aux loss, or None). ``attn`` is one of the attention functions of
    ``models.attention`` over the layer's cache (or none), called with
    ``kw``. A ``mids`` entry of ``kw`` ((T,) variant ids of a packed
    stream) reaches the attention's and the MLP's linears. ``per_row``
    routes a MoE block's rows alone (module docstring). A decoder layer of
    the encoder-decoder runs its cross sub-block after the self-attention:
    ``cross(p["cross"], h)`` over its normed features."""
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    y, _ = attn(p["attn"], cfg, h, **kw)
    x = x + y
    if "cross" in p:
        h = L.rmsnorm_apply(p["norm_x"], x, cfg.norm_eps)
        x = x + cross(p["cross"], h)
    h = L.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = M.moe_apply(p["moe"], cfg, h, per_row=per_row)
        return x + y, aux
    mids = kw.get("mids")
    # mids is (T,); the MLP's activations are (1, T, d)
    return x + _mlp_apply(p["mlp"], cfg, h,
                          None if mids is None else mids[None, :]), None


def _unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(x.dtype)
    return x @ params["lm_head"]["w"].to(x.dtype)


def _hybrid_groups(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """[(start, end, attn_after)] runs of mamba2 blocks (zamba2 pattern)."""
    k = cfg.attn_every
    out = []
    i = 0
    while i < cfg.n_layers:
        j = min(i + k, cfg.n_layers)
        out.append((i, j, j - i == k))
        i = j
    return out


def n_attn_apps(cfg: ModelConfig) -> int:
    """Applications of the hybrid's shared attention block (its K/V
    caches)."""
    return sum(1 for *_r, a in _hybrid_groups(cfg) if a)


def _cross_shapes(cfg: ModelConfig, B: int) -> dict[str, tuple]:
    """The encoder-decoder's cross caches, ``encoder_seq`` deep."""
    if cfg.family != "encdec":
        return {}
    shape = (cfg.n_layers, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    return {"xk": shape, "xv": shape}


def _cross_zeros(cfg: ModelConfig, B: int, device) -> dict:
    """Zero cross caches in the model dtype (never ``kv_cache_dtype``)."""
    return {name: torch.zeros(shape, dtype=cfg.act_dtype, device=device)
            for name, shape in _cross_shapes(cfg, B).items()}


def cache_shapes(cfg: ModelConfig, B: int, T: int) -> dict[str, tuple]:
    """Shapes of the contiguous serving cache: per-slot K/V buffers of
    length T, stacked over layers (the hybrid: over the shared block's
    applications), the SSM families' ``conv`` and ``ssm`` states stacked
    over layers, the encoder-decoder's cross caches ``xk`` / ``xv``, and
    each slot's fill level."""
    _check_family(cfg)
    out: dict[str, tuple] = {}
    if cfg.family in _RECURRENT:
        fn = (SSM.mamba1_cache_shapes if cfg.family == "ssm"
              else SSM.mamba2_cache_shapes)
        for name, (shape, _dt) in fn(cfg, B).items():
            out[name] = (cfg.n_layers,) + shape
    if cfg.family != "ssm":
        n = n_attn_apps(cfg) if cfg.family == "hybrid" else cfg.n_layers
        out["k"] = out["v"] = (n, B, T, cfg.n_kv_heads, cfg.hd)
    out.update(_cross_shapes(cfg, B))
    out["pos"] = (B,)
    return out


def _kv(shapes: dict, dtype, device) -> dict[str, torch.Tensor]:
    """Zero K and V of ``shapes`` ((n_layers, ..., Hkv, hd)), each the view
    of an (n_layers, R + 1, Hkv, hd) buffer (``"k_rows"`` / ``"v_rows"``)
    whose last row a layer is the scratch row of ``drop_write``."""
    out = {}
    for name in ("k", "v"):
        nl, *lead, Hkv, hd = shapes[name]
        R = math.prod(lead)
        rows = torch.zeros((nl, R + 1, Hkv, hd), dtype=dtype, device=device)
        out[name] = rows[:, :R].view(shapes[name])
        out[name + "_rows"] = rows
    return out


def init_cache(cfg: ModelConfig, B: int, T: int, device
               ) -> dict[str, torch.Tensor]:
    """Zero contiguous cache: K/V in ``cfg.kv_dtype`` (with their scratch
    rows), ``conv`` and the cross caches in the model dtype and ``ssm`` in
    fp32, ``pos`` int32."""
    shapes = cache_shapes(cfg, B, T)
    out = _kv(shapes, cfg.kv_dtype, device) if "k" in shapes else {}
    out.update(_cross_zeros(cfg, B, device))
    for name, dtype in (("conv", cfg.act_dtype), ("ssm", torch.float32),
                        ("pos", torch.int32)):
        if name in shapes:
            out[name] = torch.zeros(shapes[name], dtype=dtype, device=device)
    return out


def _mamba_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[dict] = None) -> torch.Tensor:
    """Pre-norm Mamba block (Mamba-1 for the SSM family, Mamba-2 for the
    hybrid). With ``state`` (one layer's ``conv`` / ``ssm`` of a serving
    cache) the scan starts from it and the new state is copied into it in
    place; without, the block is cache-free (the training forward: a zero
    state, nothing written)."""
    h = L.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    fn = SSM.mamba1_apply if cfg.family == "ssm" else SSM.mamba2_apply
    y, new = fn(p["mamba"], cfg, h, cache=state)
    if state is not None:
        for name in ("conv", "ssm"):
            state[name].copy_(new[name])
    return x + y


def _state_at(cache: dict, li: int) -> dict:
    """Layer ``li``'s recurrent state (views into the cache)."""
    return {"conv": cache["conv"][li], "ssm": cache["ssm"][li]}


def _kv_layer(cache: dict, i: int) -> dict:
    """K/V ``i`` (and their scratch-row buffers, where allocated)."""
    return {n: cache[n][i] for n in ("k", "v", "k_rows", "v_rows")
            if n in cache}


def _embed_inputs(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  image_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """(B, S, d) embedded tokens; a VLM's ``image_embeds`` (B, n_img, d),
    cast to the activation dtype, replace the first ``n_img`` positions
    (``n_img`` the tensor's, not the config's), as in the reference."""
    x = L.embed_apply(params["embed"], tokens)
    if cfg.family == "vlm" and image_embeds is not None:
        img = image_embeds.to(x.dtype)
        x = torch.cat([img, x[:, img.shape[1]:]], dim=1)
    return x


def _remat(on: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant: its
    activations recomputed in the backward) when ``on``."""
    if on:
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _encoder_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    return _block(p, cfg, x, A.attn_apply, positions=positions,
                  mode="bidir")[0]


def _encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """The encoder over (B, Tf, d) stub audio frames, cast to the model
    dtype: bidirectional attention + MLP blocks at positions ``arange(Tf)``
    (each under ``torch.utils.checkpoint`` with ``remat``), then the
    encoder's norm."""
    x = frames.to(cfg.act_dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    for p in params["encoder"]["blocks"]:
        x = _remat(remat, _encoder_block, p, cfg, x, positions)
    return L.rmsnorm_apply(params["encoder"]["norm"], x, cfg.norm_eps)


def _cross_at(cfg: ModelConfig, cache: dict, li: int):
    """Layer ``li``'s cross sub-block over the contiguous cross caches, or
    None for a family without them."""
    if "xk" not in cache:
        return None
    xk, xv = cache["xk"][li], cache["xv"][li]
    return lambda p, h: A.cross_attend(p, cfg, h, xk, xv)


def _trunk(params: dict, cfg: ModelConfig, cache: dict,
           tokens: torch.Tensor, per_row: bool = False,
           image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) tokens appended at each row's ``cache["pos"]``: features
    (B, S, d), K/V and recurrent states written into the cache in place.
    ``per_row`` routes a MoE block's rows alone (the reference's vmapped
    steps). The hybrid runs its groups of Mamba-2 blocks, the shared
    attention block after each full group over its own K/V. An
    encoder-decoder layer reads its cross caches (``xk`` / ``xv``); a VLM
    prefill's ``image_embeds`` take the first positions."""
    _check_family(cfg)
    S = tokens.shape[1]
    pos0 = cache["pos"].long()
    positions = pos0[:, None] + torch.arange(S, device=tokens.device)[None]
    x = _embed_inputs(params, cfg, tokens, image_embeds)        # (B, S, d)
    if cfg.family == "ssm":
        for li, p in enumerate(params["blocks"]):
            x = _mamba_block(p, cfg, x, _state_at(cache, li))
        return x
    if cfg.family == "hybrid":
        app = 0
        for i, j, attn_after in _hybrid_groups(cfg):
            for li in range(i, j):
                x = _mamba_block(params["blocks"][li], cfg, x,
                                 _state_at(cache, li))
            if attn_after:
                x, _ = _block(params["shared_attn"], cfg, x, A.attn_apply,
                              positions=positions,
                              cache=_kv_layer(cache, app), cache_pos=pos0)
                app += 1
        return x
    for li, p in enumerate(params["blocks"]):
        x, _ = _block(p, cfg, x, A.attn_apply, per_row=per_row,
                      cross=_cross_at(cfg, cache, li), positions=positions,
                      cache=_layer(cache, li), cache_pos=pos0)
    return x


def serve_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  buffer_len: int, *, frames: Optional[torch.Tensor] = None,
                  image_embeds: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, dict]:
    """Run (B, Sp) prompts through the model into a fresh cache of
    ``buffer_len``: ((B, vocab) logits at the last position, the cache with
    ``pos`` = Sp). The reference's batch keys: an encoder-decoder's
    ``frames`` (B, Tf, d) run the encoder once, and each layer's cross K/V
    (``make_cross_cache`` of the encoder output) replace the cache's zero
    ``xk`` / ``xv``, Tf deep; a VLM's ``image_embeds`` (B, n_img, d) take
    the first n_img positions. Other families ignore them, as the
    reference does."""
    B, Sp = tokens.shape
    cache = init_cache(cfg, B, buffer_len, tokens.device)
    if cfg.family == "encdec" and frames is not None:
        enc = _encode(params, cfg, frames)
        xkv = [A.make_cross_cache(p["cross"], cfg, enc)
               for p in params["blocks"]]
        cache["xk"] = torch.stack([c["k"] for c in xkv])
        cache["xv"] = torch.stack([c["v"] for c in xkv])
    x = _trunk(params, cfg, cache, tokens, image_embeds=image_embeds)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    cache["pos"] += Sp
    return logits, cache


def serve_prefill_ragged(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                         buffer_len: int, lengths: torch.Tensor, *,
                         frames: Optional[torch.Tensor] = None,
                         image_embeds: Optional[torch.Tensor] = None
                         ) -> tuple[torch.Tensor, dict]:
    """Batched prefill of right-padded prompts: row b's prompt in columns
    [0, lengths[b]) of (B, Lb) ``tokens``. Returns the (B, vocab) logits at
    column ``lengths[b] - 1`` (clipped into [0, Lb)), which causal attention
    makes independent of the padding, and a fresh cache of ``buffer_len``
    holding K/V for all Lb columns (padding included) with ``pos`` = Lb;
    the engine re-bases each row's ``pos`` to its true length, and decode
    overwrites each padded position before attending to it. The recurrent
    families are refused (their state would run through the padding).
    ``image_embeds`` take a VLM's first positions, as in ``serve_prefill``.
    ``frames`` do not reach the decoder: the reference's ragged prefill
    encodes them but its cross attention reads the fresh cache's zero
    ``xk`` / ``xv``, so its output is that of a prefill without them; the
    port skips the unused encoder pass (copied behaviour, ROADMAP C)."""
    _check_padded(cfg, "ragged prefill")
    del frames
    B, Lb = tokens.shape
    cache = init_cache(cfg, B, buffer_len, tokens.device)
    x = _trunk(params, cfg, cache, tokens, image_embeds=image_embeds)
    col = (lengths.long() - 1).clamp(0, Lb - 1)
    feats = x[torch.arange(B, device=x.device), col]            # (B, d)
    logits = _unembed(params, cfg, feats[None])[0]
    cache["pos"] += Lb
    return logits, cache


def serve_step(params: dict, cfg: ModelConfig, cache: dict,
               tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) -> ((B, vocab) logits, the cache with
    every row's ``pos`` advanced by one). A MoE block routes each row
    alone, as the reference's engine vmaps this step over its slots."""
    x = _trunk(params, cfg, cache, tokens, per_row=True)
    logits = _unembed(params, cfg, x[:, -1:])[:, 0]
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + 1
    return logits, new_cache


def serve_step_window(params: dict, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor, n_valid: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """Ragged window: row b advances by ``n_valid[b]`` of its W supplied
    tokens ((B, W), real tokens in columns [0, n_valid[b])). Returns the
    (B, vocab) logits at column ``n_valid[b] - 1`` (clamped into [0, W)),
    unembedding only those B rows, and the cache with ``pos += n_valid``.
    The padded K/V written past a row's true tokens sit beyond every query
    position until real tokens overwrite them; the engine over-allocates
    the buffer by W so that the writes never clamp for a live slot. A MoE
    block routes each row alone, as the reference's engine vmaps this step
    over its slots. The recurrent families are refused."""
    _check_padded(cfg, "window step")
    W = tokens.shape[1]
    x = _trunk(params, cfg, cache, tokens, per_row=True)
    col = (n_valid.long() - 1).clamp(0, W - 1)
    feats = x[torch.arange(x.shape[0], device=x.device), col]   # (B, d)
    logits = _unembed(params, cfg, feats[None])[0]
    new_cache = dict(cache)
    new_cache["pos"] = cache["pos"] + n_valid.to(cache["pos"].dtype)
    return logits, new_cache


def _packed_cross_at(cfg: ModelConfig, cache: dict, li: int, kw: dict):
    """Layer ``li``'s cross sub-block of a packed stream: each token over
    its slot's cross caches (``attention.cross_attn_packed``), or None."""
    if "xk" not in cache:
        return None
    xkv = {"k": cache["xk"][li], "v": cache["xv"][li]}
    return lambda p, h: A.cross_attn_packed(
        p, cfg, h, slot_ids=kw["slot_ids"], cache=xkv, mids=kw.get("mids"))


def _packed_trunk(params: dict, cfg: ModelConfig, cache: dict,
                  tokens: torch.Tensor, new_pos: torch.Tensor,
                  emit_idx: torch.Tensor, attn, **kw
                  ) -> tuple[torch.Tensor, dict]:
    """One dense pass over a packed (T,) token stream, ``attn`` reading and
    writing each layer's cache; the unembed runs on the B rows at
    ``emit_idx`` only."""
    x = L.embed_apply(params["embed"], tokens[None])           # (1, T, d)
    for li, p in enumerate(params["blocks"]):
        x, _ = _block(p, cfg, x, attn,
                      cross=_packed_cross_at(cfg, cache, li, kw),
                      cache=_layer(cache, li), **kw)
    feats = x[0][emit_idx.long()]                               # (B, d)
    logits = _unembed(params, cfg, feats[None])[0]              # (B, vocab)
    new_cache = dict(cache)
    new_cache["pos"] = new_pos
    return logits, new_cache


def serve_step_packed(params: dict, cfg: ModelConfig, cache: dict,
                      tokens: torch.Tensor, slot_ids: torch.Tensor,
                      positions: torch.Tensor, new_pos: torch.Tensor,
                      emit_idx: torch.Tensor, *,
                      model_ids: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, dict]:
    """Token-packed step against the contiguous cache: the contract of
    ``serve_step_paged`` without the page table (padding tokens carry
    ``slot_id == B``). Returns ((B, vocab) logits gathered at ``emit_idx``
    before the unembed, the cache with ``pos`` set to ``new_pos``).
    ``model_ids`` (B,) maps each slot to a stacked-alpha variant
    (``serve_step_packed_multi``); None = one model."""
    _check_padded(cfg, "packed step")
    kw = {}
    if model_ids is not None:
        # padding tokens (slot_id == B) clip to slot B - 1: their variant
        # is arbitrary, their writes dropped and their outputs discarded
        B = model_ids.shape[0]
        kw["mids"] = model_ids[slot_ids.long().clamp(0, B - 1)]
    return _packed_trunk(params, cfg, cache, tokens, new_pos, emit_idx,
                         A.attn_apply_packed, slot_ids=slot_ids,
                         positions=positions, **kw)


def paged_cache_shapes(cfg: ModelConfig, B: int, page_size: int,
                       n_pages: int) -> dict[str, tuple]:
    """Shapes of the paged serving cache of B slots: per-layer K/V page
    pools shared by every slot, stacked over layers, and an
    encoder-decoder's cross caches, per slot and dense (prompt-sized
    constants, not a growing cache), as the reference's
    ``paged_cache_spec(cfg, B, page_size, n_pages)``."""
    _check_padded(cfg, "paged cache")
    shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": shape, "v": shape, **_cross_shapes(cfg, B)}


def init_paged_cache(cfg: ModelConfig, B: int, page_size: int, n_pages: int,
                     device) -> dict[str, torch.Tensor]:
    """Zero page pools in ``cfg.kv_dtype``, with their scratch rows, and
    zero cross caches of B slots in the model dtype."""
    shapes = paged_cache_shapes(cfg, B, page_size, n_pages)
    out = _kv(shapes, cfg.kv_dtype, device)
    out.update(_cross_zeros(cfg, B, device))
    return out


def serve_step_paged(params: dict, cfg: ModelConfig, cache: dict,
                     page_table: torch.Tensor, tokens: torch.Tensor,
                     slot_ids: torch.Tensor, positions: torch.Tensor,
                     new_pos: torch.Tensor, emit_idx: torch.Tensor
                     ) -> tuple[torch.Tensor, dict]:
    """Token-packed step against the paged KV cache.

    tokens / slot_ids / positions: (T,) — every token of the step, the pow-2
    tail padding carrying ``slot_id == n_slots``. new_pos / emit_idx: (B,)
    post-step fill levels and the packed index of each slot's last token.
    page_table: (n_slots + 1, max_pages) int32, shared by every layer.
    Returns ((B, vocab) logits at ``emit_idx``, the cache with its K/V pools
    updated in place and ``pos`` set to ``new_pos``).
    """
    _check_padded(cfg, "paged step")
    return _packed_trunk(params, cfg, cache, tokens, new_pos, emit_idx,
                         A.attn_apply_paged, slot_ids=slot_ids,
                         positions=positions, page_table=page_table)


def serve_step_window_paged(params: dict, cfg: ModelConfig, cache: dict,
                            page_table: torch.Tensor, tokens: torch.Tensor,
                            n_valid: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
    """Advance slot b by ``n_valid[b]`` of its W supplied tokens ((B, W)
    window), returning each slot's logits at column ``n_valid[b] - 1``: the
    window is flattened onto ``serve_step_paged``; padding columns become
    sentinel-slot tokens at position 0. ``cache["pos"]`` is (B,)."""
    tok, slot_ids, positions, new_pos, emit_idx = _window_as_packed(
        cache, tokens, n_valid)
    return serve_step_paged(params, cfg, cache, page_table, tok, slot_ids,
                            positions, new_pos, emit_idx)


# ---------------------------------------------------------------------------
# Multi-model steps: same-architecture variants batched in one step
# ---------------------------------------------------------------------------

def serve_step_packed_multi(params: dict, cfg: ModelConfig, cache: dict,
                            tokens: torch.Tensor, slot_ids: torch.Tensor,
                            positions: torch.Tensor, new_pos: torch.Tensor,
                            emit_idx: torch.Tensor, model_ids: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
    """``serve_step_packed`` over M stacked same-architecture variants.

    ``params``' OVSF alpha leaves carry a leading (M, ...) variant axis
    (every other leaf, ids included, is shared: ``serving.model_registry.
    stack_variants``); ``model_ids`` (B,) maps each slot to its variant,
    and each packed token contracts against its slot's alpha bank
    (``kernels.ops.ovsf_matmul_multi``), so a step mixes models at the
    single-model step shapes. An encoder-decoder's cross sub-block reads
    each token's slot caches with its variant's projections
    (``attention.cross_attn_packed``); the encoder does not run here."""
    _check_padded(cfg, "multi-model step")
    if cfg.family == "moe":
        raise NotImplementedError(
            "multi-model batching over MoE expert banks is not supported "
            "yet (per-expert alpha stacking)")
    return serve_step_packed(params, cfg, cache, tokens, slot_ids, positions,
                             new_pos, emit_idx, model_ids=model_ids)


def _window_as_packed(cache: dict, tokens: torch.Tensor,
                      n_valid: torch.Tensor) -> tuple:
    """A (B, W) ragged window flattened onto the packed layout: padding
    columns (``col >= n_valid[b]``) become sentinel-slot tokens at position
    0; each slot emits at its column ``n_valid[b] - 1``. ``cache["pos"]``
    is (B,)."""
    B, W = tokens.shape
    dev = tokens.device
    pos0 = cache["pos"].long()
    col = torch.arange(W, device=dev)
    valid = col[None, :] < n_valid[:, None]
    slot_ids = torch.where(valid, torch.arange(B, device=dev)[:, None],
                           B).reshape(-1)
    positions = torch.where(valid, pos0[:, None] + col[None, :],
                            0).reshape(-1)
    new_pos = pos0 + n_valid
    emit_idx = torch.arange(B, device=dev) * W + (n_valid - 1).clamp(0, W - 1)
    return tokens.reshape(-1), slot_ids, positions, new_pos, emit_idx


def serve_step_window_multi(params: dict, cfg: ModelConfig, cache: dict,
                            tokens: torch.Tensor, n_valid: torch.Tensor,
                            model_ids: torch.Tensor
                            ) -> tuple[torch.Tensor, dict]:
    """``serve_step_window`` semantics over stacked variants: slot b
    advances by ``n_valid[b]`` of its W tokens under variant
    ``model_ids[b]``, the window flattened onto the packed multi trunk as
    ``serve_step_window_paged`` flattens it onto the paged one (exact
    writes, no window slack). ``cache["pos"]`` is (B,)."""
    tok, slot_ids, positions, new_pos, emit_idx = _window_as_packed(
        cache, tokens, n_valid)
    return serve_step_packed_multi(params, cfg, cache, tok, slot_ids,
                                   positions, new_pos, emit_idx, model_ids)


# ---------------------------------------------------------------------------
# Training forward and loss (no cache)
# ---------------------------------------------------------------------------

LOSS_CHUNK = 1024   # sequence positions per unembed + CE chunk


def check_trainable(cfg: ModelConfig) -> None:
    """The families this port trains: all six."""
    _check_family(cfg)


def _train_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, enc_out: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One attention block of the training forward: (x, its fp32 aux, 0
    but for a MoE block). An encoder-decoder layer's cross attention reads
    ``make_cross_cache`` of ``enc_out`` (recomputed with the block under
    remat, so its gradient reaches the encoder); without frames it reads
    the block's own normed features, as the reference's ``kv_src=None``
    does (copied; ROADMAP C)."""
    def cross(pc, h):
        kv = A.make_cross_cache(pc, cfg, h if enc_out is None else enc_out)
        return A.cross_attend(pc, cfg, h, kv["k"], kv["v"])
    x, aux = _block(p, cfg, x, A.attn_apply, cross=cross,
                    positions=positions, mode="causal")
    return x, (x.new_zeros((), dtype=torch.float32) if aux is None
               else aux)


def _train_trunk(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, enc_out: Optional[torch.Tensor],
                 remat: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The cache-free stack over (B, S, d) ``x``: (features, the aux
    summed over the blocks in fp32, in layer order)."""
    aux = x.new_zeros((), dtype=torch.float32)
    if cfg.family in _RECURRENT:
        blocks = params["blocks"]
        groups = (_hybrid_groups(cfg) if cfg.family == "hybrid"
                  else [(0, len(blocks), False)])
        for i, j, attn_after in groups:
            for li in range(i, j):
                x = _remat(remat, _mamba_block, blocks[li], cfg, x)
            if attn_after:
                # applied as it is, never rematerialised: its gradient
                # sums over its applications
                x, a = _train_block(params["shared_attn"], cfg, x,
                                    positions, None)
                aux = aux + a
        return x, aux
    for p in params["blocks"]:
        x, a = _remat(remat, _train_block, p, cfg, x, positions, enc_out)
        aux = aux + a
    return x, aux


def model_apply(params: dict, cfg: ModelConfig, batch: dict, *,
                train: bool = False, return_features: bool = False
                ) -> tuple[torch.Tensor, None, torch.Tensor]:
    """Forward pass of (B, S) ``batch["tokens"]`` with no cache: (logits,
    or the final features with ``return_features``, None for the cache the
    reference would return, the fp32 aux loss: the MoE blocks' summed, 0
    for the other families). The reference's batch keys: an
    encoder-decoder's ``frames`` (B, Tf, d) run the encoder, a VLM's
    ``image_embeds`` (B, n_img, d) take the first n_img positions. Under
    ``cfg.remat and train`` each stacked block's activations are
    recomputed in the backward (``torch.utils.checkpoint``,
    non-reentrant)."""
    check_trainable(cfg)
    tokens = batch["tokens"]
    x = _embed_inputs(params, cfg, tokens, batch.get("image_embeds"))
    remat = cfg.remat and train
    enc_out = None
    if cfg.family == "encdec" and "frames" in batch:
        enc_out = _encode(params, cfg, batch["frames"], remat)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, aux = _train_trunk(params, cfg, x, positions, enc_out, remat)
    out = x if return_features else _unembed(params, cfg, x)
    return out, None, aux


def lm_loss(params: dict, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token CE (+ ``router_aux_weight`` x the aux loss), the unembed
    chunked over ``LOSS_CHUNK`` positions so full (B, S, vocab) logits
    never exist at once; a VLM batch's image positions are masked out of
    the loss, as in the reference. Returns (total, {"loss", "aux"})."""
    feats, _, aux = model_apply(params, cfg, batch, train=True,
                                return_features=True)
    tokens = batch["tokens"]
    B, Sm1 = tokens.shape[0], tokens.shape[1] - 1
    tgt = tokens[:, 1:].long()
    xs = feats[:, :-1]
    mask = torch.ones((B, Sm1), dtype=torch.float32, device=feats.device)
    if cfg.family == "vlm" and "image_embeds" in batch:
        mask[:, : max(batch["image_embeds"].shape[1] - 1, 0)] = 0.0
    c = min(LOSS_CHUNK, Sm1)
    pad = (-Sm1) % c
    if pad:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        tgt = torch.nn.functional.pad(tgt, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=feats.device)
    cnt = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(0, xs.shape[1], c):
        lg = _unembed(params, cfg, xs[:, i:i + c]).to(torch.float32)
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, tgt[:, i:i + c, None])[..., 0]
        mc = mask[:, i:i + c]
        tot = tot + torch.sum((lse - gold) * mc)
        cnt = cnt + torch.sum(mc)
    loss = tot / torch.clamp(cnt, min=1.0)
    total = loss + cfg.router_aux_weight * aux
    return total, {"loss": loss, "aux": aux}
