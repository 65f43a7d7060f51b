"""Mamba-1 (falcon-mamba) and Mamba-2 (zamba2) state-space blocks (port of
``repro.models.ssm``).

Sequence mixing is a chunked diagonal-SSM scan: a loop over chunks of
``cfg.ssm_chunk`` steps carrying the state, with a parallel associative
scan inside each chunk (``_assoc_scan``: the recursive even/odd pairing of
``jax.lax.associative_scan``, so that products and sums pair up as in the
reference). The (chunk, B, ..., N) decay and input tensors are built inside
the chunk and contracted before the next one, so memory is O(chunk * batch
* state), not O(seq * batch * state).

The in/out projections go through ``layers.linear_apply`` under the ``mlp``
OVSF target group (``mlp_in`` / ``mlp_out``); ``x_proj`` (group ``proj``),
``dt_proj``, the conv and the scan parameters stay dense, as in the
reference. The scan, the conv and the gating are plain tensor code: the
reference leaves them to XLA.

The recurrent state (``ssm``) is fp32 and the conv state is in the model
dtype. ``*_apply`` return the new caches as new tensors, as the reference
does; the trunk (``models.transformer``) copies them into the serving
cache's buffers in place.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _assoc_combine(c1: tuple, c2: tuple) -> tuple:
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def _assoc_scan(a: torch.Tensor, u: torch.Tensor) -> tuple:
    """Inclusive scan of ``_assoc_combine`` along axis 0: adjacent pairs
    combined, the half-size scan by recursion, the even elements from the
    odd ones, as ``jax.lax.associative_scan`` pairs them."""
    n = a.shape[0]
    if n < 2:
        return a, u
    ra, ru = _assoc_combine((a[0:-1:2], u[0:-1:2]), (a[1::2], u[1::2]))
    oa, ou = _assoc_scan(ra, ru)
    if n % 2 == 0:
        ea, eu = _assoc_combine((oa[:-1], ou[:-1]), (a[2::2], u[2::2]))
    else:
        ea, eu = _assoc_combine((oa, ou), (a[2::2], u[2::2]))
    ea = torch.cat([a[:1], ea])
    eu = torch.cat([u[:1], eu])
    return _interleave(ea, oa), _interleave(eu, ou)


def chunked_ssm_scan(inputs: tuple, h0: torch.Tensor, chunk: int,
                     build: Callable, contract: Callable
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Diagonal SSM h_t = a_t h_{t-1} + u_t with chunked materialisation.

    inputs: tuple of (T, ...) tensors (T % chunk == 0; callers pad).
    build(*chunk_inputs) -> (a, u) each (chunk, ..., state-shape).
    contract(h_chunk, *chunk_inputs) -> y_chunk.
    Returns (y: (T, ...), h_last).
    """
    T = inputs[0].shape[0]
    assert T % chunk == 0, (T, chunk)
    h, ys = h0, []
    for c0 in range(0, T, chunk):
        cin = tuple(x[c0:c0 + chunk] for x in inputs)
        a, u = build(*cin)
        u = torch.cat([(u[0] + a[0] * h)[None], u[1:]])
        _, hh = _assoc_scan(a, u)
        h = hh[-1]
        ys.append(contract(hh, *cin))
    return torch.cat(ys), h


def _pad_time(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C), w: (K, C), state: (B, K-1, C).
    The taps sum in the reference's order, ``sum(xp[:, i:i+S] * w[i])``."""
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)                        # (B, S+K-1, C)
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y + b[None, None, :], new_state


def _chunked(cfg: ModelConfig, S: int, seq: tuple, h0: torch.Tensor,
             build: Callable, contract: Callable) -> tuple:
    """(B, S, ...) tensors time-major, padded to whole chunks, scanned;
    returns ((B, S, ...) outputs, the last state)."""
    pad = (-S) % cfg.ssm_chunk
    ins = tuple(_pad_time(v.movedim(1, 0), pad) for v in seq)
    y_seq, h_last = chunked_ssm_scan(ins, h0, cfg.ssm_chunk, build, contract)
    return y_seq[:S].movedim(0, 1), h_last


# ---------------------------------------------------------------------------
# Mamba-1 block (falcon-mamba-7b: d_model 4096, expand 2, N=16, conv 4)
# ---------------------------------------------------------------------------

def mamba1_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Same shapes, key names and init statistics as the reference's."""
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dt_rank = max(d // 16, 1)
    dtype = cfg.act_dtype
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(di, 1)
    return {
        "in_proj": L.linear_init(gen, cfg, "mlp_in", d, 2 * di, device),
        "conv_w": torch.randn((cfg.ssm_conv, di), generator=gen, dtype=dtype,
                              device=device) * 0.2,
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": L.linear_init(gen, cfg, "proj_x", di, dt_rank + 2 * N,
                                device),
        "dt_proj": {"w": torch.randn((dt_rank, di), generator=gen,
                                     dtype=dtype, device=device)
                    * math.sqrt(1 / dt_rank),
                    "b": torch.full((di,), math.log(math.expm1(0.01)),
                                    dtype=dtype, device=device)},
        "A_log": torch.log(A),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": L.linear_init(gen, cfg, "mlp_out", di, d, device),
    }


def mamba1_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[dict] = None
                 ) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d). cache: {"conv": (B, K-1, di), "ssm": (B, di, N)}.
    Returns (out, the new cache or None)."""
    B, S, d = x.shape
    di, N = cfg.d_inner, cfg.ssm_state
    dt_rank = max(d // 16, 1)

    xz = L.linear_apply(p["in_proj"], x, cfg, "mlp_in")
    xs, z = torch.chunk(xz, 2, dim=-1)
    conv_state = cache["conv"] if cache else None
    xs, new_conv = _causal_conv(xs, p["conv_w"].to(xs.dtype),
                                p["conv_b"].to(xs.dtype), conv_state)
    xs = F.silu(xs.to(torch.float32))                         # (B, S, di)

    proj = L.linear_apply(p["x_proj"], xs.to(x.dtype), cfg, "proj_x")
    dt, Bc, Cc = torch.split(proj.to(torch.float32), [dt_rank, N, N], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"]["w"].to(torch.float32)
                    + p["dt_proj"]["b"].to(torch.float32))     # (B, S, di)
    A = -torch.exp(p["A_log"].to(torch.float32))              # (di, N)

    h0 = (cache["ssm"] if cache else
          torch.zeros((B, di, N), dtype=torch.float32, device=x.device))

    def build(dt_c, xs_c, B_c, C_c):
        a = torch.exp(dt_c[..., None] * A[None, None])         # (c, B, di, N)
        u = (dt_c * xs_c)[..., None] * B_c[:, :, None, :]
        return a, u

    def contract(hh, dt_c, xs_c, B_c, C_c):
        return torch.einsum("tbdn,tbn->tbd", hh, C_c)

    if S == 1:  # decode fast path: one state update, no scan
        a1 = torch.exp(dt[:, 0, :, None] * A[None])
        h_last = a1 * h0 + (dt[:, 0] * xs[:, 0])[..., None] * Bc[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h_last, Cc[:, 0])[:, None]
    else:
        y, h_last = _chunked(cfg, S, (dt, xs, Bc, Cc), h0, build, contract)

    y = y + p["D"][None, None] * xs
    y = y * F.silu(z.to(torch.float32))
    out = L.linear_apply(p["out_proj"], y.to(x.dtype), cfg, "mlp_out")
    new_cache = ({"conv": new_conv, "ssm": h_last} if cache is not None
                 else None)
    return out, new_cache


def mamba1_cache_shapes(cfg: ModelConfig, B: int) -> dict:
    """{"conv": ((B, K-1, di), model dtype), "ssm": ((B, di, N), fp32)}."""
    K, di, N = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state
    return {"conv": ((B, K - 1, di), cfg.act_dtype),
            "ssm": ((B, di, N), torch.float32)}


# ---------------------------------------------------------------------------
# Mamba-2 block (zamba2: scalar decay per head, SSD-style)
# ---------------------------------------------------------------------------

def mamba2_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Same shapes, key names and init statistics as the reference's."""
    d, di, N, P = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    H = di // P
    dtype = cfg.act_dtype
    f32 = dict(dtype=torch.float32, device=device)
    # in_proj emits [z(di), x(di), B(N), C(N), dt(H)]
    return {
        "in_proj": L.linear_init(gen, cfg, "mlp_in", d, 2 * di + 2 * N + H,
                                 device),
        "conv_w": torch.randn((cfg.ssm_conv, di + 2 * N), generator=gen,
                              dtype=dtype, device=device) * 0.2,
        "conv_b": torch.zeros((di + 2 * N,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), **f32),
        "D": torch.ones((H,), **f32),
        "norm": {"scale": torch.ones((di,), dtype=dtype, device=device)},
        "out_proj": L.linear_init(gen, cfg, "mlp_out", di, d, device),
    }


def mamba2_apply(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                 cache: Optional[dict] = None
                 ) -> tuple[torch.Tensor, Optional[dict]]:
    """x: (B, S, d). cache: {"conv": (B, K-1, di+2N), "ssm": (B, H, P, N)}.
    Returns (out, the new cache or None)."""
    B, S, d = x.shape
    di, N, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    H = di // P

    zxbcdt = L.linear_apply(p["in_proj"], x, cfg, "mlp_in")
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    conv_state = cache["conv"] if cache else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"].to(xbc.dtype),
                                 p["conv_b"].to(xbc.dtype), conv_state)
    xbc = F.silu(xbc.to(torch.float32))
    xs, Bc, Cc = torch.split(xbc, [di, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)

    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])                                # (H,)
    h0 = (cache["ssm"] if cache else
          torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))

    def build(dt_c, xs_c, B_c, C_c):
        a = torch.exp(dt_c * A[None, None])                   # (c, B, H)
        a = a[..., None, None].expand(a.shape + (P, N))
        u = (dt_c[..., None] * xs_c)[..., None] * B_c[:, :, None, None, :]
        return a, u                                           # (c,B,H,P,N)

    def contract(hh, dt_c, xs_c, B_c, C_c):
        return torch.einsum("tbhpn,tbn->tbhp", hh, C_c)

    if S == 1:
        a1 = torch.exp(dt[:, 0] * A[None])[:, :, None, None]
        u1 = (dt[:, 0, :, None] * xs[:, 0])[..., None] * Bc[:, 0, None, None, :]
        h_last = a1 * h0 + u1
        y = torch.einsum("bhpn,bn->bhp", h_last, Cc[:, 0])[:, None]
    else:
        y, h_last = _chunked(cfg, S, (dt, xs, Bc, Cc), h0, build, contract)

    y = y + p["D"][None, None, :, None] * xs
    y = y.reshape(B, S, di) * F.silu(z.to(torch.float32))
    y = L.rmsnorm_apply(p["norm"], y.to(x.dtype), cfg.norm_eps)
    out = L.linear_apply(p["out_proj"], y, cfg, "mlp_out")
    new_cache = ({"conv": new_conv, "ssm": h_last} if cache is not None
                 else None)
    return out, new_cache


def mamba2_cache_shapes(cfg: ModelConfig, B: int) -> dict:
    """{"conv": ((B, K-1, di+2N), model dtype), "ssm": ((B, H, P, N),
    fp32)}."""
    K, di, N, P = cfg.ssm_conv, cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    return {"conv": ((B, K - 1, di + 2 * N), cfg.act_dtype),
            "ssm": ((B, di // P, P, N), torch.float32)}
