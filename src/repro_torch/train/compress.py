"""Int8 error-feedback gradient compression (port of
``repro.train.compress``).

The gradient is quantised to int8 with a per-tensor scale before a reduce;
the quantisation residual is kept in an error buffer and added back the
next step (EF-SGD). Trees are the port's (``train.optim.tree_map``); a
``None`` or integer gradient leaf passes through.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.train.optim import tree_leaves, tree_map


def _is_float(t) -> bool:
    return t is not None and t.dtype.is_floating_point


def ef_init(params: Any) -> Any:
    """fp32 zero error buffers: the leaf's shape for float leaves, a scalar
    for the rest."""
    return tree_map(
        lambda _p, p: torch.zeros(p.shape if _is_float(p) else (),
                                  dtype=torch.float32, device=p.device),
        params)


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8 q, fp32 scale) with symmetric per-tensor scaling (round
    half to even, as ``jnp.round``)."""
    gf = g.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Any, err: Any
                           ) -> tuple[Any, Any, Any, float]:
    """Returns (q_tree int8, scale_tree, new_err_tree, bytes_ratio)."""
    def one(_path, g, e):
        if not _is_float(g):
            return g, torch.tensor(1.0), e
        corrected = g.to(torch.float32) + e
        q, s = quantize(corrected)
        return q, s, corrected - dequantize(q, s)

    out = tree_map(one, grads, err)
    qs, ss, es = (tree_map(lambda _p, t, i=i: t[i], out) for i in range(3))
    in_bytes = sum(g.numel() * g.element_size()
                   for g in tree_leaves(grads) if g is not None)
    out_bytes = sum(q.numel() * q.element_size() + 4
                    for q in tree_leaves(qs) if q is not None)
    return qs, ss, es, out_bytes / max(in_bytes, 1)


def decompress(q_tree: Any, scale_tree: Any) -> Any:
    return tree_map(lambda _p, q, s: dequantize(q, s)
                    if q is not None and q.dtype == torch.int8 else q,
                    q_tree, scale_tree)
