"""AdamW with fp32 master state and LR schedules (port of
``repro.train.optim``).

Trees are the port's param trees: nested dicts of tensors whose ``blocks``
(and an encoder's ``blocks``) are lists of per-layer dicts. A leaf's path is
the reference's: dict keys joined by "/", list positions left out, as the
reference holds each list as one stacked leaf ("blocks/attn/q/alphas"), so
``_decay_mask`` decides every leaf as the reference does. Gradients follow
the params' structure with ``None`` where a leaf has no gradient (the
integer code ids; the reference's ``float0``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"     # cosine | linear | constant


def tree_map(fn: Callable, *trees, path: str = "") -> Any:
    """``fn(path, *leaves)`` over trees of one structure (dicts and lists
    are containers; anything else, ``None`` and tuples included, is a
    leaf), rebuilt with the results; ``path`` is the reference's path of
    the leaf (module docstring)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees),
                            path=f"{path}/{k}" if path else str(k))
                for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *(t[i] for t in trees), path=path)
                for i in range(len(t0))]
    return fn(path, *trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree in ``tree_map``'s order, ``None`` included."""
    out: list = []
    tree_map(lambda _p, x: out.append(x), tree)
    return out


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The schedule's fp32 learning rate at ``step`` (a tensor)."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def adamw_init(params: Any) -> dict:
    """fp32 zero ``m`` and ``v`` for every leaf, the integer code ids
    included (as the reference makes them), and an int32 step counter on
    the params' device."""
    def zeros32(_path, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros32, params), "v": tree_map(zeros32, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _decay_mask(path: str) -> bool:
    """Weight decay on matrices only (not norms/biases/idx); ``path`` is
    the reference's "/"-joined leaf path."""
    return not any(t in path for t in ("scale", "bias", "/b", "norm", "idx",
                                       "A_log", "dt_bias", "/D"))


def global_norm(tree: Any) -> torch.Tensor:
    """fp32 L2 norm over every leaf that has a value."""
    sq = [torch.sum(torch.square(x.to(torch.float32)))
          for x in tree_leaves(tree) if x is not None]
    return torch.sqrt(sum(sq))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads: Any, opt: dict, params: Any
                 ) -> tuple[Any, dict, dict]:
    """Returns (new_params, new_opt, metrics). Integer leaves (and leaves
    without a gradient) keep their value and their ``m`` / ``v``; every
    other update is computed in fp32 and cast back to the param's type."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)

    def one(path, g, m, v, p):
        if not p.dtype.is_floating_point or g is None:
            return p, m, v
        gf = g.to(torch.float32) * scale
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * upd).to(p.dtype), m2, v2

    out = tree_map(one, grads, opt["m"], opt["v"], params)

    def pick(i):
        return tree_map(lambda _p, t: t[i], out)
    metrics = {"lr": lr, "grad_norm": gnorm, "step": step}
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, metrics
