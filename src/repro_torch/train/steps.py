"""Train, eval, prefill and decode steps over one device (port of
``repro.train.steps``).

``make_train_step`` returns ``(state, batch) -> (state, metrics)``: the
loss (``models.registry.loss_fn``), its gradients by autograd through the
OVSF kernels' ``torch.autograd.Function``s (``kernels.ops``), and one AdamW
update (``train.optim``). The state is ``{"params", "opt": {"m", "v",
"step"}}``; integer leaves (the code ids) get no gradient, as the
reference's ``allow_int``. Every step runs ``cfg`` as given on every
device, as the reference's steps do (they plan nothing): each OVSF layer
by ``cfg.ovsf.exec_path``, ``materialize`` for every LM config (W from the
``ovsf_decompress`` kernel on the card, then one product), or by the plan
a caller applied (``mapper.apply_plan``: ``cfg.exec_plan``). Every family
trains (the MoE aux, the SSM and hybrid scans, the encoder over
``frames``, the VLM's ``image_embeds``: ``models.transformer``); MoE's
expert banks regenerate their W as plain tensor code under every plan, as
the reference's do. Int8 / int4 alphas train their fp32 per-segment scales
(``alpha_scale``) through the kernels' quantised paths (``kernels.ops``);
the integer alphas, like the code ids, get no gradient and stay as they
are. Quantised expert banks are refused, as the reference refuses them.

The reference's ``jit_train_step`` / ``jit_decode_step`` / ``jit_prefill``
wrap these functions with explicit shardings over a device mesh; a single
card has no counterpart, so they are not ported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.train import optim


def train_state_init(cfg: ModelConfig, seed: int = 0, device="cuda"
                     ) -> dict:
    """``{"params", "opt"}``: ``models.registry.model_init`` and AdamW's
    zero state on ``device``."""
    T.check_trainable(cfg)
    params = R.model_init(cfg, seed, resolve_device(device))
    return {"params": params, "opt": optim.adamw_init(params)}


def _on(batch: dict, device) -> dict:
    """The batch's arrays (``tokens``, and an encoder-decoder's ``frames``
    or a VLM's ``image_embeds``) as tensors on ``device``."""
    return {k: (v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v))).to(device)
            for k, v in batch.items()}


def _first_device(tree) -> torch.device:
    return optim.tree_leaves(tree)[0].device


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict
                   ) -> tuple[torch.Tensor, dict, Any]:
    """(total loss, {"loss", "aux"}, grads) of ``loss_fn`` at ``params``
    (a batch already on their device): gradients of every float leaf by
    autograd (zeros for a leaf the loss does not reach), ``None`` for the
    integer ones."""
    live = optim.tree_map(
        lambda _p, t: (t.detach().requires_grad_()
                       if t.is_floating_point() else t), params)
    total, aux_metrics = R.loss_fn(live, cfg, batch)
    wrt = [t for t in optim.tree_leaves(live) if t.requires_grad]
    got = iter(torch.autograd.grad(total, wrt, allow_unused=True))

    def grad_of(_p, t):
        if not t.requires_grad:
            return None
        g = next(got)
        return torch.zeros_like(t) if g is None else g
    return (total.detach(), {k: v.detach() for k, v in aux_metrics.items()},
            optim.tree_map(grad_of, live))


def make_train_step(cfg: ModelConfig, ocfg: optim.OptConfig):
    """``(state, batch) -> (state, metrics)``; metrics are 0-d tensors:
    ``total_loss``, ``loss``, ``aux``, ``lr``, ``grad_norm``, ``step``."""
    T.check_trainable(cfg)

    def step(state: dict, batch: dict):
        params = state["params"]
        b = _on(batch, _first_device(params))
        total, aux_metrics, grads = loss_and_grads(cfg, params, b)
        new_params, new_opt, m = optim.adamw_update(ocfg, grads,
                                                    state["opt"], params)
        return ({"params": new_params, "opt": new_opt},
                {"total_loss": total, **aux_metrics, **m})

    return step


def make_eval_step(cfg: ModelConfig):
    """``(params, batch) -> {"total_loss", "loss", "aux"}``, no gradient."""
    T.check_trainable(cfg)

    @torch.no_grad()
    def step(params: dict, batch: dict):
        loss, metrics = R.loss_fn(params, cfg,
                                  _on(batch, _first_device(params)))
        return {"total_loss": loss, **metrics}
    return step


def make_prefill(cfg: ModelConfig, buffer_len: int):
    """``(params, batch) -> (logits, cache)``: ``serve_prefill`` of the
    batch's ``tokens`` (and ``frames`` / ``image_embeds`` where present)."""
    @torch.no_grad()
    def prefill(params: dict, batch: dict):
        b = _on(batch, _first_device(params))
        return R.serve_prefill(params, cfg, b["tokens"], buffer_len,
                               frames=b.get("frames"),
                               image_embeds=b.get("image_embeds"))
    return prefill


def make_decode_step(cfg: ModelConfig):
    """``(params, cache, tokens) -> (logits, cache)``: one ``serve_step``."""
    @torch.no_grad()
    def step(params: dict, cache: dict, tokens: Any):
        tok = _on({"tokens": tokens}, _first_device(params))["tokens"]
        return R.serve_step(params, cfg, cache, tok)
    return step
