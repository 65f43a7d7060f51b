"""Carry parameters between the reference's pytree and the port.

The reference's params arrive as nested dicts of numpy arrays (e.g.
``jax.tree_util.tree_map(np.asarray, params)``) with ``blocks`` stacked
along a leading layer axis; the port keeps the same key names (``alphas`` /
``alphas_q8`` / ``alphas_q4`` + ``alpha_scale``, ``idx``, ``w``, ``b``,
``scale``, ``table``) and holds ``blocks`` as a list of per-layer dicts.
A multi-model tree (the reference's ``serving.model_registry.VariantSet``)
carries its alpha leaves as ``(n_layers, M, ...)``, the variant axis after
the layer axis: splitting axis 0 gives each layer its ``(M, ...)`` stacked
bank, the layout of the port's ``stack_variants``. A MoE tree splits
the same way: ``moe.router.w`` (n_layers, d, E), each expert bank's
``alphas`` (n_layers, E, J, d_out) and its shared ``idx`` (n_layers, ns,
nk), a shared expert's linears as any linear's. An SSM or hybrid tree
splits the same way: each layer's ``mamba`` dict (``in_proj`` /
``out_proj``, OVSF or dense, the dense ``x_proj``, ``dt_proj`` {w, b},
``conv_w`` / ``conv_b``, ``A_log``, ``D`` and, Mamba-2, ``dt_bias`` and
``norm``); the hybrid's ``shared_attn`` block is one unstacked attention +
MLP block, carried as ``embed`` is. An encoder-decoder tree's decoder
layers carry ``norm_x`` and the dense ``cross`` linears beside their own,
split as the rest of the layer; its ``encoder`` holds a second stacked
``blocks`` (``encoder_layers`` deep) and its ``norm``: ``encoder.blocks``
becomes a list of per-layer dicts as the top-level one does. The CNNs'
``(params, bn_state)`` trees (``cnn_params_from_numpy`` /
``cnn_params_to_numpy``) are flat dicts of layer dicts; only their conv
filters change layout (HWIO in the reference, OIHW in the port). A train
state (``state_from_numpy`` / ``state_to_numpy``) carries ``params``, the
optimizer's ``m`` and ``v`` (trees of the params' structure, fp32) and its
``step``. Nothing here imports JAX: numpy is the interchange format.

Float leaves take the model dtype, except those the reference holds in
float32 whatever the model dtype is (``_FLOAT32_KEYS``: the per-segment
``alpha_scale`` of quantised alphas, ``core.ovsf.quantize_alphas``, and the
Mamba blocks' ``A_log``, ``D`` and ``dt_bias``, ``models.ssm``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

_FLOAT32_KEYS = frozenset({"alpha_scale", "A_log", "D", "dt_bias"})


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind in "iub":
        return torch.tensor(a, device=device)
    # bfloat16 numpy arrays (ml_dtypes) have no torch counterpart to view
    # as; widening to float32 is exact for every float type here
    return torch.tensor(a.astype(np.float32), device=device, dtype=dtype)


def _convert(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, torch.float32 if k in _FLOAT32_KEYS else dtype,
                            device) for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def _split_layers(stacked, n: int) -> list:
    """A tree of stacked (n, ...) leaves -> a list of n per-layer trees."""
    def layer(sub, i):
        if isinstance(sub, dict):
            return {k: layer(v, i) for k, v in sub.items()}
        return sub[i]
    return [layer(stacked, i) for i in range(n)]


def params_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """Reference param tree (numpy leaves, stacked ``blocks``, and an
    encoder-decoder's stacked ``encoder.blocks``) -> the port's params on
    ``device``: float leaves in ``cfg.act_dtype`` (``alpha_scale`` in
    float32), integer leaves (code ids, quantised alphas) as they are."""
    out = {k: _convert(v, cfg.act_dtype, device) for k, v in tree.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = _split_layers(_convert(tree["blocks"], cfg.act_dtype,
                                           device), cfg.n_layers)
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "blocks": _split_layers(_convert(enc["blocks"], cfg.act_dtype,
                                             device), cfg.encoder_layers),
            "norm": _convert(enc["norm"], cfg.act_dtype, device)}
    return out


def params_to_numpy(params: dict) -> dict:
    """The port's params -> the reference's layout (numpy leaves, ``blocks``
    and ``encoder.blocks`` stacked along a leading layer axis; bfloat16
    widened to float32)."""
    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def conv(tree):
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return leaf(tree)

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([lay[k] for lay in layers]) for k in layers[0]}
        return np.stack([leaf(t) for t in layers])

    out = {k: conv(v) for k, v in params.items()
           if k not in ("blocks", "encoder")}
    out["blocks"] = stack(params["blocks"])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"blocks": stack(enc["blocks"]),
                          "norm": conv(enc["norm"])}
    return out


def state_from_numpy(tree: dict, cfg: ModelConfig, device) -> dict:
    """The reference's train state (``{"params", "opt": {"m", "v",
    "step"}}``, numpy leaves) -> the port's on ``device``: params as
    ``params_from_numpy``; ``m`` and ``v`` fp32 in every leaf (the code
    ids' too, as the reference holds them), split by layer the same way;
    ``step`` an int32 0-d tensor."""
    f32 = cfg.replace(dtype="float32")
    opt = tree["opt"]
    return {"params": params_from_numpy(tree["params"], cfg, device),
            "opt": {"m": params_from_numpy(opt["m"], f32, device),
                    "v": params_from_numpy(opt["v"], f32, device),
                    "step": torch.tensor(np.asarray(opt["step"]),
                                         dtype=torch.int32, device=device)}}


def state_to_numpy(state: dict) -> dict:
    """The port's train state -> the reference's layout (numpy leaves,
    stacked ``blocks``; bfloat16 params widened to float32)."""
    opt = state["opt"]
    return {"params": params_to_numpy(state["params"]),
            "opt": {"m": params_to_numpy(opt["m"]),
                    "v": params_to_numpy(opt["v"]),
                    "step": opt["step"].detach().cpu().numpy()}}


# ---------------------------------------------------------------------------
# CNNs (``models.cnn``): (params, bn_state) trees of flat layer dicts
# ---------------------------------------------------------------------------

def _conv_leaf(key: str, a, dtype, device) -> torch.Tensor:
    t = _tensor(a, dtype, device)
    if key == "w" and t.dim() == 4:        # HWIO (k, k, Cin, Cout) -> OIHW
        t = t.permute(3, 2, 0, 1).contiguous()
    return t


def cnn_params_from_numpy(params: dict, state: dict, cfg, device
                          ) -> tuple[dict, dict]:
    """The reference's CNN ``(params, bn_state)`` (numpy leaves) -> the
    port's on ``device``: conv filters ``w`` from HWIO (k, k, Cin, Cout) to
    (Cout, Cin, k, k), float leaves in ``cfg.act_dtype``, the BN running
    statistics in float32; ``alphas``, ``idx`` and ``meta`` keep their
    layout (the alphas index the (k, k, Cin) flattening)."""
    out = {name: {k: _conv_leaf(k, v, cfg.act_dtype, device)
                  for k, v in layer.items()} for name, layer in params.items()}
    return out, _convert(state, torch.float32, device)


def cnn_params_to_numpy(params: dict, state: dict) -> tuple[dict, dict]:
    """The port's CNN ``(params, bn_state)`` -> the reference's layout
    (numpy leaves, conv filters HWIO; bfloat16 widened to float32)."""
    def leaf(key, t):
        t = t.detach().cpu()
        if key == "w" and t.dim() == 4:
            t = t.permute(2, 3, 1, 0)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def conv(tree):
        return {name: {k: leaf(k, v) for k, v in layer.items()}
                for name, layer in tree.items()}

    return conv(params), conv(state)
