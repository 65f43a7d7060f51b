"""The paper's own benchmark CNNs, ResNet-18/34/50 and SqueezeNet-1.1, with
OVSF-CONV layers (port of ``repro.models.cnn``, inference only).

Two OVSF filter constructions, as in the reference:
 - "matrix":  codes of length L = next_pow2(Cin*K*K) over the (K, K, Cin)
   flattening of a filter, cropped to Cin*K*K rows; the conv runs as an
   im2col GEMM whose weights ``kernels.ops.decompress`` generates (the
   hand-written ``ovsf_decompress`` on the card), then ``torch.matmul``.
 - "spatial": true power-of-two 4x4 filters from codes of length Cin*16,
   then 3x3 extraction by "crop" or "adaptive" pooling (paper Table 3);
   the filters are reconstructed with plain tensor code and fed to
   ``F.conv2d``, as the reference feeds them to ``lax.conv``.

Parameters keep the reference's keys (``w``, ``alphas``, ``idx``, ``meta``,
``scale``, ``bias``; BN running stats in a separate state tree). Dense
filters are held as (Cout, Cin, K, K), PyTorch's layout
(``models.bridge.cnn_params_from_numpy`` maps the reference's HWIO ones);
``alphas`` and ``idx`` are the reference's, indexing the (K, K, Cin)
flattening. Layers run in NCHW; ``cnn_apply`` takes the reference's NHWC
images. ``CNNConfig.exec_plan`` carries the mapper's per-conv plan
(``runtime.mapper.plan_cnn``): an OVSF conv in matrix mode runs the path its
plan names (``spectral`` transforms the patches through the hand-written
``fwht``), and ``materialize`` where the plan has none or no plan is set, as
the reference dispatches. Spatial mode ignores the plan. Training
(``train=True``, ``cnn_loss``) normalises with the batch's statistics and
returns the new running ones; its gradients run through the OVSF kernels'
autograd Functions (``kernels.ops``): ``ovsf_decompress`` and ``fwht`` for
``materialize``, ``ovsf_gemm``, ``ovsf_decompress`` and ``fwht`` for
``fused``, ``fwht`` for ``spectral``.

``CapturedForward`` is the eval-mode ``cnn_apply`` the reference runs
compiled: on the card it replays one CUDA graph per (arch, batch, plan)
over a static image buffer, the same convs, BN/ReLU, im2col and OVSF
kernels the eager forward launches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import ovsf
from repro_torch.kernels import ops as kops
from repro_torch.runtime.graphs import StepGraphs

_K0 = 4                 # spatial mode: 4x4 power-of-two filters


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    depth: str                       # resnet18 | resnet34 | resnet50 | squeezenet
    num_classes: int = 1000
    in_hw: int = 224
    block_rhos: tuple = (1.0, 1.0, 1.0, 1.0)   # per-stage OVSF ratio; 1.0 = dense
    ovsf_enable: bool = False
    ovsf_mode: str = "matrix"        # matrix | spatial
    extract: str = "crop"            # crop | adaptive (spatial mode, Table 3)
    strategy: str = "iterative"      # iterative | sequential (Table 3)
    width_mult: float = 1.0          # reduced smoke variants
    dtype: str = "float32"
    # Hardware-aware per-conv plan (runtime.mapper.ExecutionPlan); None ->
    # uniform materialize dispatch for the im2col GEMMs.
    exec_plan: Optional[object] = None

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "CNNConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# OVSF conv layer
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, cfg: CNNConfig, c_in: int, c_out: int,
              k: int, rho: float, device=None) -> dict:
    """Dense He-init (Cout, Cin, k, k) filters, or OVSF alphas + code ids
    where the reference compresses: ``rho < 1``, ``k >= 3``, ``c_in >= 16``."""
    dtype = cfg.act_dtype
    use_ovsf = cfg.ovsf_enable and rho < 1.0 and k >= 3 and c_in >= 16
    if not use_ovsf:
        std = float(np.sqrt(2.0 / (c_in * k * k)))
        return {"w": torch.randn((c_out, c_in, k, k), generator=gen,
                                 dtype=dtype, device=device) * std}
    spatial = cfg.ovsf_mode == "spatial" and k == 3
    d = c_in * _K0 * _K0 if spatial else c_in * k * k
    spec = ovsf.OVSFSpec(d, c_out, rho=rho, strategy=cfg.strategy)
    p = ovsf.init_ovsf(gen, spec, scale=2.0, dtype=dtype, device=device)
    if spatial:
        p["meta"] = torch.tensor([c_in, _K0], dtype=torch.int32,
                                 device=device)
    return p


def conv_weights(p: dict, cfg: CNNConfig, c_in: int, c_out: int, k: int
                 ) -> torch.Tensor:
    """The layer's (Cout, Cin, k, k) filters, generated from the alphas for
    OVSF layers."""
    if "w" in p:
        return p["w"]
    if "meta" in p:          # spatial: reconstruct K0 x K0, then extract k x k
        wt = ovsf.reconstruct(p["alphas"].t(), p["idx"], c_in * _K0 * _K0)
        w4 = wt.reshape(c_out, c_in, _K0, _K0)
        return ovsf.extract_kxk(w4, k, cfg.extract)
    wflat = kops.decompress(p["alphas"], p["idx"], c_in * k * k)
    return wflat.reshape(k, k, c_in, c_out).permute(3, 2, 0, 1)


def conv_apply(p: dict, cfg: CNNConfig, x: torch.Tensor, c_out: int, k: int,
               stride: int = 1, name: str = "") -> torch.Tensor:
    """NCHW conv with symmetric padding k // 2. OVSF layers in matrix mode
    run im2col + an OVSF GEMM by the path of ``cfg.exec_plan``'s plan for
    ``name`` (``materialize`` without one); the others convolve with their
    (reconstructed) filters."""
    c_in = x.shape[1]
    pad = k // 2
    if "alphas" in p and "meta" not in p:
        B = x.shape[0]
        cols = F.unfold(x, k, padding=pad, stride=stride)   # (B, Cin*k*k, R)
        R = cols.shape[-1]
        Ho = (x.shape[2] + 2 * pad - k) // stride + 1
        # F.unfold emits channel-major (Cin, k, k) rows; the alphas were
        # built over the (k, k, Cin) flattening, so the patches follow it
        pt = (cols.reshape(B, c_in, k * k, R).permute(0, 3, 2, 1)
              .reshape(B * R, k * k * c_in))
        plan = (cfg.exec_plan.plan_for(name)
                if cfg.exec_plan is not None and name else None)
        y = kops.ovsf_matmul(pt, p["alphas"], p["idx"], path="materialize",
                             plan=plan)
        return y.reshape(B, Ho, R // Ho, c_out).permute(0, 3, 1, 2)
    w = conv_weights(p, cfg, c_in, c_out, k)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad)


def bn_init(c: int, dtype, device=None) -> tuple[dict, dict]:
    return ({"scale": torch.ones((c,), dtype=dtype, device=device),
             "bias": torch.zeros((c,), dtype=dtype, device=device)},
            {"mean": torch.zeros((c,), dtype=torch.float32, device=device),
             "var": torch.ones((c,), dtype=torch.float32, device=device)})


def bn_apply(p: dict, st: dict, x: torch.Tensor, train: bool = False,
             momentum: float = 0.9) -> tuple[torch.Tensor, dict]:
    """BatchNorm over NCHW channels, computed in float32 and cast back;
    returns (y, state) like the reference. ``train`` normalises with the
    batch's mean and biased variance over N, H, W and returns the running
    statistics moved toward them by ``1 - momentum`` (detached: no gradient
    flows into the state); otherwise the running statistics normalise and
    the state is returned as it is."""
    c = (-1, 1, 1)
    xf = x.float()
    if train:
        mu = torch.mean(xf, dim=(0, 2, 3))
        var = torch.var(xf, dim=(0, 2, 3), correction=0)
        new_st = {"mean": (momentum * st["mean"]
                           + (1 - momentum) * mu).detach(),
                  "var": (momentum * st["var"]
                          + (1 - momentum) * var).detach()}
    else:
        mu, var, new_st = st["mean"], st["var"], st
    y = (xf - mu.view(c)) * torch.rsqrt(var.view(c) + 1e-5)
    y = y * p["scale"].float().view(c) + p["bias"].float().view(c)
    return y.to(x.dtype), new_st


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2
                  ) -> torch.Tensor:
    """Max-pool with XLA's SAME padding, as ``lax.reduce_window(...,
    "SAME")``: per axis ceil(n / stride) outputs, the padding split low
    total // 2 and high the rest (112 -> 56 pads (0, 1)), padded with -inf."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):        # F.pad takes the last dim first
        total = max((-(-n // stride) - 1) * stride + window - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), window, stride)


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------

_RESNET_DEF = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
}
_STAGE_CH = (64, 128, 256, 512)


def _resnet_layers(cfg: CNNConfig) -> list[dict]:
    """Static layer plan: list of conv descriptors with stage-indexed rho."""
    kind, blocks = _RESNET_DEF[cfg.depth]
    wm = cfg.width_mult
    ch = [max(8, int(c * wm)) for c in _STAGE_CH]
    plan = []
    c_prev = max(8, int(64 * wm))
    plan.append(dict(name="stem", c_in=3, c_out=c_prev, k=7, stride=2, rho=1.0))
    for s, nb in enumerate(blocks):
        c = ch[s]
        rho = cfg.block_rhos[s]
        for b in range(nb):
            stride = 2 if (s > 0 and b == 0) else 1
            if kind == "basic":
                plan.append(dict(name=f"s{s}b{b}c1", c_in=c_prev, c_out=c,
                                 k=3, stride=stride, rho=rho))
                plan.append(dict(name=f"s{s}b{b}c2", c_in=c, c_out=c,
                                 k=3, stride=1, rho=rho))
                if (c_prev != c) or stride != 1:
                    plan.append(dict(name=f"s{s}b{b}proj", c_in=c_prev,
                                     c_out=c, k=1, stride=stride, rho=1.0))
                c_prev = c
            else:
                cm, co = c, c * 4
                plan.append(dict(name=f"s{s}b{b}c1", c_in=c_prev, c_out=cm,
                                 k=1, stride=1, rho=1.0))
                plan.append(dict(name=f"s{s}b{b}c2", c_in=cm, c_out=cm,
                                 k=3, stride=stride, rho=rho))
                plan.append(dict(name=f"s{s}b{b}c3", c_in=cm, c_out=co,
                                 k=1, stride=1, rho=1.0))
                if (c_prev != co) or stride != 1:
                    plan.append(dict(name=f"s{s}b{b}proj", c_in=c_prev,
                                     c_out=co, k=1, stride=stride, rho=1.0))
                c_prev = co
    plan.append(dict(name="head", c_in=c_prev, c_out=cfg.num_classes,
                     k=0, stride=0, rho=1.0))
    return plan


def resnet_init(cfg: CNNConfig, gen: torch.Generator, device
                ) -> tuple[dict, dict]:
    params: dict = {}
    state: dict = {}
    for d in _resnet_layers(cfg):
        if d["name"] == "head":
            std = float(np.sqrt(1.0 / d["c_in"]))
            params["head"] = {
                "w": torch.randn((d["c_in"], d["c_out"]), generator=gen,
                                 dtype=cfg.act_dtype, device=device) * std,
                "b": torch.zeros((d["c_out"],), dtype=cfg.act_dtype,
                                 device=device)}
            continue
        params[d["name"]] = conv_init(gen, cfg, d["c_in"], d["c_out"],
                                      d["k"], d["rho"], device)
        params[d["name"] + "_bn"], state[d["name"] + "_bn"] = bn_init(
            d["c_out"], cfg.act_dtype, device)
    return params, state


def resnet_apply(params: dict, state: dict, cfg: CNNConfig, x: torch.Tensor,
                 train: bool = False) -> tuple[torch.Tensor, dict]:
    """x: (B, H, W, 3) NHWC -> (logits, bn_state)."""
    plan = {d["name"]: d for d in _resnet_layers(cfg)}
    kind, blocks = _RESNET_DEF[cfg.depth]
    new_state: dict = {}

    def conv_bn(name, h, relu=True):
        d = plan[name]
        y = conv_apply(params[name], cfg, h, d["c_out"], d["k"], d["stride"],
                       name=name)
        y, new_state[name + "_bn"] = bn_apply(params[name + "_bn"],
                                              state[name + "_bn"], y, train)
        return F.relu(y) if relu else y

    y = max_pool_same(conv_bn("stem", x.permute(0, 3, 1, 2)))
    for s, nb in enumerate(blocks):
        for b in range(nb):
            pre = f"s{s}b{b}"
            if kind == "basic":
                h = conv_bn(pre + "c2", conv_bn(pre + "c1", y), relu=False)
            else:
                h = conv_bn(pre + "c2", conv_bn(pre + "c1", y))
                h = conv_bn(pre + "c3", h, relu=False)
            resid = (conv_bn(pre + "proj", y, relu=False)
                     if pre + "proj" in params else y)
            y = F.relu(h + resid)
    y = y.mean(dim=(2, 3))
    logits = y @ params["head"]["w"].to(y.dtype) + params["head"]["b"]
    return logits, new_state


# ---------------------------------------------------------------------------
# SqueezeNet 1.1 (fire modules; OVSF on the 3x3 expand convs)
# ---------------------------------------------------------------------------

_FIRE = [  # (squeeze, expand1x1, expand3x3, stage)
    (16, 64, 64, 0), (16, 64, 64, 0),
    (32, 128, 128, 1), (32, 128, 128, 1),
    (48, 192, 192, 2), (48, 192, 192, 2),
    (64, 256, 256, 3), (64, 256, 256, 3),
]
_POOL_AFTER = (1, 3)


def _fire_widths(cfg: CNNConfig):
    wm = cfg.width_mult
    for sq, e1, e3, stage in _FIRE:
        yield (*(max(4, int(v * wm)) for v in (sq, e1, e3)), stage)


def squeezenet_init(cfg: CNNConfig, gen: torch.Generator, device
                    ) -> tuple[dict, dict]:
    params: dict = {}
    state: dict = {}
    c_prev = max(8, int(64 * cfg.width_mult))
    params["stem"] = conv_init(gen, cfg, 3, c_prev, 3, 1.0, device)
    params["stem_bn"], state["stem_bn"] = bn_init(c_prev, cfg.act_dtype,
                                                  device)
    for i, (sq, e1, e3, stage) in enumerate(_fire_widths(cfg)):
        rho = cfg.block_rhos[stage]
        params[f"f{i}s"] = conv_init(gen, cfg, c_prev, sq, 1, 1.0, device)
        params[f"f{i}e1"] = conv_init(gen, cfg, sq, e1, 1, 1.0, device)
        params[f"f{i}e3"] = conv_init(gen, cfg, sq, e3, 3, rho, device)
        c_prev = e1 + e3
    params["head_conv"] = conv_init(gen, cfg, c_prev, cfg.num_classes, 1, 1.0,
                                    device)
    return params, state


def squeezenet_apply(params: dict, state: dict, cfg: CNNConfig,
                     x: torch.Tensor, train: bool = False
                     ) -> tuple[torch.Tensor, dict]:
    """x: (B, H, W, 3) NHWC -> (logits, bn_state)."""
    y = conv_apply(params["stem"], cfg, x.permute(0, 3, 1, 2),
                   max(8, int(64 * cfg.width_mult)), 3, 2)
    y, st = bn_apply(params["stem_bn"], state["stem_bn"], y, train)
    y = max_pool_same(F.relu(y))
    for i, (sq, e1, e3, _stage) in enumerate(_fire_widths(cfg)):
        s = F.relu(conv_apply(params[f"f{i}s"], cfg, y, sq, 1))
        a = F.relu(conv_apply(params[f"f{i}e1"], cfg, s, e1, 1))
        b = F.relu(conv_apply(params[f"f{i}e3"], cfg, s, e3, 3,
                              name=f"f{i}e3"))
        y = torch.cat([a, b], dim=1)
        if i in _POOL_AFTER:
            y = max_pool_same(y)
    y = conv_apply(params["head_conv"], cfg, y, cfg.num_classes, 1)
    return y.mean(dim=(2, 3)), {"stem_bn": st}


def cnn_init(cfg: CNNConfig, seed: int = 0, device="cuda"
             ) -> tuple[dict, dict]:
    """Random (params, bn_state) of the reference's keys, shapes and init
    statistics, drawn from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (not the reference's numbers; ``models.bridge`` carries
    those over)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.depth == "squeezenet":
        return squeezenet_init(cfg, gen, dev)
    return resnet_init(cfg, gen, dev)


def cnn_apply(params: dict, state: dict, cfg: CNNConfig, x: torch.Tensor,
              train: bool = False) -> tuple[torch.Tensor, dict]:
    """(B, H, W, 3) NHWC images -> ((B, num_classes) logits, bn_state)."""
    if cfg.depth == "squeezenet":
        return squeezenet_apply(params, state, cfg, x, train)
    return resnet_apply(params, state, cfg, x, train)


class CapturedForward:
    """Eval-mode ``cnn_apply(params, state, cfg, images)[0]`` as one CUDA
    graph per (arch, batch, plan): ``images`` (B, H, W, 3) is copied into
    the batch's static buffer and the graph replayed (the first call of a
    batch runs eagerly and captures it, ``runtime.graphs``). Returns the
    static (B, num_classes) logits, which only the next call of that batch
    overwrites (each batch's graph has a memory pool of its own). On the
    CPU the forward runs eagerly through the same buffer. A graph holds the
    params' addresses: build a new object for new params or another plan."""

    def __init__(self, params: dict, state: dict, cfg: CNNConfig):
        self.params, self.state, self.cfg = params, state, cfg
        device = next(t.device for p in params.values() for t in p.values())
        self.graphs = StepGraphs(device)
        plan = cfg.exec_plan
        self._plan = (None if plan is None
                      else tuple((n, lp.path) for n, lp in plan.entries))

    def key(self, batch: int) -> tuple:
        return (self.cfg.name, self.cfg.ovsf_mode, batch, self._plan)

    @torch.no_grad()
    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        (logits,) = self.graphs.run(self.key(images.shape[0]),
                                    {"images": images}, self._body)
        return logits

    def _body(self, bufs: dict) -> tuple:
        return (cnn_apply(self.params, self.state, self.cfg,
                          bufs["images"])[0],)


def cnn_loss(params: dict, state: dict, cfg: CNNConfig, x: torch.Tensor,
             labels: torch.Tensor, train: bool = True
             ) -> tuple[torch.Tensor, tuple[dict, torch.Tensor]]:
    """Mean softmax cross entropy of (B, H, W, 3) NHWC images against (B,)
    integer labels, in fp32: (loss, (new bn_state, logits)), as the
    reference."""
    logits, new_state = cnn_apply(params, state, cfg, x, train)
    lg = logits.to(torch.float32)
    nll = torch.logsumexp(lg, dim=-1) - torch.gather(
        lg, -1, labels.long()[:, None])[:, 0]
    return torch.mean(nll), (new_state, logits)
