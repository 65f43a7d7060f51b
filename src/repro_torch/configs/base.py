"""Config dataclasses and the arch registry (port of ``repro.configs.base``).

Only the fields the ported serving path reads are carried: the dense
family's, the MoE family's (``n_experts``, ``top_k``,
``n_shared_experts``, ``capacity_factor``, ``router_aux_weight``), the SSM
family's (``ssm_state``, ``ssm_conv``, ``ssm_expand``, ``ssm_head_dim``,
``ssm_chunk``, ``mamba_version``), the hybrid's (``attn_every``), the
encoder-decoder's (``encoder_layers``, ``encoder_seq``) and the VLM's
(``vlm_image_tokens``), plus ``ShapeConfig`` and the reference's four
``SHAPES`` (the workload shapes the mapper, the autotuner and the DSE
model), ``ModelConfig.exec_plan`` (the mapper's per-layer plan) and the
reference's arch registry (``ARCHS``, ``PAPER_ARCHS``). ``input_specs``
(a JAX-lowering helper) is not carried.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch

from repro_torch.core.ovsf import validate_alpha_dtype


@dataclasses.dataclass(frozen=True)
class OVSFConfig:
    enable: bool = False
    rho: float = 0.5                      # default OVSF ratio
    # per weight-type overrides, e.g. (("mlp_down", 0.25), ("attn_o", 1.0))
    rho_overrides: tuple[tuple[str, float], ...] = ()
    strategy: str = "iterative"           # sequential | iterative
    exec_path: str = "materialize"        # materialize | fused | spectral
    # Code segment length L0 (16 = the paper's per-channel-pair codes);
    # 0 = monolithic next_pow2(d_in) codes.
    seg_len: int = 16
    min_dim: int = 512                    # skip matrices smaller than this
    targets: tuple[str, ...] = ("attn", "mlp", "expert")
    alpha_dtype: str = ""                 # "" | "int8" | "int4"

    def __post_init__(self):
        validate_alpha_dtype(self.alpha_dtype)
        if self.exec_path not in ("materialize", "fused", "spectral"):
            raise ValueError(
                f"unknown exec_path {self.exec_path!r}; expected "
                "materialize | fused | spectral")

    def rho_for(self, name: str) -> float:
        for pat, r in self.rho_overrides:
            if pat in name:
                return r
        return self.rho


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_gated: bool = True      # SwiGLU; False -> 2-matrix GELU MLP
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64      # mamba2 head size
    ssm_chunk: int = 64         # chunked-scan chunk length
    mamba_version: int = 1
    # --- hybrid (zamba2-style shared attention) ---
    attn_every: int = 0         # the shared attn block after every k SSM blocks
    # --- encoder-decoder (whisper; the audio frontend is a stub) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500     # whisper's 30 s frame count
    # --- VLM (llava; the anyres frontend is a stub) ---
    vlm_image_tokens: int = 0   # leading positions fed by precomputed embeds
    dtype: str = "bfloat16"
    # training: recompute each block's forward in the backward
    # (torch.utils.checkpoint, the reference's jax.checkpoint)
    remat: bool = True
    kv_cache_dtype: str = ""    # "" -> dtype; "int8": static-scale int8 K/V
    ovsf: OVSFConfig = dataclasses.field(default_factory=OVSFConfig)
    # Per-layer execution plan (``runtime.mapper.ExecutionPlan``, frozen and
    # hashable like the config). None -> uniform dispatch by ovsf.exec_path.
    exec_plan: Optional[Any] = None

    def __post_init__(self):
        if self.kv_cache_dtype not in ("", "int8"):
            raise ValueError(f"kv_cache_dtype {self.kv_cache_dtype!r}: the "
                             "port stores K/V in the model dtype ('') or "
                             "int8")

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def kv_dtype(self) -> torch.dtype:
        """The KV cache's storage type."""
        return torch.int8 if self.kv_cache_dtype == "int8" else self.act_dtype

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling (SSM / hybrid)."""
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


ARCHS = (
    "qwen1_5_32b", "qwen2_5_14b", "tinyllama_1_1b", "starcoder2_15b",
    "zamba2_1_2b", "kimi_k2_1t_a32b", "olmoe_1b_7b", "whisper_tiny",
    "falcon_mamba_7b", "llava_next_34b",
)
PAPER_ARCHS = ("resnet18", "resnet34", "resnet50", "squeezenet1_1")

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    """Load ``repro_torch.configs.<name>.CONFIG`` (dashes normalised)."""
    mod_name = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    if hasattr(mod, "SMOKE_CONFIG"):
        return mod.SMOKE_CONFIG
    return smoke_variant(mod.CONFIG)


def smoke_variant(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family config: small widths/layers/experts/vocab."""
    kw: dict[str, Any] = dict(
        name=cfg.name + "_smoke",
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(max(cfg.n_kv_heads, 1), 2) if cfg.n_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab=512,
        dtype="float32",
        remat=False,
    )
    if cfg.n_experts:
        kw.update(n_experts=8, top_k=2, d_ff=64)
    if cfg.ssm_state:
        kw.update(ssm_state=8, ssm_chunk=16, ssm_head_dim=16)
    if cfg.attn_every:
        kw.update(attn_every=2, n_layers=4)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.vlm_image_tokens:
        kw.update(vlm_image_tokens=4)
    if cfg.ovsf.enable:
        kw["ovsf"] = dataclasses.replace(cfg.ovsf, min_dim=32)
    kw.update(overrides)
    return cfg.replace(**kw)
