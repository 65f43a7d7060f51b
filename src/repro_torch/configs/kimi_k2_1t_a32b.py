"""Kimi-K2 1T-A32B, MoE 384 experts top-8 and one shared expert — same
config as ``repro.configs.kimi_k2_1t_a32b``. No single card holds it: the
port runs it at smoke width only."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='kimi_k2_1t_a32b',
    family='moe',
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
