"""OLMoE-1B-7B, MoE 64 experts top-8 — same config as
``repro.configs.olmoe_1b_7b``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='olmoe_1b_7b',
    family='moe',
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    n_experts=64,
    top_k=8,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
