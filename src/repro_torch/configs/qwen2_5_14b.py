"""Qwen2.5-14B — same config as ``repro.configs.qwen2_5_14b``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='qwen2_5_14b',
    family='dense',
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
