"""Qwen1.5-32B — same config as ``repro.configs.qwen1_5_32b``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='qwen1_5_32b',
    family='dense',
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
