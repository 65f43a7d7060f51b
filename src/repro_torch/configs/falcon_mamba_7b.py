"""Falcon-Mamba-7B, attention-free Mamba-1 — same config as
``repro.configs.falcon_mamba_7b``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='falcon_mamba_7b',
    family='ssm',
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    ssm_state=16,
    ssm_expand=2,
    mamba_version=1,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
