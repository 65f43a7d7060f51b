"""StarCoder2-15B, dense with a GELU MLP — same config as
``repro.configs.starcoder2_15b``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='starcoder2_15b',
    family='dense',
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    mlp_gated=False,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
