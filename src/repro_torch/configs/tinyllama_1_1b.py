"""TinyLlama-1.1B [arXiv:2401.02385] — same config as ``repro.configs``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='tinyllama_1_1b',
    family='dense',
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    head_dim=64,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
