"""Whisper-tiny encoder-decoder backbone (the conv audio frontend is a
stub: frames arrive as (B, Tf, d_model) embeddings) — same config as
``repro.configs.whisper_tiny``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='whisper_tiny',
    family='encdec',
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    encoder_layers=4,
    encoder_seq=1500,
    mlp_gated=False,
    tie_embeddings=True,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
