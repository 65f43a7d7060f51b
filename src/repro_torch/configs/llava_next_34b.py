"""LLaVA-NeXT-34B language backbone (the anyres vision frontend is a stub:
image features arrive as (B, n_img, d_model) embeddings) — same config as
``repro.configs.llava_next_34b``."""
from repro_torch.configs.base import ModelConfig, OVSFConfig, smoke_variant

CONFIG = ModelConfig(
    name='llava_next_34b',
    family='vlm',
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    vlm_image_tokens=1024,
    ovsf=OVSFConfig(enable=True, rho=0.5, strategy="iterative",
                    exec_path="materialize"),
)

SMOKE_CONFIG = smoke_variant(CONFIG)
