"""resnet34 — the paper's own benchmark CNN (Tables 4/5/6), with the
paper's OVSF50 per-stage ratios (1.0, 0.5, 0.5, 0.5) and the Table-3
winning settings (iterative basis drop, 3x3 crop from 4x4); same config as
``repro.configs.resnet34``."""
from repro_torch.models.cnn import CNNConfig

CONFIG = CNNConfig(
    name='resnet34', depth='resnet34', num_classes=1000, in_hw=224,
    ovsf_enable=True, ovsf_mode="spatial", extract="crop",
    strategy="iterative", block_rhos=(1.0, 0.5, 0.5, 0.5),
)

SMOKE_CONFIG = CONFIG.replace(name=CONFIG.name + "_smoke", num_classes=10,
                              in_hw=32, width_mult=0.25)
