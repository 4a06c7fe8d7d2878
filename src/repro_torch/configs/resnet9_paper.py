"""ResNet-9 — the paper's own backbone (PEFSL/EASY, CIFAR/MiniImageNet 32x32).

Not an LM config; registered for the FSL pipeline, benchmarks and examples.
Width/quant defaults follow the paper's deployment point (w6a4).
"""
from repro_torch.core.quant import QuantConfig
from repro_torch.models.common import ArchConfig, register

WIDTH = 64            # paper-scale; tests/benchmarks pass reduced widths
QUANT = QuantConfig.paper_w6a4()
QUANT_16 = QuantConfig.paper_w16a16()

CONFIG = register(ArchConfig(
    name="resnet9-paper", family="cnn",
    n_layers=9, d_model=8 * WIDTH, vocab=0,
    quant=QUANT,
))
