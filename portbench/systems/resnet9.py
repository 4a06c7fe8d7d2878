"""The system under test for ResNet-9 configurations: the port's deployed
flip ensemble.

``repro_torch.fsl.pipeline.FSLPipeline.deploy`` compiles the ``"resnet9"``
recipe at the configuration's grid and datapath and returns the ensemble's
feature function: one CUDA graph per warmed batch bucket, two backbone
forwards of the batch and their sum. The benchmark hands it the parameters
and frames it made; nothing else of the port is reached from here.
"""

from __future__ import annotations

from typing import Dict

import torch


def quant_config(grid: Dict):
    """The port's ``QuantConfig`` for a configuration's grid: signed
    weights, unsigned activations."""
    from repro_torch.core.quant import FixedPointSpec, QuantConfig

    return QuantConfig(
        weight=FixedPointSpec(grid["weight_bits"], grid["weight_frac"],
                              signed=True),
        act=FixedPointSpec(grid["act_bits"], grid["act_frac"], signed=False))


def deploy(cfg: Dict, params, device: torch.device):
    """The deployed ensemble's feature function, not yet warmed."""
    from repro_torch.fsl.pipeline import FSLPipeline

    pipe = FSLPipeline(width=cfg["width"], qcfg=quant_config(cfg),
                       easy_augment=cfg["flip_ensemble"], device=device)
    return pipe.deploy(params, datapath=cfg["datapath"])


def mvau_launches() -> int:
    """MVAU kernel launches so far in this process, by the port's own
    counter (a graph replay adds the launches it captured)."""
    from repro_torch.kernels import build

    return build.launch_counts["mvau_int"] + build.launch_counts["mvau"]
