"""The plain reference against the port's CPU path, and the control
against the reference.

On the CPU, at width 8 (32x32 frames, the size the recipe compiles for) and
both bit-widths: the reference's features equal the deployed integer
ensemble's on the same parameters and frames, bit for bit, with a BN gamma
of its own per channel; and the reference on the configuration's control
grid fails the comparison that decides ``correct``. The test marked ``cuda``
holds the same comparison on the card at the configurations' own width.
"""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import check, frames as F
from portbench.reference import resnet9_qat as R
from portbench.systems import resnet9 as S

CONFIGS = ["resnet9-w6a4", "resnet9-w16a16"]


def _cfg(name, width=8):
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg["width"] = width
    return cfg


def _frames(n, seed=0, img=32):
    rng = np.random.default_rng(seed)
    return F.labelled(rng, F.Frames(rng, 4, img), n)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_features_equal_the_ports_cpu_path(name):
    cfg = _cfg(name)
    params = R.init_params(torch.Generator().manual_seed(5), 8, "cpu")
    x, _ = _frames(6)
    x = torch.from_numpy(x)
    feats = S.deploy(cfg, params, torch.device("cpu"))
    got = feats(x)
    want = R.features(params, x, 8, cfg, flip=True)
    assert got.dtype == torch.float32
    assert torch.equal(got.double(), want)
    # the flip ensemble is the sum of both forwards, not one of them
    one = R.features(params, x, 8, cfg, flip=False)
    assert not torch.equal(got.double(), one)


@pytest.mark.parametrize("cell", ["tiny-offline", "tiny16-offline"])
def test_the_control_fails_the_comparison(tiny_root, cell, capsys):
    """The reference one fraction bit coarser on weights and activations,
    in the program's place, is not correct on any of three seeds."""
    from portbench import control

    assert control.main(["--workload", cell, "--seeds", "1,2,3",
                         "--seconds", "1"], stub=True, root=tiny_root) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3 and all(d["fails"] for d in lines)


def test_sound_answers_pass_the_comparison():
    """The comparison itself: the reference's own answers pass it."""
    cfg = _cfg("resnet9-w6a4")
    params = R.init_params(torch.Generator().manual_seed(2), 8, "cpu")
    x, _ = _frames(8, seed=3)
    x = torch.from_numpy(x)
    f = R.features(params, x, 8, cfg)
    assert check.feature_mismatch({0: f.float()}, {0: f},
                                  {"feature_mismatch": 0}).ok


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_features_equal_the_card_at_full_width(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels run on the card")
    cfg = _cfg(name, width=64)
    dev = torch.device("cuda")
    params = R.init_params(torch.Generator(device=dev).manual_seed(9), 64,
                           dev)
    x, _ = _frames(64, seed=4)
    x = torch.from_numpy(x).to(dev)
    feats = S.deploy(cfg, params, dev)
    feats.warmup([64], img=32)
    assert torch.equal(feats(x).double(), R.features(params, x, 64, cfg))


def test_every_cell_resolves_its_files():
    """Each cell of ``BENCHMARK.json`` finds its configuration, mix,
    driver, system, reference and the reader of every per-layer metric it
    reports, and takes one chip."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = ROOT / "portbench"
    confs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1
        cfg = json.loads((ROOT / confs[w["config"]]["file"]).read_text())
        assert (pb / "systems" / f"{cfg['arch']}.py").is_file()
        assert (pb / "reference" / f"{cfg['arch']}_qat.py").is_file()
        mix = json.loads((pb / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (pb / "drivers" / f"{mix['driver']}.py").is_file()
        listed = [m for m in bench["per_layer"]
                  if w["name"] in m.get("workloads", [w["name"]])]
        assert listed
        for m in listed:
            assert (pb / "layer_metrics" / f"{m['name']}.py").is_file()


def test_params_give_each_channel_its_own_table():
    """BN gamma differs between the channels of a layer (so do their
    threshold tables) and is a power of two; the draw is the seed's."""
    a = R.init_params(torch.Generator().manual_seed(3), 8, "cpu")
    b = R.init_params(torch.Generator().manual_seed(3), 8, "cpu")
    for blk in R.plan(8):
        g = a[blk["name"]]["gamma"]
        assert len(set(g.tolist())) > 1
        assert set(g.tolist()) <= {0.5, 1.0, 2.0}
        assert torch.equal(g, b[blk["name"]]["gamma"])
