"""The frozen counts: operations and bytes of each MVAU, the peaks, the
union of busy intervals."""

import json

import pytest
import torch

from conftest import ROOT
from portbench import counts
from portbench.reference import resnet9_qat as R


def _cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_operations_per_frame_of_plan_64_are_pinned():
    cfg = _cfg("resnet9-w6a4")
    macs = [layer["m"] * layer["k"] * layer["n"]
            for layer in counts.mvau_layers(cfg)]
    assert macs == [1_769_472, 75_497_472, 37_748_736, 37_748_736,
                    75_497_472, 75_497_472, 37_748_736, 37_748_736]
    assert sum(macs) == 379_256_832
    assert counts.ops_per_frame(cfg) == 4 * 379_256_832    # 2 ops, 2 flips
    assert counts.ops_per_frame(dict(cfg, flip_ensemble=False)) == \
        2 * 379_256_832


def test_both_bit_widths_count_the_same_operations():
    lo, hi = _cfg("resnet9-w6a4"), _cfg("resnet9-w16a16")
    assert counts.ops_per_frame(lo) == counts.ops_per_frame(hi)
    assert [x["ops"] for x in counts.mvau_layers(lo)] == \
        [x["ops"] for x in counts.mvau_layers(hi)]
    # the wide codes cost bytes, never operations
    assert counts.mvau_bound_s(hi, 64) > counts.mvau_bound_s(lo, 64)


def test_bytes_follow_the_storage_widths():
    layers = {x["name"]: x for x in counts.mvau_layers(_cfg("resnet9-w16a16"))}
    c2, c3 = layers["c2"], layers["c3"]
    # c2 reads the 17-bit residual sum as int32 codes; 16 x 16 x 128 of them
    assert c2["in_bytes"] == 16 * 16 * 128 * 4
    assert c3["in_bytes"] == 8 * 8 * 256 * 2
    # the quantizer is charged its affine, not a table of 65,535 levels
    assert c3["a_bytes"] == 512 * 8
    assert layers["r2b"]["out_bytes"] == 512 * 4           # float features
    assert [counts.code_bytes(b) for b in (4, 6, 8, 9, 16, 17)] == \
        [1, 1, 1, 2, 2, 4]


@pytest.mark.parametrize("name", ["resnet9-w6a4", "resnet9-w16a16"])
def test_shapes_match_the_ports_compiled_graph(name):
    """The port's deployed graph has the MVAUs the counts assume: the
    same (K, N) weights in the same order (width 8 on the CPU)."""
    from portbench.systems import resnet9 as S

    cfg = dict(_cfg(name), width=8)
    params = R.init_params(torch.Generator().manual_seed(0), 8, "cpu")
    dm = S.deploy(cfg, params, torch.device("cpu")).deployed_model
    g = dm.graph
    got = [tuple(g.initializers[n.inputs[1]].shape) for n in g.nodes
           if n.op == "mvau_int"]
    assert got == [(x["k"], x["n"]) for x in counts.mvau_layers(cfg)]


def test_union_counts_overlaps_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (2.5, 2.6)]
    assert counts.union_seconds(iv) == pytest.approx(4.0)
    assert counts.union_seconds([]) == 0.0
    assert counts.union_seconds([(1.0, 2.0), (2.0, 4.0)]) == 3.0
    assert counts.gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]


def test_peaks_are_the_h100_data_sheet():
    assert counts.PEAK_INT8_OPS == 1979e12
    assert counts.PEAK_HBM_BYTES == 3.35e12
