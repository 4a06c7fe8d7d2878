"""The port's whole slice against the JAX reference: ``compile()`` of the
paper's w6a4 ResNet-9 (``datapath="int"`` and ``"f32"``) on parameters
carried across as numpy arrays gives the JAX artifact's features bit for
bit with the same dtype, the same weight bytes and the same dispatch
table; inside the port, compiled int == compiled f32 == interpreter."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import quant as JQ  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.core.graph import execute  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402

WIDTH = 8
JCFG, TCFG = JQ.QuantConfig.paper_w6a4(), TQ.QuantConfig.paper_w6a4()


@pytest.fixture(scope="module")
def setup():
    pj = JR.init_params(jax.random.PRNGKey(0), WIDTH)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    x = np.random.default_rng(1).random((3, 32, 32, 3)).astype(np.float32)
    xq = np.asarray(JQ.fake_quant(jnp.asarray(x), JCFG.act))
    arts = {}
    for dp in ("int", "f32"):
        arts[dp] = (repro.compile(pj, JCFG, recipe="resnet9", datapath=dp),
                    repro_torch.compile(pt, TCFG, recipe="resnet9",
                                        datapath=dp, device="cpu"))
    return pj, pt, x, xq, arts


@pytest.mark.parametrize("datapath", ["int", "f32"])
def test_features_bitforbit_with_reference(setup, datapath):
    _, _, x, xq, arts = setup
    dj, dt = arts[datapath]
    xin = x if datapath == "int" else xq
    want = np.asarray(dj(xin))
    got = dt(xin)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("datapath", ["int", "f32"])
def test_weight_bytes_and_dispatch_table_match(setup, datapath):
    dj, dt = setup[4][datapath]
    assert dt.weight_bytes() == dj.weight_bytes()
    assert dt.dispatch_table() == dj.dispatch_table()
    assert dt.op_counts() == dj.op_counts()
    assert dt.qdq_counts() == dj.qdq_counts()


def test_int_artifact_structure(setup):
    dt = setup[4]["int"][1]
    ops = dt.op_counts()
    assert ops == {"quantize": 1, "im2col": 8, "mvau_int": 8, "maxpool": 3,
                   "add": 2, "global_acc_pool": 1, "dequantize": 1, "mul": 1}
    for n in dt.graph.nodes:
        if n.op == "mvau_int":
            assert n.attrs["int8_ok"] and n.attrs["acc_f32_exact"]
            assert not n.attrs["w_packed"]
            assert dt.graph.initializers[n.inputs[2]].shape[-1] == 15
    assert dt.qdq_counts()["interior_pairs"] == 0
    assert "fused-cuda" in dt.report() or "f32-gemm" in dt.report()


def test_int_equals_f32_equals_interpreter_in_port(setup):
    _, pt, x, _, arts = setup
    dm_int, dm_f32 = arts["int"][1], arts["f32"][1]
    xq = TQ.fake_quant(torch.from_numpy(x), TCFG.act)
    f_int = dm_int(torch.from_numpy(x))
    assert torch.equal(f_int, dm_f32(xq))
    (interp_f32,) = execute(dm_f32.graph, {"x": xq})
    (interp_int,) = execute(dm_int.graph, {"x": torch.from_numpy(x)})
    assert torch.equal(f_int, interp_f32) and torch.equal(f_int, interp_int)
    np.testing.assert_allclose(
        f_int.numpy(), TR.forward(pt, torch.from_numpy(x), TCFG, WIDTH).numpy(),
        rtol=1e-5, atol=1e-6)


def test_unfused_and_packed_int4_paths_match_reference(setup):
    """fuse=False keeps matmul_int + multithreshold_int; a w4 grid packs
    weights to int4 — both bit-for-bit with the reference."""
    pj, pt, x, _, _ = setup
    for cfg, fuse in ((JCFG, False), (JQ.QuantConfig.grid_point(4, 4), True)):
        tcfg = TQ.QuantConfig.grid_point(cfg.weight.total_bits,
                                         cfg.act.total_bits)
        dj = repro.compile(pj, cfg, recipe="resnet9", datapath="int", fuse=fuse)
        dt = repro_torch.compile(pt, tcfg, recipe="resnet9", datapath="int",
                                 fuse=fuse, device="cpu")
        assert dt.dispatch_table() == dj.dispatch_table()
        assert dt.weight_bytes() == dj.weight_bytes()
        np.testing.assert_array_equal(dt(x).numpy(), np.asarray(dj(x)))


def test_warmup_batched_and_trace_count(setup):
    dm = setup[4]["int"][1]
    x = setup[2]
    fresh = repro_torch.compile(dm.graph, recipe="resnet9", device="cpu")
    assert fresh.trace_count == 0
    assert fresh.warmup([1, 2, 4], x) == (1, 2, 4)
    assert fresh.trace_count == 3
    out = fresh.batched(x)                           # 3 rows -> bucket 4
    assert tuple(out.shape) == (3, 8 * WIDTH) and fresh.trace_count == 3
    assert torch.equal(out, dm(x))
    with pytest.raises(ValueError):
        fresh.batched(np.zeros((5, 32, 32, 3), np.float32))


def test_entry_points_default_to_the_card():
    """Without a CUDA device and without device='cpu', entry points raise
    instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TR.init_params(torch.Generator().manual_seed(0), 4)
    p = TR.init_params(torch.Generator().manual_seed(0), 4, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.compile(p, TCFG, recipe="resnet9")
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"c0": {"w": np.zeros((3, 3, 3, 4), np.float32)}})
    from repro_torch.fsl.pipeline import FSLPipeline
    from repro_torch.serve.store import PrototypeStore

    with pytest.raises(RuntimeError, match="CUDA"):
        FSLPipeline(width=4, qcfg=TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        PrototypeStore()


def test_seeded_init_params_are_reproducible():
    a = TR.init_params(torch.Generator().manual_seed(0), 4, device="cpu")
    b = TR.init_params(torch.Generator().manual_seed(0), 4, device="cpu")
    for name in TR.layer_names(4):
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert tuple(a[name]["w"].shape) == (3, 3, TR.plan(4)[
            TR.layer_names(4).index(name)]["cin"], TR.plan(4)[
            TR.layer_names(4).index(name)]["cout"])
