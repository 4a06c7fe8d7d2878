"""The differential fuzz on the port, against the JAX reference, on the CPU.

``repro_torch.core.fuzz`` carries the reference's random hardware-mapped
graph generator (``tests/test_differential.py``) and a wider corpus at the
card kernels' tile edges.  Here:

* the port's generator equals the reference's, seed for seed: graph,
  initializers and input bit for bit, dtype specs equal;
* on the reference's tier-1 seeds the port's four engines (interpreter, f32
  artifact, unfused and fused int artifacts) equal each other and the JAX
  interpreter bit for bit, with the reference's structural assertions and
  the reference's dispatch labels;
* on wide seeds, rebuilt as the reference's graphs from the same numpy
  arrays, the same against the JAX interpreter;
* the wide corpus's card range reaches every route and tile edge the card
  phase is there for.

The same graphs run on the card in ``chip_smoke.py``'s ``fuzz`` phase and
in ``tests/test_torch_card.py``.  JAX is imported only by the tests that
compare with it.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import fuzz as F  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402

# seeds of the wide corpus held against the JAX interpreter: between them
# 1,445-row M tiles with 255 levels and an integer residual GAP (0), plane-
# route nodes (2, 23, 42; 255 levels at 42, a K the planner splits at 23), a fused
# GAP tail (7) and a float residual add (13)
WIDE_JAX_SEEDS = (0, 2, 7, 13, 23, 42)


@pytest.fixture(scope="module")
def ref():
    """The reference's test module (its generator and recipe), loaded from
    its file, and the JAX package's pieces the comparisons use."""
    import repro
    from repro.core import graph as JG
    from repro.core import quant as JQ

    path = Path(__file__).with_name("test_differential.py")
    spec = importlib.util.spec_from_file_location("_reference_differential",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    graphs = {}

    def gen(seed):
        # each seed's graph once: the reference builds it op by op in JAX
        if seed not in graphs:
            graphs[seed] = mod.random_hw_graph(seed)
        return graphs[seed]

    return {"gen": gen, "recipe": mod._FUZZ_RECIPE,
            "compile": repro.compile, "G": JG, "Q": JQ}


def _spec(s):
    return None if s is None else (s.total_bits, s.frac_bits, s.signed)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _ref_graph(ref, g):
    """The port's graph as the reference's, on the same numpy arrays."""
    G, Q = ref["G"], ref["Q"]
    jg = G.Graph([G.Node(n.op, list(n.inputs), list(n.outputs),
                         dict(n.attrs)) for n in g.nodes],
                 list(g.inputs), list(g.outputs), dict(g.initializers),
                 name=g.name)
    jg.dtypes.update({k: None if v is None else
                      Q.FixedPointSpec(v.total_bits, v.frac_bits, v.signed)
                      for k, v in g.dtypes.items()})
    return jg


def _equal_jax(result, want, label):
    for key in ("interpreter", "f32", "int_unfused", "int"):
        got = result[key]
        assert got.dtype == torch.float32 and want.dtype == np.float32, label
        assert tuple(got.shape) == want.shape, label
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{label}: port {key}")


# ---------------------------------------------------------------------------
# the reference's corpus
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(32))
def test_generator_is_the_references(ref, seed):
    gj, xj, fj = ref["gen"](seed)
    gt, xt, ft = F.random_hw_graph(seed)
    assert ft == fj
    assert gt.name == gj.name
    assert list(gt.inputs) == list(gj.inputs)
    assert list(gt.outputs) == list(gj.outputs)
    assert [(n.op, n.inputs, n.outputs, n.attrs) for n in gt.nodes] == \
        [(n.op, n.inputs, n.outputs, n.attrs) for n in gj.nodes]
    assert sorted(gt.initializers) == sorted(gj.initializers)
    for k, a in gj.initializers.items():
        a, b = np.asarray(a), gt.initializers[k]
        assert isinstance(b, np.ndarray), k
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(_bits(a), _bits(b)), k
    xj = np.asarray(xj)
    assert isinstance(xt, np.ndarray)
    assert xt.dtype == xj.dtype and xt.shape == xj.shape
    assert np.array_equal(_bits(xt), _bits(xj))
    assert {k: _spec(v) for k, v in gt.dtypes.items()} == \
        {k: _spec(v) for k, v in gj.dtypes.items()}


@pytest.mark.parametrize("seed", range(8))
def test_four_engines_equal_jax_on_reference_seeds(ref, seed):
    """The reference's tier-1 seeds: the port's four engines equal each
    other (``check_differential``) and the JAX interpreter on the
    reference's own graph, bit for bit; both int artifacts carry the
    reference's dispatch labels (off the card they are the same labels)."""
    gj, xj, _ = ref["gen"](seed)
    want = np.asarray(ref["G"].execute(gj.copy(), {"x": xj})[0])
    g, x, _ = F.random_hw_graph(seed)
    result = F.check_differential(g, x, "cpu")
    _equal_jax(result, want, f"seed {seed}")
    for key, fuse in (("int", True), ("int_unfused", False)):
        dj = ref["compile"](gj.copy(), recipe=ref["recipe"], datapath="int",
                            fuse=fuse)
        assert result["dispatch"][key] == dj.dispatch_table(), key
        assert result["artifacts"][key].op_counts() == dj.op_counts(), key


def test_reference_corpus_covers_its_shapes():
    """The port's copy covers what the reference's coverage test asks for
    over seeds 0-31: fused and standalone chains, GAP and dense tails, the
    bare-matmul head, odd frames."""
    kinds, head, odd = set(), 0, 0
    for seed in range(32):
        g, x, fused = F.random_hw_graph(seed)
        ops = [n.op for n in g.nodes]
        kinds.add(("mvau" if fused else "unfused",
                   "gap" if "global_acc_pool" in ops else "dense_out"))
        head += int("proj_w" in g.initializers)
        odd += int(x.shape[1] % 2 == 1)
    assert len(kinds) >= 3 and head >= 1 and odd >= 1


# ---------------------------------------------------------------------------
# the wide corpus
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", WIDE_JAX_SEEDS)
def test_wide_corpus_equals_jax_interpreter(ref, seed):
    """The port's four engines equal the JAX interpreter on the same graph,
    bit for bit; so does the reference's own fused int artifact (a
    disagreement there would be the reference's fault, the port still held
    to its interpreter), whose dispatch labels the port's equal."""
    g, x, info = F.wide_hw_graph(seed)
    jg = _ref_graph(ref, g)
    want = np.asarray(ref["G"].execute(jg, {"x": x})[0])
    result = F.check_differential(g, x, "cpu")
    _equal_jax(result, want, f"wide seed {seed} {info}")
    dj = ref["compile"](jg.copy(), recipe=ref["recipe"], datapath="int")
    np.testing.assert_array_equal(np.asarray(dj(x)), want,
                                  err_msg="the reference's fused int artifact")
    assert result["dispatch"]["int"] == dj.dispatch_table()


def test_wide_generator_is_seeded_and_on_grid():
    """Same seed, same bits; another seed, another graph; the input on its
    grid; every draw inside the float32-exact bound the generator asserts."""
    from repro_torch.core.quant import fake_quant

    seen = set()
    for seed in range(16):
        g, x, info = F.wide_hw_graph(seed)
        g2, x2, info2 = F.wide_hw_graph(seed)
        assert info == info2 and np.array_equal(_bits(x), _bits(x2))
        for k, a in g.initializers.items():
            assert np.array_equal(_bits(a), _bits(g2.initializers[k]))
        spec = g.dtypes["x"]
        assert np.array_equal(_bits(fake_quant(torch.from_numpy(x),
                                               spec).numpy()), _bits(x))
        assert 1 <= x.shape[0] <= 5 and x.shape[1] in F.WIDE_IMAGES
        for b in info["blocks"]:
            assert b["n"] in F.WIDE_CHANNELS and 3 <= b["levels"] <= 255
            assert b["k"] * 2 ** (b["w_bits"] - 1) \
                * (2 ** b["in_bits"] - 1) < 2 ** 24
        seen.add(x.tobytes())
    assert len(seen) == 16


def _card_coverage():
    """Per wide card seed, the lowering of its f32 and fused int artifacts
    (compiled on the CPU: the graph, not the device, decides them)."""
    out = {}
    for seed in F.WIDE_SEEDS:
        g, x, info = F.wide_hw_graph(seed)
        arts = [repro_torch.compile(g.copy(), recipe=F.FUZZ_RECIPE,
                                    datapath=dp, device="cpu")
                for dp in ("f32", "int")]
        out[seed] = (info, [F.lowering_summary(dm, x) for dm in arts])
    return out


def test_wide_corpus_covers_the_card():
    """Over the card's seed range the corpus reaches: M past 128 with a
    ragged last tile, N past 128, a K the planner splits on the H100, more
    than 64 levels on each tensor-core integer route (int8 and planes), both
    of them, a fused GAP tail, a residual GAP and an ``add`` that stays
    float."""
    seen = {k: [] for k in ("m_ragged", "n_wide", "split", "l64_int8",
                            "l64_planes", "int8", "planes", "f32", "gap_tail",
                            "residual_gap", "float_add", "int_add")}
    coverage = _card_coverage()
    for seed, (info, summaries) in coverage.items():
        for summary in summaries:
            for n in summary["mvau"]:
                if n["m"] > 128 and n["m"] % 128:
                    seen["m_ragged"].append(seed)
                if n["n"] > 128:
                    seen["n_wide"].append(seed)
                if n["splits"] > 1:
                    seen["split"].append(seed)
                if n["levels"] > 64 and n["route"] != "f32":
                    seen[f"l64_{n['route']}"].append(seed)
                seen[n["route"]].append(seed)
        fused = summaries[1]
        seen["gap_tail"] += [seed] * fused["gap_tails"]
        seen["residual_gap"] += [seed] * fused["residual_gaps"]
        seen["float_add"] += [seed] * fused["float_adds"]
        if info["residual"] == "int":
            seen["int_add"].append(seed)
    missing = [k for k, v in seen.items() if not v]
    assert not missing, f"the wide card range misses {missing}"
    # a float add is one the generator drew on mismatched grids, and only
    # those: the integer ones lower
    floats = {s for s, (info, _) in coverage.items()
              if info["residual"] == "float"}
    assert set(seen["float_add"]) == floats


def test_check_differential_catches_a_wrong_engine(monkeypatch):
    """A fused int artifact whose MVAU is one code off is caught, and named:
    the checker is not vacuous."""
    real = kops.mvau_int_node

    def off_by_one(node, x, w, t):
        return real(node, x, w, t) + 1

    g, x, _ = F.random_hw_graph(0)
    F.check_differential(g, x, "cpu")
    monkeypatch.setattr(kops, "mvau_int_node", off_by_one)
    with pytest.raises(F.FuzzMismatch, match="interpreter != int"):
        F.check_differential(g, x, "cpu")


# ---------------------------------------------------------------------------
# the dense corpus: the GEMM form at decode and small-batch shapes
# ---------------------------------------------------------------------------
# dense seeds held against the JAX interpreter: int8 GEMM-form MVAUs on the
# small-M route (16; 17 at K 1,440; 19 at 255 levels beside a plane-route
# one) and past its limit (11: M 128 at K 1,440), standalone pairs (2)
GEMM_JAX_SEEDS = (2, 11, 16, 17, 19)


@pytest.mark.parametrize("seed", GEMM_JAX_SEEDS)
def test_gemm_corpus_equals_jax_interpreter(ref, seed):
    """The port's four engines equal the JAX interpreter on the same dense
    graph, bit for bit, and the reference's fused int artifact too, whose
    dispatch labels the port's equal."""
    g, x, info = F.gemm_hw_graph(seed)
    jg = _ref_graph(ref, g)
    want = np.asarray(ref["G"].execute(jg, {"x": x})[0])
    result = F.check_differential(g, x, "cpu")
    _equal_jax(result, want, f"gemm seed {seed} {info}")
    dj = ref["compile"](jg.copy(), recipe=ref["recipe"], datapath="int")
    np.testing.assert_array_equal(np.asarray(dj(x)), want,
                                  err_msg="the reference's fused int artifact")
    assert result["dispatch"]["int"] == dj.dispatch_table()


def test_gemm_generator_is_seeded_and_on_grid():
    """Same seed, same bits; the input on its grid with M and K from the
    corpus's sets; every layer inside the float32-exact bound."""
    from repro_torch.core.quant import fake_quant

    for seed in range(16):
        g, x, info = F.gemm_hw_graph(seed)
        g2, x2, info2 = F.gemm_hw_graph(seed)
        assert info == info2 and np.array_equal(_bits(x), _bits(x2))
        for k, a in g.initializers.items():
            assert np.array_equal(_bits(a), _bits(g2.initializers[k]))
        assert not any(n.op == "im2col" for n in g.nodes)
        spec = g.dtypes["x"]
        assert np.array_equal(_bits(fake_quant(torch.from_numpy(x),
                                               spec).numpy()), _bits(x))
        assert x.shape[0] in F.GEMM_ROWS and x.shape[1] in F.GEMM_DEPTHS
        for layer in info["layers"]:
            assert layer["n"] in F.WIDE_CHANNELS
            assert 3 <= layer["levels"] <= 255


def test_gemm_corpus_covers_both_int8_routes():
    """Over the card's dense range the int8 GEMM form reaches the small-M
    kernel (with tables past 64 levels, K past 1,000, a ragged N and M on
    the limit) and the wgmma kernel past the limit; the plane route (8-bit
    unsigned codes) and the float MVAU run there too.  Every node is GEMM form."""
    from repro_torch.kernels import mvau as KM

    seen = {k: [] for k in ("small_m", "small_m_l64", "small_m_deep",
                            "small_m_ragged_n", "small_m_at_limit",
                            "wgmma", "planes", "f32")}
    for seed in F.GEMM_SEEDS:
        g, x, _ = F.gemm_hw_graph(seed)
        for dp in ("f32", "int"):
            dm = repro_torch.compile(g.copy(), recipe=F.FUZZ_RECIPE,
                                     datapath=dp, device="cpu")
            for n in F.lowering_summary(dm, x)["mvau"]:
                assert n["form"] == "gemm"
                if n["route"] == "int8_small_m":
                    assert n["m"] <= KM.SMALL_M_ROWS and n["splits"] == 1
                    seen["small_m"].append(seed)
                    if n["levels"] > 64:
                        seen["small_m_l64"].append(seed)
                    if n["k"] > 1000:
                        seen["small_m_deep"].append(seed)
                    if n["n"] % 16:
                        seen["small_m_ragged_n"].append(seed)
                    if n["m"] > KM.SMALL_M_ROWS // 2:
                        seen["small_m_at_limit"].append(seed)
                elif n["route"] == "int8":
                    assert n["m"] > KM.SMALL_M_ROWS
                    seen["wgmma"].append(seed)
                else:
                    seen[n["route"]].append(seed)
    missing = [k for k, v in seen.items() if not v]
    assert not missing, f"the dense card range misses {missing}"
