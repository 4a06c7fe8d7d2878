"""The port's compiled LM decode path on the CPU, against the JAX package.

``lm-tiny`` at its full published size (2 layers, d_model 64, 4 heads,
d_ff 96, vocab 97 padded to 256, w8a8), the JAX parameter tree carried
across with ``params_from_numpy``:

* the exported decode and prefill graphs equal JAX's: node ops, names and
  attrs, initializers bit for bit, dtype annotations; after
  ``compile(recipe="lm-decode")`` the op counts, the CPU dispatch table and
  the lowered graph equal JAX's, and the weight bytes are 93,432 (int) and
  372,948 (f32);
* inside the port, compiled int == compiled f32 == interpreter ==
  ``decode_step_ref``, bit for bit (the reference's own contract);
* against JAX, logits and caches are equal bit for bit on every row where
  no pre-quantization value lies within ``TIE_ULPS`` float32 roundings of
  an activation-grid midpoint (found from the values, never by loosening
  a tolerance: the float ops between quantizers sum in another order
  than XLA's, which can move such a value across the midpoint), and the
  greedy tokens of three fixed prompts are equal;
* ``ref.attn_decode`` / ``ref.attn_prefill`` agree with JAX's within
  rtol 1e-5, atol 1e-6 on random float inputs: the port sums both
  contractions by halving, which is batch invariant, where XLA contracts
  with its own order; the fused prefill agrees with stepped decode within
  the reference's 1e-5.
"""

import collections

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs.lm_tiny  # noqa: E402,F401  (registers the arch)
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro.serve.decode import build_decode_artifact as j_build  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import deploy  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import recipes  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.serve.decode import build_decode_artifact  # noqa: E402

CFG = get_config("lm-tiny")
JCFG = j_get_config("lm-tiny")
CAPS = (8, 16)
INT_BYTES, F32_BYTES = 93_432, 372_948
INT_OPS = {"embed": 1, "dequantize": 14, "rmsnorm": 5, "quantize": 9,
           "matmul_int": 11, "attn_decode": 2, "add": 4, "gelu": 2,
           "mvau_int": 2}
TIE_ULPS = 4
FLOAT_OPS = ("rmsnorm", "gelu", "silu", "mul", "attn_decode")
PROMPTS = ([5, 11, 2, 40, 8, 19], [3, 14, 15], [96, 0, 42, 7])


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def arts(params):
    return {"int": build_decode_artifact(params, CFG, datapath="int",
                                         capacities=CAPS, with_prefill=True,
                                         device="cpu"),
            "f32": build_decode_artifact(params, CFG, datapath="f32",
                                         capacities=CAPS, device="cpu")}


@pytest.fixture(scope="module")
def jarts(jparams):
    return {"int": j_build(jparams, JCFG, datapath="int", capacities=CAPS,
                           with_prefill=True),
            "f32": j_build(jparams, JCFG, datapath="f32", capacities=CAPS)}


def _spec(s):
    return None if s is None else (s.total_bits, s.frac_bits, s.signed)


def _same_graph(gj, gt):
    assert gt.name == gj.name
    assert list(gt.inputs) == list(gj.inputs)
    assert list(gt.outputs) == list(gj.outputs)
    assert [(n.op, n.inputs, n.outputs, n.attrs) for n in gt.nodes] == \
        [(n.op, n.inputs, n.outputs, n.attrs) for n in gj.nodes]
    assert sorted(gt.initializers) == sorted(gj.initializers)
    for k, a in gj.initializers.items():
        a, b = np.asarray(a), np.asarray(gt.initializers[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k
    assert {k: _spec(v) for k, v in gt.dtypes.items()} == \
        {k: _spec(v) for k, v in gj.dtypes.items()}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _caches(feeds):
    return [feeds[f"{kv}{li}"] for li in range(CFG.n_layers)
            for kv in ("k", "v")]


def tied_rows(graph, feeds):
    """Rows of the batch where a value entering an activation quantizer of
    the f32 ``graph`` lies within ``TIE_ULPS`` float32 roundings of a grid
    midpoint ``(k + 1/2) * scale``, from the port's own values.  The band
    is ``TIE_ULPS * 2^-24 * (|x| + |mid| + M)``, where M is the row's
    largest |V| for an attention output (a softmax-weighted sum of V rows
    rounds at their scale) and 0 elsewhere.  Only the float ops' outputs
    are read: a matmul of grid values is exact in both packages, so where
    it lands on a midpoint both round it alike; so is the attention of a
    row at position 0 (one live slot, weight exactly 1: its output is
    V's row)."""
    env = G._run(graph, feeds, torch.device("cpu"))
    aspec = CFG.quant.act
    prods = {o: n for n in graph.nodes for o in n.outputs}
    tied = np.zeros(len(feeds["tokens"]), bool)
    for n in graph.nodes:
        if n.op != "multithreshold":
            continue
        p = prods[n.inputs[0]]
        if p.op not in FLOAT_OPS:
            continue
        x = env[n.inputs[0]].double()
        rows = x.reshape(x.shape[0], -1)
        k = torch.floor(rows / aspec.scale)
        mid = (k + 0.5) * aspec.scale
        m = torch.zeros_like(rows[:, :1])
        if p.op == "attn_decode":
            v = env[p.outputs[2]].double()
            m = v.reshape(v.shape[0], -1).abs().amax(dim=1, keepdim=True)
        band = TIE_ULPS * 2.0 ** -24 * (rows.abs() + mid.abs() + m)
        if p.op == "attn_decode":
            band[torch.as_tensor(feeds["pos"]) == 0] = -1.0
        hit = ((rows - mid).abs() <= band) & (k >= aspec.qmin) \
            & (k < aspec.qmax)
        tied |= hit.any(dim=1).numpy()
    return tied


# ---------------------------------------------------------------------------
# config, export, recipe
# ---------------------------------------------------------------------------
def test_lm_tiny_config_and_init_params_tree(jparams):
    from repro_torch.configs import ASSIGNED

    assert "lm-tiny" in ASSIGNED
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "vocab",
              "vocab_padded", "tie_embeddings", "act", "pos", "norm_eps",
              "compute_dtype", "max_seq"):
        assert getattr(CFG, f) == getattr(JCFG, f), f
    assert _spec(CFG.quant.weight) == _spec(JCFG.quant.weight)
    assert _spec(CFG.quant.act) == _spec(JCFG.quant.act)
    tp = lm.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)
    from repro_torch.tree import tree_map

    assert tree_map(lambda t: tuple(t.shape), tp) == shapes
    assert "lm_head" in tp and "w_gate" not in tp["blocks"]["mlp"]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_exported_graph_equals_jax(jparams, params, kind):
    fn = "export_decode_graph" if kind == "decode" else "export_prefill_graph"
    _same_graph(getattr(jlm, fn)(jparams, JCFG), getattr(lm, fn)(params, CFG))


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_example_feeds_equal_jax(kind):
    fn = f"example_{kind}_feeds"
    a, b = getattr(jlm, fn)(JCFG, seed=5), getattr(lm, fn)(CFG, seed=5)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_not_exportable_config_raises():
    import dataclasses

    with pytest.raises(ValueError, match="not decode-exportable"):
        lm._decode_exportable(dataclasses.replace(CFG, pos="rope",
                                                  tie_embeddings=True))


def test_lm_decode_recipe_and_hooks():
    r = recipes.recipe("lm-decode")
    assert r.passes == () and r.exporter is not None
    hooks = r.workload_hooks("decode")
    assert hooks.export_decode is lm.export_decode_graph
    assert hooks.export_prefill is lm.export_prefill_graph
    assert hooks.step_ref is lm.decode_step_ref
    assert hooks.example_feeds is lm.example_decode_feeds
    assert r.hook_kinds() == ("decode",)
    with pytest.raises(ValueError, match="no FSL hooks"):
        r.workload_hooks("fsl")
    with pytest.raises(ValueError, match="available kinds: \\['decode'\\]"):
        r.workload_hooks("vision")
    assert "lm-decode" in recipes.list_recipes()
    assert recipes.recipe("resnet9").hook_kinds() == ("fsl",)


# ---------------------------------------------------------------------------
# compiled artifacts: structure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("datapath", ["int", "f32"])
def test_compiled_graph_counts_and_dispatch_equal_jax(arts, jarts, datapath):
    a, j = arts[datapath], jarts[datapath]
    _same_graph(j.dm.graph, a.dm.graph)
    assert a.dm.op_counts() == dict(j.dm.op_counts())
    assert a.dm.dispatch_table() == j.dm.dispatch_table()
    assert a.weight_bytes() == j.weight_bytes()
    ops = collections.Counter(n.op for n in a.dm.graph.nodes)
    if datapath == "int":
        assert dict(ops) == INT_OPS and len(a.dm.graph.nodes) == 50
        assert a.weight_bytes() == INT_BYTES
    else:
        assert ops["matmul"] == 13 and ops["multithreshold"] == 11
        assert "mvau" not in ops and "mvau_int" not in ops
        assert a.weight_bytes() == F32_BYTES
    assert [r.verified for r in a.dm.trace.records] == \
        [True] * len(a.dm.trace.records)


def test_embed_stored_int8_and_mvau_tables(arts):
    g = arts["int"].dm.graph
    (emb,) = [n for n in g.nodes if n.op == "embed"]
    assert np.asarray(g.initializers[emb.inputs[0]]).dtype == np.int8
    mv = [n for n in g.nodes if n.op == "mvau_int"]
    assert [n.outputs[0] for n in mv] == ["l0.aq5", "l1.aq5"]
    for n in mv:
        t = np.asarray(g.initializers[n.inputs[2]])
        w = np.asarray(g.initializers[n.inputs[1]])
        assert t.shape == (255,) and t.dtype == np.int32
        assert w.shape == (96, 64) and w.dtype == np.int8
        assert n.attrs["out_base"] == -128
        assert n.attrs["int8_ok"] and n.attrs["acc_f32_exact"]


def test_lowering_prepares_tables_once(arts, monkeypatch):
    """Lowering expands each (L,) ``mvau_int`` table to a contiguous (N, L)
    int32 constant and records the f32 quantizers' tables as sorted, so no
    call broadcasts a table or waits for the device to check one (a CUDA
    graph capture forbids the wait)."""
    from repro_torch.kernels import ops as kops

    g = arts["int"].dm.graph
    nodes = [n.copy() for n in g.nodes]
    consts = {k: G.as_tensor(v, torch.device("cpu"))
              for k, v in g.initializers.items()}
    kops.prepare_tables(nodes, g.initializers, consts)
    for n in nodes:
        if n.op == "mvau_int":
            t = consts[n.inputs[2]]
            assert n.inputs[2].endswith("@64") and t.shape == (64, 255)
            assert t.is_contiguous() and t.dtype == torch.int32
            assert torch.equal(t[5], torch.as_tensor(
                g.initializers[n.inputs[2][:-3]]))
    gf = arts["f32"].dm.graph
    nodes = [n.copy() for n in gf.nodes]
    kops.prepare_tables(nodes, gf.initializers, {})
    assert [n.attrs.get("sorted_levels") for n in nodes
            if n.op == "multithreshold"] == [True] * 11
    feeds = lm.example_decode_feeds(CFG, batch=2, capacity=8, seed=1)
    want = arts["f32"].dm(**feeds)

    def no_check(*a, **k):
        raise AssertionError("a lowered quantizer checked its table")

    monkeypatch.setattr(torch, "all", no_check)
    fn = deploy.lower_graph(gf, "cpu")
    got = fn(*[G.as_tensor(feeds[k], torch.device("cpu"))
               for k in gf.inputs])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# bit for bit inside the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,batch,cap", [(3, 2, 8), (4, 5, 16), (5, 8, 8)])
def test_int_f32_interpreter_ref_bitwise(arts, params, seed, batch, cap):
    feeds = lm.example_decode_feeds(CFG, batch=batch, capacity=cap, seed=seed)
    out_i = arts["int"].dm(**feeds)
    out_f = arts["f32"].dm(**feeds)
    interp = G.execute(arts["int"].dm.graph, feeds, "cpu")
    interp_f = G.execute(arts["f32"].dm.graph, feeds, "cpu")
    logits, caches = lm.decode_step_ref(params, feeds["tokens"], feeds["pos"],
                                        _caches(feeds), CFG)
    for outs in (out_f, interp, interp_f, [logits] + caches):
        assert len(outs) == len(out_i)
        for a, b in zip(out_i, outs):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_rows_independent_of_bucket(arts):
    """A row's outputs do not depend on the rows beside it, or on how many
    there are (the serving contract: a sequence's logits do not depend on
    the bucket it is padded into)."""
    feeds = lm.example_decode_feeds(CFG, batch=8, capacity=16, seed=9)
    full = arts["int"].dm(**feeds)
    for b in (0, 5):
        one = arts["int"].dm(**{k: v[b:b + 1] for k, v in feeds.items()})
        for a, c in zip(full, one):
            assert torch.equal(a[b:b + 1], c)


# ---------------------------------------------------------------------------
# against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,batch,cap", [(0, 8, 8), (1, 8, 16), (2, 4, 8)])
def test_logits_and_caches_equal_jax(arts, jarts, seed, batch, cap):
    feeds = lm.example_decode_feeds(CFG, batch=batch, capacity=cap, seed=seed)
    tied = tied_rows(arts["f32"].dm.graph, feeds)
    assert tied.sum() <= 1, f"{tied.sum()} tied rows of {batch}"
    keep = ~tied
    for dp in ("int", "f32"):
        got = arts[dp].dm(**feeds)
        want = jarts[dp].dm(**feeds)
        for a, b in zip(got, want):
            a, b = _np(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a[keep], b[keep])


def _greedy(step, prompt, max_new, cap=16):
    caches = [np.zeros((1, cap, CFG.d_model), np.float32)
              for _ in range(2 * CFG.n_layers)]
    toks, pos = list(prompt), 0
    out = []
    for i in range(len(prompt) + max_new - 1):
        t = toks[i] if i < len(prompt) else out[-1]
        logits, caches = step(np.array([t], np.int32),
                              np.array([pos], np.int32), caches)
        caches = [_np(c) for c in caches]
        pos += 1
        if i >= len(prompt) - 1:
            out.append(int(np.argmax(_np(logits)[0, :CFG.vocab])))
    return out


def test_greedy_tokens_equal_jax(arts, jparams):
    """Greedy continuations of three fixed prompts: the port's compiled int
    artifact (through ``DecodeArtifact``) against JAX's eager mirror."""
    art = arts["int"]
    for i, prompt in enumerate(PROMPTS):
        want = _greedy(lambda t, p, c: jlm.decode_step_ref(
            jparams, jnp.asarray(t), jnp.asarray(p),
            [jnp.asarray(x) for x in c], JCFG), prompt, 10)
        seq = f"greedy-{i}"
        got = [art.start_sequence(seq, prompt)[0]]
        for _ in range(9):
            (res,), _ = art.step_sequences([(seq, None)])
            got.append(res[1])
        assert art.release(seq) == len(prompt) + 9
        assert got == want


# ---------------------------------------------------------------------------
# attention and fused prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,C", [(1, 8), (3, 7), (5, 64)])
def test_attn_decode_matches_jax(B, C):
    rng = np.random.default_rng(B * 100 + C)
    D, H = 64, 4
    q, k, v = (rng.standard_normal((B, D)).astype(np.float32)
               for _ in range(3))
    kc, vc = (rng.standard_normal((B, C, D)).astype(np.float32)
              for _ in range(2))
    pos = rng.integers(0, C, B).astype(np.int32)
    want = jref.attn_decode(*map(jnp.asarray, (q, k, v, kc, vc, pos)), H)
    got = ref.attn_decode(*map(torch.as_tensor, (q, k, v, kc, vc, pos)), H)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("B,S", [(1, 1), (2, 5), (3, 8)])
def test_attn_prefill_matches_jax(B, S):
    rng = np.random.default_rng(B * 10 + S)
    q, k, v = (rng.standard_normal((B, S, 64)).astype(np.float32)
               for _ in range(3))
    want = jref.attn_prefill(*map(jnp.asarray, (q, k, v)), 4)
    got = ref.attn_prefill(*map(torch.as_tensor, (q, k, v)), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_constants_round_as_a_host_tensor(dtype):
    """``gelu_tanh``'s constants are fills on the tensor's device (a CUDA
    graph capture forbids a host copy) with the bits of a host tensor of
    that dtype, as JAX's weak-typed constants round."""
    import math

    from repro_torch.models import layers as L

    x = torch.zeros(3, dtype=dtype)
    for v in (math.sqrt(2 / math.pi), 0.044715):
        assert torch.equal(L._const(v, x), torch.tensor(v, dtype=dtype))


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_halving_sum_is_a_sum(n):
    x = torch.arange(3 * n, dtype=torch.float32).reshape(3, n)
    assert torch.equal(ref._halving_sum(x, 1), x.sum(dim=1))
    assert torch.equal(ref._halving_sum(x.T, 0), x.sum(dim=1))


def test_fused_prefill_matches_stepped_decode(arts, params):
    prompt = np.array([[5, 11, 2, 40, 8, 19]], np.int32)
    outs = arts["int"].dm_prefill(tokens=prompt)
    caches = [np.zeros((1, 8, CFG.d_model), np.float32)
              for _ in range(2 * CFG.n_layers)]
    logits = None
    for pos in range(prompt.shape[1]):
        logits, caches = lm.decode_step_ref(
            params, prompt[:, pos], np.array([pos], np.int32), caches, CFG)
    np.testing.assert_allclose(outs[0][:, -1].numpy(), logits.numpy(),
                               rtol=1e-5, atol=1e-5)
    for li in range(CFG.n_layers):
        np.testing.assert_allclose(outs[1 + 2 * li].numpy(),
                                   caches[2 * li][:, :prompt.shape[1]].numpy(),
                                   rtol=1e-5, atol=1e-6)
