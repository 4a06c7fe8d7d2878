"""The port's LM decode serving on the CPU: ``DecodeArtifact`` and
``DecodeAdapter`` through ``ServeEngine``, against the JAX package's.

``lm-tiny`` compiled with ``repro_torch.compile(recipe="lm-decode")`` on
the CPU at KV capacities (8, 16) and batch buckets (1, 2, 4, 8), the JAX
parameter tree carried across with ``params_from_numpy``.  The reference's
engine contracts (``tests/test_decode.py``) in the port: every logits row
the engine returns is bit for bit the eager ``decode_step_ref`` at batch
1, greedy int == f32, request plumbing with the reference's error
messages, the sequence lifecycle, capacity growth without a capture, the
tenant quota, and a soak of mixed traffic with ``trace_counts()`` flat.
Then the same seeded traffic through JAX's engine and the port's: equal
tokens.  Last, the multi-input ``DeployedModel.warmup`` contract.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs.lm_tiny  # noqa: E402,F401  (registers the arch)
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro.serve import ArtifactRegistry as JRegistry  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.decode import DecodeAdapter as JAdapter  # noqa: E402
from repro.serve.decode import build_decode_artifact as j_build  # noqa: E402
from repro.serve.decode import greedy_generate as j_generate  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ArtifactRegistry,
    DecodeAdapter,
    DecodeResult,
    PrefillResult,
    ServeEngine,
    TenantOverQuota,
    build_decode_artifact,
    greedy_generate,
)

CFG = get_config("lm-tiny")
CAPS = (8, 16)
BUCKETS = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def jparams():
    return jlm.init_params(jax.random.PRNGKey(0), j_get_config("lm-tiny"))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def art_int(params):
    return build_decode_artifact(params, CFG, datapath="int",
                                 capacities=CAPS, device="cpu")


@pytest.fixture(scope="module")
def art_f32(params):
    return build_decode_artifact(params, CFG, datapath="f32",
                                 capacities=CAPS, device="cpu")


@pytest.fixture(scope="module")
def engine(art_int, art_f32):
    reg = ArtifactRegistry()
    adapter = DecodeAdapter()
    reg.register("int", art_int, adapter=adapter, default=True)
    reg.register("f32", art_f32, adapter=adapter)
    eng = ServeEngine(reg, max_batch=8, buckets=BUCKETS)
    eng.warmup()
    yield eng
    eng.stop()


def _eager_greedy(params, prompt, max_new, capacity=16):
    """The reference loop over ``decode_step_ref`` at batch 1: greedy
    tokens and per-step logits rows (the prompt's last, then decodes)."""
    caches = [np.zeros((1, capacity, CFG.d_model), np.float32)
              for _ in range(2 * CFG.n_layers)]
    pos, logits = 0, None
    for t in prompt:
        logits, caches = lm.decode_step_ref(
            params, np.array([t], np.int32), np.array([pos], np.int32),
            caches, CFG)
        pos += 1
    rows = [logits.numpy()[0, :CFG.vocab]]
    toks = [int(np.argmax(rows[-1]))]
    for _ in range(max_new - 1):
        logits, caches = lm.decode_step_ref(
            params, np.array([toks[-1]], np.int32),
            np.array([pos], np.int32), caches, CFG)
        pos += 1
        rows.append(logits.numpy()[0, :CFG.vocab])
        toks.append(int(np.argmax(rows[-1])))
    return toks, rows


def test_warmup_captures_every_bucket_and_capacity(engine):
    base = engine.trace_counts()
    assert base == {"int": len(BUCKETS) * len(CAPS),
                    "f32": len(BUCKETS) * len(CAPS)}
    dm = engine.registry.get("int").feats.dm
    assert dm.buckets == BUCKETS
    keys = {tuple(s for s, _ in k[2:3]) for k in dm._exec._eager_shapes}
    assert keys == {((b, c, CFG.d_model),) for b in BUCKETS for c in CAPS}


@pytest.mark.parametrize("prompt,cap", [([7, 3, 1], 8), ([2, 90, 4, 4], 16)])
def test_engine_decode_bitwise_vs_eager(engine, params, prompt, cap):
    """Every logits row the engine returns is bit for bit the eager
    reference's at batch 1."""
    toks_ref, rows_ref = _eager_greedy(params, prompt, 5, capacity=cap)
    pf = engine.submit("prefill", {"seq": "bw", "tokens": prompt,
                                   "reserve": cap}).result(60)
    assert isinstance(pf, PrefillResult) and pf.pos == len(prompt)
    rows, toks = [pf.logits], [pf.token]
    for i in range(4):
        r = engine.submit("decode", {"seq": "bw"}).result(60)
        assert isinstance(r, DecodeResult) and r.pos == len(prompt) + i + 1
        rows.append(r.logits)
        toks.append(r.token)
    engine.submit("release", {"seq": "bw"}).result(60)
    assert toks == toks_ref
    for got, want in zip(rows, rows_ref):
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_rows_do_not_depend_on_batch_neighbours(engine, params):
    """Eight sequences stepped in one bucket-8 launch: each sequence's rows
    equal its batch-1 eager run."""
    prompts = [[i + 1, 2 * i + 3] for i in range(8)]
    want = [_eager_greedy(params, p, 4, capacity=8) for p in prompts]
    seqs = [f"nb-{i}" for i in range(8)]
    pfs = [engine.submit("prefill", {"seq": s, "tokens": p})
           for s, p in zip(seqs, prompts)]
    got = [([f.result(60).token], [f.result(60).logits]) for f in pfs]
    for _ in range(3):
        fs = [engine.submit("decode", {"seq": s}) for s in seqs]
        for (toks, rows), f in zip(got, fs):
            r = f.result(60)
            toks.append(r.token)
            rows.append(r.logits)
    for s in seqs:
        engine.submit("release", {"seq": s}).result(60)
    for (toks, rows), (toks_ref, rows_ref) in zip(got, want):
        assert toks == toks_ref
        assert all(np.array_equal(a, b) for a, b in zip(rows, rows_ref))


def test_engine_greedy_int_equals_f32(engine):
    prompts = [[3, 14, 15], [9, 2], [7, 7, 7, 7]]
    out_int = greedy_generate(engine, prompts, 6)
    out_f32 = greedy_generate(engine, prompts, 6, artifact="f32")
    assert out_int == out_f32


def test_engine_decode_request_plumbing(engine):
    # an unknown sequence fails the FUTURE (worker side); kind errors raise
    # at submit (caller side)
    with pytest.raises(KeyError):
        engine.submit("decode", {"seq": "ghost"}).result(60)
    with pytest.raises(ValueError, match="unknown request kind"):
        engine.submit("classify", {"x": np.zeros((1, 4, 4, 3))})
    with pytest.raises(ValueError, match="needs 'seq'"):
        engine.submit("decode", {})
    with pytest.raises(ValueError, match="non-empty"):
        engine.submit("prefill", {"seq": "s", "tokens": []})
    with pytest.raises(ValueError, match="decode payloads are dicts"):
        engine.submit("release", "s")
    # a sequence with no prediction yet cannot decode greedily
    art = engine.registry.get("int").feats
    with pytest.raises(ValueError, match="no last prediction"):
        art._seqs["fresh"] = art._new_state(8)
        try:
            art.step_sequences([("fresh", None)])
        finally:
            art._seqs.pop("fresh")


def test_engine_sequence_lifecycle(engine):
    engine.submit("prefill", {"seq": "life", "tokens": [1, 2]}).result(60)
    with pytest.raises(ValueError, match="already active"):
        engine.submit("prefill", {"seq": "life", "tokens": [3]}).result(60)
    pos = engine.submit("release", {"seq": "life"}).result(60)
    assert pos == 2
    with pytest.raises(KeyError, match="unknown sequence"):
        engine.submit("release", {"seq": "life"}).result(60)
    engine.submit("prefill", {"seq": "life", "tokens": [4]}).result(60)
    engine.submit("release", {"seq": "life"}).result(60)
    assert engine.registry.get("int").feats.sequences() == ()


def test_kv_capacity_growth_no_capture(engine, params):
    """Decode past the first KV bucket: the sequence grows 8 -> 16 and the
    greedy tokens keep matching the eager reference, with no capture or
    eager run after warmup."""
    base = engine.trace_counts()
    prompt = [4, 9, 12, 33, 2]
    want, _ = _eager_greedy(params, prompt, 9, capacity=16)
    (got,) = greedy_generate(engine, [prompt], 9)    # pos crosses 8
    assert got == want
    assert engine.trace_counts() == base


def test_capacity_exhausted_fails_the_future(engine):
    engine.submit("prefill", {"seq": "long", "tokens": [1] * 16}).result(60)
    with pytest.raises(RuntimeError, match="exceeds the largest KV"):
        engine.submit("decode", {"seq": "long"}).result(60)
    engine.submit("release", {"seq": "long"}).result(60)


def test_tenant_quota_applies_to_decode(art_int):
    reg = ArtifactRegistry()
    reg.register("int", art_int, adapter=DecodeAdapter(), default=True)
    eng = ServeEngine(reg, max_batch=8, buckets=BUCKETS, max_queue=8,
                      tenant_quota=2, start=False)
    eng.submit("prefill", {"seq": "q0", "tokens": [1]}, tenant="noisy")
    eng.submit("prefill", {"seq": "q1", "tokens": [1]}, tenant="noisy")
    with pytest.raises(TenantOverQuota):
        eng.submit("prefill", {"seq": "q2", "tokens": [1]}, tenant="noisy")
    eng.submit("prefill", {"seq": "q3", "tokens": [1]}, tenant="calm")
    eng.stop(drain=False)


def _traffic(n, seed):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(0, CFG.vocab,
                                           int(rng.integers(1, 7)))],
             int(rng.integers(4, 11))) for _ in range(n)]


def _serve(engine, live):
    """Prefill every sequence, then lockstep greedy decode rounds of all
    sequences with tokens left; returns each sequence's tokens."""
    futs = {s: engine.submit("prefill", {"seq": s, "tokens": p})
            for s, (p, _) in live.items()}
    toks = {s: [f.result(120).token] for s, f in futs.items()}
    left = {s: n - 1 for s, (_, n) in live.items()}
    while any(n > 0 for n in left.values()):
        fs = [(s, engine.submit("decode", {"seq": s}))
              for s, n in left.items() if n > 0]
        for s, f in fs:
            toks[s].append(f.result(120).token)
            left[s] -= 1
    for s in live:
        engine.submit("release", {"seq": s}).result(120)
    return toks


def test_decode_soak_no_capture(engine, params):
    """Mixed prefill/decode/release traffic crossing the capacity bucket:
    hundreds of requests, no capture or eager run, and spot-checked bit
    for bit against the eager reference."""
    base = engine.trace_counts()
    live = {f"soak-{i}": pn for i, pn in enumerate(_traffic(40, 7))}
    toks = _serve(engine, live)
    assert sum(n for _, n in live.values()) + len(live) >= 300
    for s in list(live)[:5]:
        prompt, n_new = live[s]
        want, _ = _eager_greedy(params, prompt, n_new, capacity=16)
        assert toks[s] == want
    assert engine.trace_counts() == base
    snap = engine.metrics.snapshot()
    assert snap["mean_batch"] > 1


def test_same_traffic_through_jax_engine(engine, jparams):
    """The same seeded traffic through the JAX package's engine and the
    port's: equal tokens for every sequence."""
    jart = j_build(jparams, j_get_config("lm-tiny"), datapath="int",
                   capacities=CAPS)
    jreg = JRegistry()
    jreg.register("int", jart, adapter=JAdapter(), default=True)
    jeng = JEngine(jreg, max_batch=8, buckets=BUCKETS)
    try:
        jeng.warmup()
        live = {f"x-{i}": pn for i, pn in enumerate(_traffic(12, 11))}
        want = _serve(jeng, live)
        assert j_generate(jeng, [[3, 14, 15]], 12) == \
            greedy_generate(engine, [[3, 14, 15]], 12)
    finally:
        jeng.stop()
    assert _serve(engine, live) == want


def test_multi_input_warmup_contract(art_int):
    dm = art_int.dm
    n = len(dm.input_names)
    with pytest.raises(ValueError, match="one batched example per input"):
        dm.warmup((1,), np.zeros((1,), np.int32))
    with pytest.raises(ValueError, match="batched"):
        dm.warmup((1,), tuple(np.zeros((), np.int32) for _ in range(n)))
    # a cache is consulted for every bucket not yet warm (the cache itself:
    # tests/test_torch_compile_cache.py): one without CompileCache's
    # interface is refused, never ignored
    ex = tuple(np.zeros((1,), np.int32) if nm in ("tokens", "pos")
               else np.zeros((1, CAPS[0], art_int.d_model), np.float32)
               for nm in dm.input_names)
    with pytest.raises(AttributeError, match="key"):
        dm.warmup((16,), ex, cache=object())
