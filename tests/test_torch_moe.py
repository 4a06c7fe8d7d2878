"""The port's MoE configs (``grok-1-314b``: 8 experts top-2;
``arctic-480b``: 128 experts top-2 with a parallel dense residual MLP) on
the CPU, against the JAX package.

The same JAX parameter tree crosses with ``params_from_numpy``; the same
numpy tokens go through both packages at ``reduce_config`` size (2
layers, d 64, 4 heads of 16, 4 experts top-2, capacity factor 8, so
nothing drops), float32 compute at bits 0 and 4 and bf16 compute at w8.

**What w8/w4 is held against.**  The reference's own serving tree fails
in its ``moe`` (``quantize_tree_for_serving`` turns the expert banks into
``{w_codes, w_scale}`` dicts that ``moe`` reads as arrays; pinned below).
So at bits 8 and 4 the port, which runs the reference's quantized tree
leaf for leaf, is held against the reference's unchanged ``forward`` and
``decode_step`` on that tree with the three banks replaced by their
dequantized float32 weights (``codes x scale``, int4 codes unpacked
first): the dequantized-leaf oracle.  Every other leaf stays codes.

**Routing.**  ``jax.lax.top_k`` orders the chosen experts by probability
with ties to the lower id; the port sorts stably.  Both packages' routes
are recorded (the reference's through ``jax.debug.callback``) and compared
directly: wherever the reference's top k+1 probabilities of a token are
apart by more than ``ROUTE_MARGIN`` (adjacent gaps; 1e-3 in float32,
1e-2 in bf16, where the two packages' router probabilities differ by up
to 1.3e-3 already at the first layer), the ordered expert ids must be
equal.  A route may differ only at a near-tie, where one bf16 rounding
of the router's input decides; the token then takes other experts and
every later position of its sequence sees that.  Logits and cache rows
are compared at the positions of each sequence before its first
differing route (at every position where no route differs).  Over both
configs, every combination and parameter seeds 0-2 (0 is the tests'
own), routes differed only in bf16 and only at seeds 1 and 2: in one
sequence each of grok at w8 and arctic at bits 0 and 8, from position 3,
6 or 14 on (one such first difference at a gap of 1.17e-3).

**Tolerances.**  Logits, cache rows and the layer's output within
``ULPS`` bf16 roundings at the compared tensor's largest magnitude (the
rule of ``tests/test_torch_lm_families.py``): every projection rounds to
bf16, so an accumulator at a rounding boundary moves one ulp and the
next layer carries it.  Measured over seeds 0-2 before any route
differs: at most 1.08 ulps in float32 and 2.75 in bf16; 4 leaves a
margin and still fails gates left unrenormalised or arctic without its
dense residual (checked on a mutated copy).  The aux loss (the Switch loss of the float32
router's probabilities, which inherit the bf16 differences of its input)
within ``AUX_RTOL`` 1e-3 where no route differs (1.6e-4 measured; on one
input, layer alone, within 1e-6).  The loss within ``LOSS_RTOL`` 1e-4
(2.7e-5 measured, on the reference's routes), gradients as
``tests/test_torch_lm_families.py``: within 2^-6 of each leaf's largest
|gradient|.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quant import unpack_int4 as j_unpack_int4  # noqa: E402
from repro.launch.steps import quantize_tree_for_serving as j_quantize_tree  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro.models.testing import reduce_config as j_reduce  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    init_serving_params,
    quantize_tree_for_serving,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.models.testing import reduce_config  # noqa: E402
from repro_torch.tree import tree_flatten, tree_paths  # noqa: E402

ARCHS = ["grok-1-314b", "arctic-480b"]
# every bit-width and both compute dtypes: float32 at bits 0 and 4, bf16 at
# w8 (the serving path, qmatmul's plain version); the tolerances below were
# measured over bits 0, 8 and 4 in both dtypes
COMBOS = [("float32", 0), ("float32", 4), ("bfloat16", 8)]
B, S = 2, 16
ULPS = 4
# the reference's router probabilities and the port's differ by up to
# 1.2e-4 in float32 and 1.3e-3 in bf16 at the first layer (seeds 0-2): a
# route may flip where two probabilities are closer than twice that
ROUTE_MARGIN = {"float32": 1e-3, "bfloat16": 1e-2}
AUX_RTOL = 1e-3
LOSS_RTOL = 1e-4
GRAD_TOL = 2.0 ** -6


def _cfgs(arch, compute_dtype="float32", **over):
    return (j_reduce(j_get_config(arch), compute_dtype=compute_dtype, **over),
            reduce_config(get_config(arch), compute_dtype=compute_dtype,
                          **over))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _ulp_close(got, want, ulps, what):
    """``got`` within ``ulps`` bf16 roundings at ``want``'s largest
    magnitude."""
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * ulp,
                               err_msg=what)


def _dequantized(leaf):
    codes, scale = leaf["w_codes"], leaf["w_scale"]
    if codes.shape[-1] != scale.shape[-1]:
        codes = j_unpack_int4(codes)
    return codes.astype(jnp.float32) * scale[..., None, :]


def oracle_tree(tree):
    """The reference's serving tree with the leaves its own ``moe`` and
    ``mla_attention`` cannot read replaced by their dequantized float32
    weights: the stacked expert banks of every ``moe`` dict, and MLA's
    ``wkv_b`` as ``{"w"}``."""
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "moe":
            out[k] = {n: _dequantized(leaf) if n in ("w_gate", "w_up",
                                                      "w_down")
                      and "w_codes" in leaf else oracle_tree(leaf)
                      for n, leaf in v.items()}
        elif k == "wkv_b" and "w_codes" in v:
            out[k] = {"w": _dequantized(v)}
        else:
            out[k] = oracle_tree(v)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch, bits):
    """The reference's parameters (key ``bits``), serving-quantized at
    ``bits`` (the tree the port runs) and its oracle (the tree the
    reference runs)."""
    jp = jlm.init_params(jax.random.PRNGKey(bits), _cfgs(arch)[0])
    if not bits:
        return jp, jp
    q = j_quantize_tree(jp, bits)
    return q, oracle_tree(q)


# ---------------------------------------------------------------------------
# Routes of both packages
# ---------------------------------------------------------------------------
def _recording_jax_moe(routes):
    """The reference's ``moe``, recording each call's router probabilities
    and ``top_k`` ids (the same ops it runs) through a debug callback."""
    orig = JL.moe

    def moe(p, x, cfg, wspec=None, aspec=None):
        flat = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(JL.dense(p["router"], flat, None,
                                        dtype=jnp.float32), axis=-1)
        _, idx = jax.lax.top_k(probs, cfg.moe_top_k)
        jax.debug.callback(lambda pr, ix: routes.append(
            (np.asarray(pr), np.asarray(ix))), probs, idx, ordered=True)
        return orig(p, x, cfg, wspec, aspec)

    return moe


def _recording_torch_route(routes):
    orig = L.moe_route

    def route(p, flat, cfg):
        probs, gates, idx = orig(p, flat, cfg)
        routes.append((probs.detach().numpy(), idx.numpy()))
        return probs, gates, idx

    return route


def _gaps(probs, k):
    """Each token's smallest gap between adjacent probabilities among its
    k + 1 largest: below it, which experts (or their order) win is a
    rounding's choice."""
    top = -np.sort(-probs, axis=-1)[:, :k + 1]
    return np.min(top[:, :-1] - top[:, 1:], axis=-1)


def first_divergence(jroutes, troutes, k, calls_per_step, seq_of_token,
                     margin):
    """Per sequence, the first step (a position of the forward, a decode
    step) at which the two packages route a token differently, or None.
    Asserts that the first differing route of each sequence lies at a
    near-tie (gap <= ``margin``).  ``calls_per_step`` groups the
    recorded calls (layers) of one step; ``seq_of_token(step, t)`` maps a
    token of a call to (sequence, position)."""
    assert len(jroutes) == len(troutes)
    first = {}
    for c, ((jp, ji), (_, ti)) in enumerate(zip(jroutes, troutes)):
        step = c // calls_per_step
        gaps = _gaps(jp, k)
        for t in np.nonzero((ji != ti).any(-1))[0]:
            b, pos = seq_of_token(step, t)
            if b in first and first[b][0] <= pos:
                continue
            assert gaps[t] <= margin, (
                f"call {c}, token {t}: routes {ji[t]} != {ti[t]} at a gap "
                f"{gaps[t]:.3g} > {margin}")
            first[b] = (pos, float(gaps[t]))
    return {b: first.get(b, (None,))[0] for b in range(B)}


# ---------------------------------------------------------------------------
# The reference's runs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ref():
    """The reference's forward, prefill and decode (with routes) per
    (arch, compute dtype, bits), on first use."""
    memo = {}

    def get(arch, compute_dtype, bits):
        key = (arch, compute_dtype, bits)
        if key in memo:
            return memo[key]
        jc, _ = _cfgs(arch, compute_dtype)
        q, oracle = _jax_params(arch, bits)
        toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)
                                                 ).astype(np.int32)
        fwd_routes, dec_routes = [], []
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(JL, "moe", _recording_jax_moe(fwd_routes))
            (logits, aux), pre = jax.jit(lambda p, t: (
                jlm.forward(p, {"tokens": t}, jc),
                jlm.prefill(p, {"tokens": t}, jc)))(oracle, jnp.asarray(toks))
            jax.effects_barrier()
            fwd_routes = fwd_routes[:jc.n_layers]   # the forward's calls
            mp.setattr(JL, "moe", _recording_jax_moe(dec_routes))
            cache = jlm.init_cache(jc, B, S + 4,
                                   dtype=jnp.dtype(compute_dtype))
            step = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jc))
            dec = []
            for t in range(S):
                lt, cache = step(oracle, jnp.asarray(toks[:, t:t + 1]),
                                 cache)
                dec.append(np.asarray(lt))
            jax.effects_barrier()
        finally:
            mp.undo()
        memo[key] = {"params": _np_tree(q), "tokens": toks,
                     "forward": np.asarray(logits), "aux": float(aux),
                     "prefill": np.asarray(pre), "routes": fwd_routes,
                     "decode": np.stack(dec, 1), "dec_routes": dec_routes,
                     "cache": _np_tree(cache)}
        return memo[key]

    return get


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_routes_equal_jax(ref, monkeypatch, arch,
                                              compute_dtype, bits):
    """``forward`` (logits and aux) and ``prefill`` against the reference
    (the oracle at bits 8 and 4); routes equal away from near-ties."""
    r = ref(arch, compute_dtype, bits)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    if bits:
        assert set(tp["blocks"]["moe"]["w_gate"]) == {"w_codes", "w_scale"}
    toks = torch.from_numpy(r["tokens"])
    routes = []
    monkeypatch.setattr(L, "moe_route", _recording_torch_route(routes))
    tl, aux = tlm.forward(tp, {"tokens": toks}, tc)
    tpf = tlm.prefill(tp, {"tokens": toks}, tc)
    first = first_divergence(r["routes"], routes[:tc.n_layers],
                             tc.moe_top_k, tc.n_layers,
                             lambda _, t: divmod(int(t), S),
                             ROUTE_MARGIN[compute_dtype])
    V = tc.vocab
    assert tl.dtype == getattr(torch, compute_dtype)
    for b, stop in first.items():
        _ulp_close(tl[b, :stop, :V], r["forward"][b, :stop, :V], ULPS,
                   f"forward, sequence {b}")
        if stop is None:
            _ulp_close(tpf[b, :V], r["prefill"][b, :V], ULPS,
                       f"prefill, sequence {b}")
    if all(stop is None for stop in first.values()):
        np.testing.assert_allclose(float(aux), r["aux"], rtol=AUX_RTOL)


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache_equal_jax(ref, monkeypatch, arch,
                                          compute_dtype, bits):
    """Every step's logits, then the KV cache rows and lengths, against
    the reference's jitted ``decode_step``; routes as in the forward."""
    r = ref(arch, compute_dtype, bits)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    toks = torch.from_numpy(r["tokens"])
    cache = tlm.init_cache(tc, B, S + 4, dtype=getattr(torch, compute_dtype),
                           device="cpu")
    routes, logits = [], []
    monkeypatch.setattr(L, "moe_route", _recording_torch_route(routes))
    for t in range(S):
        lt, cache = tlm.decode_step(tp, toks[:, t:t + 1], cache, tc)
        logits.append(lt)
    first = first_divergence(r["dec_routes"], routes, tc.moe_top_k,
                             tc.n_layers, lambda step, t: (int(t), step),
                             ROUTE_MARGIN[compute_dtype])
    V = tc.vocab
    got = torch.stack(logits, 1)
    for b, stop in first.items():
        _ulp_close(got[b, :stop, :V], r["decode"][b, :stop, :V], ULPS,
                   f"decode, sequence {b}")
        for path, leaf, exp in zip(tree_paths(cache), tree_flatten(cache)[0],
                                   tree_flatten(r["cache"])[0]):
            if path.endswith("len"):
                np.testing.assert_array_equal(leaf.numpy(), exp)
            else:
                _ulp_close(leaf[:, b, :stop], exp[:, b, :stop], ULPS, path)


# ---------------------------------------------------------------------------
# The layer alone, with and without dropped tokens
# ---------------------------------------------------------------------------
def _layer_inputs(arch, compute_dtype, bits, cf, shape, seed=3):
    jc, tc = _cfgs(arch, compute_dtype, moe_capacity_factor=cf)
    jp = jlm.init_params(jax.random.PRNGKey(seed), jc)
    moe = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    q = j_quantize_tree({"moe": moe}, bits)["moe"] if bits else moe
    x = (np.random.default_rng(seed).standard_normal((*shape, jc.d_model))
         * 0.5).astype(np.float32)
    return jc, tc, q, x


@pytest.mark.parametrize("compute_dtype,bits,cf,shape", [
    *((cd, bits, 8.0, (B, S)) for cd, bits in COMBOS),
    ("float32", 0, 1.25, (4, 1)), ("bfloat16", 8, 1.25, (4, 1))])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_layer_equals_jax(arch, compute_dtype, bits, cf, shape):
    """``layers.moe`` on one random input: output, aux and the routes
    against the reference (its oracle at bits 8 and 4).  At capacity
    factor 1.25 on a decode step of 4 tokens (C = 2 per expert; the card
    runs C = 1) choices drop, in both packages alike.  On the same input
    the routes are equal at every token (the smallest gap among these
    tokens' top 3 probabilities is 1.0e-3 at cf 8, 3.5e-3 at the decode
    shape), the output within 2 ulps (1 measured) and the aux within rtol
    1e-6 (2.4e-7 measured over seeds 3-5)."""
    jc, tc, q, x = _layer_inputs(arch, compute_dtype, bits, cf, shape)
    jd, td = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    jx = jnp.asarray(x).astype(jd)
    jy, jaux = jax.jit(lambda p, x: JL.moe(p, x, jc))(
        oracle_tree({"moe": q})["moe"], jx)
    tx = torch.from_numpy(x).to(td)
    tq = _carry(q)
    ty, taux = L.moe(tq, tx, tc)
    assert ty.dtype == td and tuple(ty.shape) == x.shape
    T = shape[0] * shape[1]
    _, _, tidx = L.moe_route(tq, tx.reshape(T, -1), tc)
    jprobs = jax.nn.softmax(JL.dense(q["router"], jx.reshape(T, -1), None,
                                     dtype=jnp.float32), -1)
    _, jidx = jax.lax.top_k(jprobs, tc.moe_top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if cf < 8:
        C = max(int(cf * T * tc.moe_top_k / tc.moe_experts), 1)
        assert _dropped([(None, np.asarray(jidx))], tc.moe_experts, C) > 0
    _ulp_close(ty, jy, 2, "moe output")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def _dropped(routes, experts, capacity):
    """Choices past capacity over the recorded calls."""
    return sum(int(np.maximum(np.bincount(idx.ravel(), minlength=experts)
                              - capacity, 0).sum()) for _, idx in routes)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_end_to_end_equal_jax(arch, monkeypatch):
    """Capacity factor 1.25, float32, bits 0: the forward (C = 20 over 32
    tokens x 2 choices) and the decode steps (C = 1 over a step's 2 tokens
    x 2 choices: one drops whenever both tokens pick one expert) against
    the reference, with choices dropped on both paths."""
    jc, tc = _cfgs(arch, moe_capacity_factor=1.25)
    jp = jlm.init_params(jax.random.PRNGKey(4), jc)
    tp = _carry(jp)
    toks = np.random.default_rng(5).integers(0, jc.vocab, (B, S)
                                             ).astype(np.int32)
    routes = []
    monkeypatch.setattr(L, "moe_route", _recording_torch_route(routes))
    jl = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jc)[0])(
        jp, jnp.asarray(toks))
    tl, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _ulp_close(tl[..., :jc.vocab], np.asarray(jl)[..., :jc.vocab], ULPS,
               "forward")
    fwd_drops = _dropped(routes, tc.moe_experts,
                         int(1.25 * B * S * tc.moe_top_k / tc.moe_experts))
    routes.clear()
    cache = jlm.init_cache(jc, B, S, dtype=jnp.float32)
    tcache = tlm.init_cache(tc, B, S, dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jc))
    for t in range(S):
        jt, cache = step(jp, jnp.asarray(toks[:, t:t + 1]), cache)
        tt, tcache = tlm.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                     tcache, tc)
        _ulp_close(tt[:, :jc.vocab], np.asarray(jt)[:, :jc.vocab], ULPS,
                   f"decode step {t}")
    assert fwd_drops > 0 and _dropped(routes, tc.moe_experts, 1) > 0


# ---------------------------------------------------------------------------
# Loss, gradients, decode == forward
# ---------------------------------------------------------------------------
def _archs_batch(jc):
    """``tests/test_archs.py``'s batch: tokens and next-token labels."""
    tokens = jax.random.randint(jax.random.split(jax.random.PRNGKey(1),
                                                 3)[0], (B, S), 0, jc.vocab)
    return {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}


def _pinned_route(jroutes, margin):
    """``layers.moe_route`` taking the reference's recorded expert ids (its
    gates from the port's own probabilities, as ``moe_route`` renormalises
    them), after checking that any id it replaces lay at a near-tie."""
    calls = iter(jroutes)
    orig = L.moe_route

    def route(p, flat, cfg):
        probs, _, idx = orig(p, flat, cfg)
        jprobs, jidx = next(calls)
        gaps = _gaps(jprobs, cfg.moe_top_k)
        differ = (idx.numpy() != jidx).any(-1)
        assert (gaps[differ] <= margin).all(), gaps[differ]
        jidx = torch.from_numpy(np.asarray(jidx, np.int64))
        gates = torch.gather(probs, -1, jidx)
        gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
        return probs, gates, jidx

    return route


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch, monkeypatch):
    """``loss_fn`` (cross-entropy + 0.01 x the summed aux) and its
    gradients, router included, against ``jax.value_and_grad``: the loss
    within ``LOSS_RTOL``, every leaf within 2^-6 of its largest
    |gradient|.  The port runs on the routes the reference took in that
    same run: on this batch arctic's second layer routes one token apart
    at a gap of 6.7e-6 (within ``ROUTE_MARGIN``), and a token on other
    experts has other gradients."""
    jc, tc = _cfgs(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    batch = _archs_batch(jc)
    jroutes = []
    monkeypatch.setattr(JL, "moe", _recording_jax_moe(jroutes))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jc)))(jp, batch)
    jax.effects_barrier()
    assert len(jroutes) == tc.n_layers
    monkeypatch.setattr(L, "moe_route", _pinned_route(
        jroutes, ROUTE_MARGIN["float32"]))
    leaves, unflatten = tree_flatten(_carry(jp))
    live = [leaf.requires_grad_(True) for leaf in leaves]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss = tlm.loss_fn(unflatten(live), tb, tc)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_RTOL)
    tgrads = torch.autograd.grad(tloss, live)
    want = tree_flatten(_np_tree(grads))[0]
    paths = tree_paths(_np_tree(jp))
    assert any("router" in p for p in paths)
    for path, got, exp in zip(paths, tgrads, want):
        scale = float(np.abs(exp).max())
        np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=path)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, bits):
    """Token-by-token decode reproduces the full-sequence forward inside
    the port within the reference's 2e-3 (``tests/test_archs.py``; no
    token drops at capacity factor 8), float32 compute."""
    jc, cfg = _cfgs(arch)
    params = _carry(jlm.init_params(jax.random.PRNGKey(0), jc))
    if bits:
        params = quantize_tree_for_serving(params, bits)
    toks = torch.from_numpy(np.asarray(_archs_batch(jc)["tokens"]
                                       ).astype(np.int32))
    full, _ = tlm.forward(params, {"tokens": toks}, cfg)
    cache = tlm.init_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = tlm.decode_step(params, toks[:, t:t + 1], cache, cfg)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1)[..., :cfg.vocab].numpy(),
                               full[..., :cfg.vocab].numpy(), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# Serving quantization, the serving init, the reference's failure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_tree_equals_reference(arch, bits):
    """The port's serving tree equals the reference's leaf for leaf: the
    expert banks' codes per expert and column, the router, the attention
    and arctic's dense residual, codes bit for bit, scales exactly."""
    jc, _ = _cfgs(arch)
    jp = jlm.init_params(jax.random.PRNGKey(2), jc)
    want = _np_tree(j_quantize_tree(jp, bits))
    got = quantize_tree_for_serving(_carry(jp), bits)
    assert tree_paths(got) == tree_paths(want)
    assert "blocks/moe/w_down/w_codes" in tree_paths(got)
    for path, a, b in zip(tree_paths(got), tree_flatten(got)[0],
                          tree_flatten(want)[0]):
        assert a.dtype == torch.from_numpy(np.asarray(b)).dtype, path
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_serving_params_equals_quantized_init(arch, bits):
    """Banks drawn into codes one expert at a time equal the float draw
    quantized afterwards, bit for bit, and hold no float bank."""
    _, tc = _cfgs(arch)
    got = init_serving_params(torch.Generator().manual_seed(7), tc, bits,
                              device="cpu")
    want = quantize_tree_for_serving(tlm.init_params(
        torch.Generator().manual_seed(7), tc, device="cpu"), bits)
    assert tree_paths(got) == tree_paths(want)
    for path, a, b in zip(tree_paths(got), tree_flatten(got)[0],
                          tree_flatten(want)[0]):
        assert torch.equal(a, b), path
    assert got["blocks"]["moe"]["w_gate"]["w_codes"].dtype == torch.int8


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_moe_fails_on_its_serving_tree(arch):
    """Pinned: the reference's ``decode_step`` on its own w8 serving tree
    raises in ``moe`` (the banks are ``{w_codes, w_scale}`` dicts).  The
    day the reference is repaired this fails, and the oracle above can go."""
    jc, _ = _cfgs(arch)
    q = j_quantize_tree(jlm.init_params(jax.random.PRNGKey(0), jc), 8)
    cache = jlm.init_cache(jc, B, 4, dtype=jnp.float32)
    with pytest.raises(AttributeError, match="astype"):
        jlm.decode_step(q, jnp.zeros((B, 1), jnp.int32), cache, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_and_config_match_reference(arch):
    jc, tc = _cfgs(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jlm.init_params(jax.random.PRNGKey(0), jc))
    tp = tlm.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    got = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert got == want


def test_params_from_numpy_carries_the_moe_tree():
    """arctic's tree (banks, router, dense residual), float and w4 codes,
    crosses unchanged: the same paths, dtypes and values."""
    jc, _ = _cfgs("arctic-480b")
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    for tree in (jp, j_quantize_tree(jp, 4)):
        want = _np_tree(tree)
        got = params_from_numpy(want, device="cpu")
        assert tree_paths(got) == tree_paths(want)
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            np.testing.assert_array_equal(a.numpy(), b)
            assert a.numpy().dtype == b.dtype


@pytest.mark.parametrize("arch,bits", [("grok-1-314b", 8),
                                       ("arctic-480b", 4)])
def test_serve_cli_runs_reduced_on_the_cpu(arch, bits, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced --bits
    N --device cpu``: 16 greedy tokens for 4 sequences, in the
    vocabulary."""
    from repro_torch.launch import serve

    ids = serve.main(["--arch", arch, "--reduced", "--bits", str(bits),
                      "--device", "cpu"])
    assert tuple(ids.shape) == (4, 16)
    assert bool(((ids >= 0) & (ids < reduce_config(get_config(arch)).vocab)
                 ).all())
    assert f"serving at w{bits}" in capsys.readouterr().out
