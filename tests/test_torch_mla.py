"""The port's MLA config (``minicpm3-4b``: multi-head latent attention with
a compressed cache of the latent ``c_kv`` and one shared rope key
``k_pe``) on the CPU, against the JAX package.

The same JAX parameter tree crosses with ``params_from_numpy``; the same
numpy tokens go through both packages at ``reduce_config`` size (2
layers, d 64, 4 heads of 16 + 8 rope dims, q rank 24, kv rank 16, v
head 16, prefill chunk 8), float32 compute at bits 0 and 4 and bf16
compute at w8.

**What w8/w4 is held against.**  The reference's ``mla_attention`` reads
``p["wkv_b"]["w"]``, which its own ``quantize_tree_for_serving`` has
replaced by codes (``KeyError``, pinned below).  At bits 8 and 4 the
port runs the reference's quantized tree leaf for leaf and is held
against the reference's unchanged functions on that tree with ``wkv_b``
alone replaced by ``{"w": codes x scale}`` in float32 (int4 unpacked
first): the dequantized-leaf oracle.  The port dequantizes the same
leaf the same way for its two einsums.

**Tolerances** (bf16 ulps at the compared tensor's largest magnitude,
the rule of ``tests/test_torch_lm_families.py``): logits and cache leaves
within ``ULPS``; measured over seeds 0-2 at most 1.07 ulps in float32 and
2.38 in bf16, so 4 leaves a margin and still fails scores scaled by
1/sqrt(hd) instead of 1/sqrt(hd + rd) (checked on a mutated copy).  The absorbed
decode and the expanded prefill round differently, so decode against the
port's own forward is held at the reference's 2e-3
(``tests/test_archs.py``), and each against JAX at ``ULPS``.
"""

import dataclasses

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
from repro_torch.launch.steps import quantize_tree_for_serving  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.models.testing import reduce_config  # noqa: E402
from repro_torch.tree import tree_flatten, tree_paths  # noqa: E402

ARCH = "minicpm3-4b"
# every bit-width and both compute dtypes: float32 at bits 0 and 4, bf16 at
# w8 (the serving path, qmatmul's plain version); the tolerances below were
# measured over bits 0, 8 and 4 in both dtypes
COMBOS = [("float32", 0), ("float32", 4), ("bfloat16", 8)]
B, S = 2, 16
ULPS = 4
GRAD_TOL = 2.0 ** -6


def _cfgs(compute_dtype="float32", **over):
    return (j_reduce(j_get_config(ARCH), compute_dtype=compute_dtype, **over),
            reduce_config(get_config(ARCH), compute_dtype=compute_dtype,
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
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(max(scale, 1e-30))) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps * ulp,
                               err_msg=what)


def oracle_tree(tree):
    """The reference's serving tree with every ``wkv_b`` of codes replaced
    by ``{"w": codes x scale}`` in float32."""
    if not isinstance(tree, dict):
        return tree
    if "wkv_b" in tree and "w_codes" in tree["wkv_b"]:
        leaf = tree["wkv_b"]
        codes, scale = leaf["w_codes"], leaf["w_scale"]
        if codes.shape[-1] != scale.shape[-1]:
            codes = j_unpack_int4(codes)
        tree = dict(tree, wkv_b={
            "w": codes.astype(jnp.float32) * scale[..., None, :]})
    return {k: oracle_tree(v) if k != "wkv_b" else v
            for k, v in tree.items()}


def _jax_trees(bits, seed=None):
    jp = jlm.init_params(jax.random.PRNGKey(bits if seed is None else seed),
                         _cfgs()[0])
    if not bits:
        return jp, jp
    q = j_quantize_tree(jp, bits)
    return q, oracle_tree(q)


@pytest.fixture(scope="module")
def ref():
    memo = {}

    def get(compute_dtype, bits):
        key = (compute_dtype, bits)
        if key in memo:
            return memo[key]
        jc, _ = _cfgs(compute_dtype)
        q, oracle = _jax_trees(bits)
        toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)
                                                 ).astype(np.int32)
        logits, pre = jax.jit(lambda p, t: (
            jlm.forward(p, {"tokens": t}, jc)[0],
            jlm.prefill(p, {"tokens": t}, jc)))(oracle, jnp.asarray(toks))
        cache = jlm.init_cache(jc, B, S + 4, dtype=jnp.dtype(compute_dtype))
        step = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jc))
        dec = []
        for t in range(S):
            lt, cache = step(oracle, jnp.asarray(toks[:, t:t + 1]), cache)
            dec.append(np.asarray(lt))
        memo[key] = {"params": _np_tree(q), "tokens": toks,
                     "forward": np.asarray(logits), "prefill": np.asarray(pre),
                     "decode": np.stack(dec, 1), "cache": _np_tree(cache)}
        return memo[key]

    return get


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
def test_forward_and_prefill_equal_jax(ref, compute_dtype, bits):
    r = ref(compute_dtype, bits)
    _, tc = _cfgs(compute_dtype)
    tp = _carry(r["params"])
    if bits:
        assert "w_codes" in tp["blocks"]["attn"]["wkv_b"]
    toks = torch.from_numpy(r["tokens"])
    tl, aux = tlm.forward(tp, {"tokens": toks}, tc)
    assert tl.dtype == getattr(torch, compute_dtype) and float(aux) == 0.0
    V = tc.vocab
    _ulp_close(tl[..., :V], r["forward"][..., :V], ULPS, "forward")
    _ulp_close(tlm.prefill(tp, {"tokens": toks}, tc)[..., :V],
               r["prefill"][..., :V], ULPS, "prefill")


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
def test_decode_steps_and_cache_equal_jax(ref, compute_dtype, bits):
    """Every absorbed decode step's logits, then the compressed cache
    (``c_kv``, ``k_pe``) and its lengths."""
    r = ref(compute_dtype, bits)
    _, tc = _cfgs(compute_dtype)
    tp = _carry(r["params"])
    toks = torch.from_numpy(r["tokens"])
    cache = tlm.init_cache(tc, B, S + 4, dtype=getattr(torch, compute_dtype),
                           device="cpu")
    assert set(cache["attn"]) == {"c_kv", "k_pe", "len"}
    for t in range(S):
        lt, cache = tlm.decode_step(tp, toks[:, t:t + 1], cache, tc)
        _ulp_close(lt[..., :tc.vocab], r["decode"][:, t, :tc.vocab], ULPS,
                   f"step {t}")
    for path, got, exp in zip(tree_paths(cache), tree_flatten(cache)[0],
                              tree_flatten(r["cache"])[0]):
        if path.endswith("len"):
            np.testing.assert_array_equal(got.numpy(), exp)
        else:
            _ulp_close(got, exp, ULPS, path)


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
def test_mla_attention_equals_jax(compute_dtype, bits):
    """``layers.mla_attention`` alone in its three modes: the expanded form
    without a cache, a prefill that fills the compressed cache (rows 0-15
    of 20), and the absorbed decode of one token at row 16, each output
    and cache leaf against the reference."""
    jc, tc = _cfgs(compute_dtype)
    q, oracle = _jax_trees(bits, seed=5)
    jp = jax.tree.map(lambda a: a[0], oracle["blocks"]["attn"])
    tp = _carry(jax.tree.map(lambda a: a[0], q["blocks"]["attn"]))
    jd, td = jnp.dtype(compute_dtype), getattr(torch, compute_dtype)
    x = (np.random.default_rng(6).standard_normal((B, S + 1, jc.d_model))
         * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (B, S + 1))
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    tpos = torch.from_numpy(np.ascontiguousarray(pos))

    def jcache():
        return jax.tree.map(lambda a: a[0], jlm.init_cache(jc, B, S + 4, jd)
                            ["attn"])

    def tcache():
        return tlm._kv_layer(tlm.init_cache(tc, B, S + 4, td,
                                            device="cpu")["attn"], 0)

    jy, _ = jax.jit(lambda p, x: JL.mla_attention(p, x, jc, pos[:, :S]))(
        jp, jx[:, :S])
    ty, none = L.mla_attention(tp, tx[:, :S], tc, tpos[:, :S])
    assert none is None
    _ulp_close(ty, jy, ULPS, "expanded")
    jy, jc1 = jax.jit(lambda p, x, c: JL.mla_attention(
        p, x, jc, pos[:, :S], cache=c))(jp, jx[:, :S], jcache())
    tc1 = tcache()
    ty, tnew = L.mla_attention(tp, tx[:, :S], tc, tpos[:, :S], cache=tc1)
    _ulp_close(ty, jy, ULPS, "prefill with cache")
    assert tnew["c_kv"] is tc1["c_kv"] and int(tnew["len"]) == S
    jy, jc2 = jax.jit(lambda p, x, c: JL.mla_attention(
        p, x, jc, pos[:, S:], cache=c))(jp, jx[:, S:], jc1)
    ty, tnew = L.mla_attention(tp, tx[:, S:], tc, tpos[:, S:], cache=tnew)
    _ulp_close(ty, jy, ULPS, "absorbed decode")
    for name in ("c_kv", "k_pe"):
        _ulp_close(tnew[name], jc2[name], ULPS, name)
    assert int(tnew["len"]) == int(jc2["len"]) == S + 1


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_matches_forward(bits):
    """The absorbed decode reproduces the expanded forward inside the port
    within the reference's 2e-3 (``tests/test_archs.py``'s parameters and
    tokens), float32 compute."""
    jc, cfg = _cfgs()
    params = _carry(jlm.init_params(jax.random.PRNGKey(0), jc))
    if bits:
        params = quantize_tree_for_serving(params, bits)
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.split(jax.random.PRNGKey(1), 3)[0], (B, S), 0,
        cfg.vocab)).astype(np.int32))
    full, _ = tlm.forward(params, {"tokens": toks}, cfg)
    cache = tlm.init_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = tlm.decode_step(params, toks[:, t:t + 1], cache, cfg)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1)[..., :cfg.vocab].numpy(),
                               full[..., :cfg.vocab].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_chunked_prefill_forward_equals_jax():
    """At S = 32 > 2 x prefill_chunk the expanded MLA takes the chunked
    attention (v padded to hd + rd and sliced back) in both packages."""
    jc, tc = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(7), jc)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (B, 32)
                                             ).astype(np.int32)
    jl = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jc)[0])(
        jp, jnp.asarray(toks))
    tl, _ = tlm.forward(_carry(jp), {"tokens": torch.from_numpy(toks)}, tc)
    _ulp_close(tl[..., :jc.vocab], np.asarray(jl)[..., :jc.vocab], ULPS,
               "chunked")


def test_loss_and_gradients_equal_jax():
    """``loss_fn`` and its gradients (the latent projections and
    ``wkv_b`` included) against ``jax.value_and_grad``: the loss within
    rtol 1e-4, every leaf within 2^-6 of its largest |gradient|."""
    jc, tc = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tokens = jax.random.randint(jax.random.split(jax.random.PRNGKey(1),
                                                 3)[0], (B, S), 0, jc.vocab)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jc)))(jp, batch)
    leaves, unflatten = tree_flatten(_carry(jp))
    live = [leaf.requires_grad_(True) for leaf in leaves]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss = tlm.loss_fn(unflatten(live), tb, tc)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    for path, got, exp in zip(tree_paths(_np_tree(jp)),
                              torch.autograd.grad(tloss, live),
                              tree_flatten(_np_tree(grads))[0]):
        np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(exp).max()),
                                   err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_and_dequantized_wkv_b_equal_reference(bits):
    """The serving tree equals the reference's leaf for leaf (codes bit
    for bit, ``wkv_b`` among them), and ``dense_weight`` of the port's
    ``wkv_b`` equals the oracle's float32 leaf bit for bit."""
    jc, _ = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(2), jc)
    jq = j_quantize_tree(jp, bits)
    want = _np_tree(jq)
    got = quantize_tree_for_serving(_carry(jp), bits)
    assert tree_paths(got) == tree_paths(want)
    for path, a, b in zip(tree_paths(got), tree_flatten(got)[0],
                          tree_flatten(want)[0]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    np.testing.assert_array_equal(
        L.dense_weight(got["blocks"]["attn"]["wkv_b"]).numpy(),
        np.asarray(oracle_tree(jq)["blocks"]["attn"]["wkv_b"]["w"]))


def test_reference_mla_fails_on_its_serving_tree():
    """Pinned: the reference's ``decode_step`` on its own w8 serving tree
    raises ``KeyError: 'w'`` in ``mla_attention``.  The day the reference
    is repaired this fails, and the oracle above can go."""
    jc, _ = _cfgs()
    q = j_quantize_tree(jlm.init_params(jax.random.PRNGKey(0), jc), 8)
    cache = jlm.init_cache(jc, B, 4, dtype=jnp.float32)
    with pytest.raises(KeyError, match="'w'"):
        jlm.decode_step(q, jnp.zeros((B, 1), jnp.int32), cache, jc)


def test_init_params_tree_and_config_match_reference():
    jc, tc = _cfgs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jlm.init_params(jax.random.PRNGKey(0), jc))
    tp = tlm.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    got = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert got == want
    cache = tlm.init_cache(tc, B, 8, device="cpu")["attn"]
    jcache = jlm.init_cache(jc, B, 8)["attn"]
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}


def test_params_from_numpy_carries_the_mla_tree():
    jc, _ = _cfgs()
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    for tree in (jp, j_quantize_tree(jp, 4)):
        want = _np_tree(tree)
        got = params_from_numpy(want, device="cpu")
        assert tree_paths(got) == tree_paths(want)
        assert "blocks/attn/wkv_b/" + ("w" if tree is jp else "w_codes") \
            in tree_paths(got)
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            np.testing.assert_array_equal(a.numpy(), b)
            assert a.numpy().dtype == b.dtype


@pytest.mark.parametrize("bits", [8, 4])
def test_serve_cli_runs_reduced_on_the_cpu(bits, capsys):
    from repro_torch.launch import serve

    ids = serve.main(["--arch", ARCH, "--reduced", "--bits", str(bits),
                      "--device", "cpu"])
    assert tuple(ids.shape) == (4, 16)
    assert bool(((ids >= 0) & (ids < reduce_config(get_config(ARCH)).vocab)
                 ).all())
    assert f"serving at w{bits}" in capsys.readouterr().out
