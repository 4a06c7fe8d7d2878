"""The port's audio encoder-decoder (``whisper-tiny``: a bidirectional
encoder over precomputed frame embeddings, a decoder with causal
self-attention, cross-attention and gelu MLPs, LayerNorm, learned
positions, a tied head) on the CPU, against the JAX package.

The same JAX parameter tree crosses with ``params_from_numpy``; the same
numpy frames and tokens go through both packages at ``reduce_config``
size (2 encoder + 2 decoder layers, d 64, 4 heads of 16, 12 frames,
vocab 97, max_seq 64), float32 compute at bits 0 and 4 and bf16
compute at w8.  The reference runs its own serving tree here
(whisper has no MoE bank or MLA leaf), so every bit-width is held
against its unchanged functions.

Tolerances: bf16 ulps at the compared tensor's largest magnitude (the
rule of ``tests/test_torch_lm_families.py``; every projection rounds to
bf16).  Measured over seeds 0-2: at most 0.85 ulp in float32 and 2.5
in bf16, held at ``ULPS`` = 4, which still fails a decode step that
reads its learned position one row late, or LayerNorm's epsilon at 1e-3
(checked on a mutated copy).  LayerNorm alone in float32 within 1e-6.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch.steps import quantize_tree_for_serving as j_quantize_tree  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import whisper as jw  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro.models.testing import reduce_config as j_reduce  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    model_module,
    quantize_tree_for_serving,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import whisper as tw  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.models.testing import reduce_config  # noqa: E402
from repro_torch.tree import tree_flatten, tree_paths  # noqa: E402

ARCH = "whisper-tiny"
# every bit-width and both compute dtypes: float32 at bits 0 and 4, bf16 at
# w8 (the serving path, qmatmul's plain version); the tolerances below were
# measured over bits 0, 8 and 4 in both dtypes
COMBOS = [("float32", 0), ("float32", 4), ("bfloat16", 8)]
B, S = 2, 10
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


def _params(bits, seed=None):
    jp = jw.init_params(jax.random.PRNGKey(bits if seed is None else seed),
                        _cfgs()[0])
    return j_quantize_tree(jp, bits) if bits else jp


def _inputs(jc, seed=1):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((B, jc.enc_seq, jc.d_model)) * 0.5
              ).astype(np.float32)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    return frames, toks


@pytest.fixture(scope="module")
def ref():
    memo = {}

    def get(compute_dtype, bits):
        key = (compute_dtype, bits)
        if key in memo:
            return memo[key]
        jc, _ = _cfgs(compute_dtype)
        jp = _params(bits)
        frames, toks = _inputs(jc)
        cd = jnp.dtype(compute_dtype)
        enc, logits, pre = jax.jit(lambda p, f, t: (
            jw.encode(p, f, jc), jw.forward(p, {"frames": f, "tokens": t},
                                            jc)[0],
            jw.prefill(p, {"frames": f, "tokens": t}, jc)))(
            jp, jnp.asarray(frames), jnp.asarray(toks))
        cross = jax.jit(lambda p, e: jw.build_cross_cache(p, e, jc, cd))(
            jp, enc)
        cache = jw.init_cache(jc, B, S + 2, dtype=cd)
        cache = {"self": cache["self"], "cross": cross}
        step = jax.jit(lambda p, t, c: jw.decode_step(p, t, c, jc))
        dec = []
        for t in range(S):
            lt, cache = step(jp, jnp.asarray(toks[:, t:t + 1]), cache)
            dec.append(np.asarray(lt))
        memo[key] = {"params": _np_tree(jp), "frames": frames,
                     "tokens": toks,
                     "encode": np.asarray(enc.astype(jnp.float32)),
                     "forward": np.asarray(logits), "prefill": np.asarray(pre),
                     "cross": _np_tree(cross), "decode": np.stack(dec, 1),
                     "cache": _np_tree(cache)}
        return memo[key]

    return get


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
def test_encode_forward_and_prefill_equal_jax(ref, compute_dtype, bits):
    r = ref(compute_dtype, bits)
    _, tc = _cfgs(compute_dtype)
    tp = _carry(r["params"])
    if bits:
        assert "w_codes" in tp["dec_blocks"]["cross_attn"]["wk"]
    frames = torch.from_numpy(r["frames"])
    batch = {"frames": frames, "tokens": torch.from_numpy(r["tokens"])}
    td = getattr(torch, compute_dtype)
    enc = tw.encode(tp, frames, tc)
    assert enc.dtype == td
    _ulp_close(enc, r["encode"], ULPS, "encode")
    tl, aux = tw.forward(tp, batch, tc)
    assert tl.dtype == td and float(aux) == 0.0
    V = tc.vocab
    _ulp_close(tl[..., :V], r["forward"][..., :V], ULPS, "forward")
    _ulp_close(tw.prefill(tp, batch, tc)[..., :V], r["prefill"][..., :V],
               ULPS, "prefill")


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
def test_cross_cache_and_decode_steps_equal_jax(ref, compute_dtype, bits):
    """``build_cross_cache`` of the reference's encoder output, then every
    ``decode_step``'s logits, then the self cache (rows, lengths) and the
    cross cache it carries unchanged."""
    r = ref(compute_dtype, bits)
    _, tc = _cfgs(compute_dtype)
    tp = _carry(r["params"])
    td = getattr(torch, compute_dtype)
    cross = tw.build_cross_cache(tp, torch.from_numpy(r["encode"]).to(td),
                                 tc, dtype=td)
    for name in ("k", "v"):
        assert cross[name].dtype == td
        _ulp_close(cross[name], r["cross"][name], ULPS, f"cross {name}")
    cache = tw.init_cache(tc, B, S + 2, dtype=td, device="cpu")
    cache = {"self": cache["self"], "cross": cross}
    toks = torch.from_numpy(r["tokens"])
    for t in range(S):
        lt, cache = tw.decode_step(tp, toks[:, t:t + 1], cache, tc)
        _ulp_close(lt[..., :tc.vocab], r["decode"][:, t, :tc.vocab], ULPS,
                   f"step {t}")
    assert cache["cross"] is cross
    for path, got, exp in zip(tree_paths(cache), tree_flatten(cache)[0],
                              tree_flatten(r["cache"])[0]):
        if path.endswith("len"):
            np.testing.assert_array_equal(got.numpy(), exp)
        else:
            _ulp_close(got, exp, ULPS, path)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_equals_jax(dtype):
    x = (np.random.default_rng(2).standard_normal((3, 5, 64)) * 2 + 0.3
         ).astype(np.float32)
    g = np.random.default_rng(3).uniform(0.5, 1.5, 64).astype(np.float32)
    b = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = JL.layernorm({"g": jnp.asarray(g), "b": jnp.asarray(b)},
                        jnp.asarray(x).astype(jd))
    got = L.layernorm({"g": torch.from_numpy(g), "b": torch.from_numpy(b)},
                      torch.from_numpy(x).to(td))
    assert got.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    else:
        _ulp_close(got, want, 1, "bf16 layernorm")
    init = L.layernorm_init(64, (2,))
    assert tuple(init["g"].shape) == (2, 64) and float(init["b"].abs().sum()) \
        == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_modes_equal_jax(dtype):
    """``attention`` with ``kv_source`` (k, v from the encoder output, no
    rotation even for a rope config), against a cache without ``len`` (q
    alone), and with ``kv_source`` beside a cache that has a length (the
    cache's k and v are read, the projections unused)."""
    jc, tc = _cfgs(dtype)
    jc, tc = (dataclasses.replace(c, pos="rope") for c in (jc, tc))
    jp = jax.tree.map(lambda a: a[0], _params(0, seed=9)["dec_blocks"]
                      ["cross_attn"])
    tp = _carry(jp)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 3, jc.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, jc.enc_seq, jc.d_model)).astype(np.float32)
    kc = rng.standard_normal((B, jc.enc_seq, jc.n_kv_heads, jc.hd)
                             ).astype(np.float32)
    vc = rng.standard_normal(kc.shape).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, dtype=np.int32) + 5, (B, 3))
    J = _jit_attention(jc)
    tpos = torch.from_numpy(np.ascontiguousarray(pos))
    tx, tenc = torch.from_numpy(x).to(td), torch.from_numpy(enc).to(td)
    jx, jenc = jnp.asarray(x).astype(jd), jnp.asarray(enc).astype(jd)
    jcache = {"k": jnp.asarray(kc).astype(jd), "v": jnp.asarray(vc).astype(jd)}
    tcache = {"k": torch.from_numpy(kc).to(td),
              "v": torch.from_numpy(vc).to(td)}
    cases = {
        "kv_source": (J(jp, jx, pos, None, jenc),
                      L.attention(tp, tx, tc, tpos, causal=False,
                                  kv_source=tenc)),
        "cache without len": (J(jp, jx, pos, jcache, None),
                              L.attention(tp, tx, tc, tpos, causal=False,
                                          cache=tcache)),
        "kv_source and a cache with len": (
            J(jp, jx, pos, dict(jcache, len=jnp.int32(4)), jenc),
            L.attention(tp, tx, tc, tpos, causal=False, kv_source=tenc,
                        cache=dict(tcache, len=torch.tensor(4,
                                                            dtype=torch.int32)))),
    }
    for what, ((jy, jnew), (ty, tnew)) in cases.items():
        assert jnew is None and tnew is None, what
        assert str(ty.dtype) == f"torch.{jy.dtype}", what
        _ulp_close(ty, jy, ULPS, what)


def _jit_attention(jc):
    def run(p, x, pos, cache, kv_source):
        return JL.attention(p, x, jc, pos, causal=False, cache=cache,
                            kv_source=kv_source)

    return jax.jit(run)


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_decode_steps_match_decode(bits):
    """Token-by-token ``decode_step`` against the cross cache reproduces
    ``decode``'s logits at every position inside the port within the
    reference's 2e-3 (``tests/test_archs.py``), float32 compute."""
    jc, tc = _cfgs()
    tp = _carry(jw.init_params(jax.random.PRNGKey(0), jc))
    if bits:
        tp = quantize_tree_for_serving(tp, bits)
    frames, toks = _inputs(jc, seed=3)
    enc = tw.encode(tp, torch.from_numpy(frames), tc)
    full = tw.decode(tp, torch.from_numpy(toks), enc, tc)
    cache = tw.init_cache(tc, B, S, dtype=torch.float32, device="cpu")
    cache["cross"] = tw.build_cross_cache(tp, enc, tc, dtype=torch.float32)
    outs = []
    for t in range(S):
        logits, cache = tw.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]),
                                       cache, tc)
        outs.append(logits)
    np.testing.assert_allclose(torch.stack(outs, 1)[..., :tc.vocab].numpy(),
                               full[..., :tc.vocab].numpy(), rtol=2e-3,
                               atol=2e-3)


def test_positions_clamp_as_the_reference():
    """Past the learned table (``max_seq`` 64) the decode step reads its
    last row, and ``decode(position_offset=)`` its last S rows, as
    ``dynamic_slice_in_dim`` clamps: a step at length 66 and a decode at
    offset 60 against the reference."""
    jc, tc = _cfgs()
    jp = _params(0, seed=11)
    tp = _carry(jp)
    frames, toks = _inputs(jc, seed=12)
    enc = jw.encode(jp, jnp.asarray(frames), jc)
    cache = jw.init_cache(jc, B, 70, dtype=jnp.float32)
    cache = {"self": dict(cache["self"], len=jnp.full((jc.n_layers,), 66,
                                                      jnp.int32)),
             "cross": jw.build_cross_cache(jp, enc, jc, jnp.float32)}
    jl, _ = jax.jit(lambda p, t, c: jw.decode_step(p, t, c, jc))(
        jp, jnp.asarray(toks[:, :1]), cache)
    tcache = {k: {n: torch.from_numpy(np.array(v)) for n, v in c.items()}
              for k, c in _np_tree(cache).items()}
    tl, tnew = tw.decode_step(tp, torch.from_numpy(toks[:, :1]), tcache, tc)
    _ulp_close(tl[:, :tc.vocab], np.asarray(jl)[:, :tc.vocab], ULPS,
               "step at 66")
    assert tnew["self"]["len"].tolist() == [67] * tc.n_layers
    jd = jw.decode(jp, jnp.asarray(toks), enc, jc, position_offset=60)
    td = tw.decode(tp, torch.from_numpy(toks), torch.from_numpy(
        np.asarray(enc)), tc, position_offset=60)
    _ulp_close(td[..., :tc.vocab], np.asarray(jd)[..., :tc.vocab], ULPS,
               "decode at offset 60")


def test_loss_and_gradients_equal_jax():
    """``loss_fn`` and its gradients (encoder, decoder, positions)
    against ``jax.value_and_grad``: the loss within rtol 1e-4, every leaf
    within 2^-6 of its largest |gradient|."""
    jc, tc = _cfgs()
    jp = jw.init_params(jax.random.PRNGKey(0), jc)
    frames, toks = _inputs(jc, seed=5)
    batch = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
             "labels": jnp.roll(jnp.asarray(toks), -1, axis=1)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jw.loss_fn(p, b, jc)))(jp, batch)
    leaves, unflatten = tree_flatten(_carry(jp))
    live = [leaf.requires_grad_(True) for leaf in leaves]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss = tw.loss_fn(unflatten(live), tb, tc)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    for path, got, exp in zip(tree_paths(_np_tree(jp)),
                              torch.autograd.grad(tloss, live),
                              tree_flatten(_np_tree(grads))[0]):
        np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(exp).max()),
                                   err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_equals_reference(bits):
    jc, _ = _cfgs()
    jp = jw.init_params(jax.random.PRNGKey(2), jc)
    want = _np_tree(j_quantize_tree(jp, bits))
    got = quantize_tree_for_serving(_carry(jp), bits)
    assert tree_paths(got) == tree_paths(want)
    for path, a, b in zip(tree_paths(got), tree_flatten(got)[0],
                          tree_flatten(want)[0]):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
    assert "pos_dec" in got and got["pos_dec"].dtype == torch.float32


def test_init_params_cache_and_config_match_reference():
    jc, tc = _cfgs()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert model_module(tc) is tw

    def shapes(tree, torch_tree=False):
        return jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
            tree)

    tp = tw.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    assert shapes(tp) == shapes(jw.init_params(jax.random.PRNGKey(0), jc))
    assert shapes(tw.init_cache(tc, B, 8, device="cpu")) == \
        shapes(jw.init_cache(jc, B, 8))


def test_params_from_numpy_carries_the_whisper_tree():
    jc, _ = _cfgs()
    jp = jw.init_params(jax.random.PRNGKey(0), jc)
    for tree in (jp, j_quantize_tree(jp, 8)):
        want = _np_tree(tree)
        got = params_from_numpy(want, device="cpu")
        assert tree_paths(got) == tree_paths(want)
        assert {p.split("/")[0] for p in tree_paths(got)} >= {
            "enc_blocks", "dec_blocks", "pos_enc", "pos_dec"}
        for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            np.testing.assert_array_equal(a.numpy(), b)
            assert a.numpy().dtype == b.dtype


@pytest.mark.parametrize("bits", [0, 8])
def test_serve_cli_runs_reduced_on_the_cpu(bits, capsys):
    """The reference's loop, mirrored: 16 greedy tokens for 4 sequences
    against a zero cross cache (the loop builds none)."""
    from repro_torch.launch import serve

    ids = serve.main(["--arch", ARCH, "--reduced", "--bits", str(bits),
                      "--device", "cpu"])
    assert tuple(ids.shape) == (4, 16)
    assert bool(((ids >= 0) & (ids < reduce_config(get_config(ARCH)).vocab)
                 ).all())
    assert ("serving at w8" in capsys.readouterr().out) == bool(bits)


def test_generate_with_a_cross_cache_equals_the_decode_steps():
    """``generate(cross=)`` (eager on the CPU) feeds an utterance's cross
    k/v: its tokens are the greedy tokens of ``decode_step`` over the
    same cache, and differ from the zero-cross loop's."""
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import greedy

    jc, tc = _cfgs()
    tp = _carry(_params(8, seed=13))
    frames, toks = _inputs(jc, seed=14)
    enc = tw.encode(tp, torch.from_numpy(frames), tc)
    cross = tw.build_cross_cache(tp, enc, tc, dtype=torch.float32)
    prompt = toks[:, :3]
    got = generate(tp, tc, prompt, 6, device="cpu", cross=cross)
    cache = tw.init_cache(tc, B, 10, dtype=torch.float32, device="cpu")
    cache["cross"] = {k: v.clone() for k, v in cross.items()}
    out = []
    for t in range(9):
        feed = torch.from_numpy(prompt[:, t:t + 1]) if t < 3 else tok
        logits, cache = tw.decode_step(tp, feed, cache, tc)
        tok = greedy(logits, tc)[:, None]
        if t >= 3:
            out.append(tok)
    assert torch.equal(got, torch.cat(out, 1))
    zero = generate(tp, tc, prompt, 6, device="cpu")
    assert not torch.equal(zero, got)
