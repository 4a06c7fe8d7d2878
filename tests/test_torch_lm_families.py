"""The port's vision-language (``qwen2-vl-7b``: M-RoPE, a patch-embedding
prefix) and untied-head dense (``qwen3-14b``: qk-norm; ``phi3-medium-14b``)
configs on the CPU, against the JAX package, with chunked prefill
attention.

The same JAX parameter tree crosses with ``params_from_numpy``; the same
numpy tokens go through both packages at ``reduce_config`` size (2
layers, d 64, 4 heads of 16, 2 KV heads, vocab 97, prefill chunk 8),
float32 compute at bits 0, 8 and 4 and bf16 compute at w8.  The
untied head of a float32 model at bits 8 and 4 is the reference's float32
product of the codes (``layers.dense``), not ``qmatmul``.

* Each block, fed the reference's input to that block, gives the
  reference's output within ``BLOCK_ULPS`` bf16 roundings at the output's
  largest magnitude: one projection output at a rounding boundary moves
  by one ulp, beyond ``tests/test_torch_lm.py``'s atol 5e-3 once |x|
  reaches 1 (0.53 ulp was the most measured over 3 seeds x bits 0/8/4 x
  both dtypes).
* End to end (``forward``, ``prefill``, every token of ``decode_step``
  and the KV cache), within ``ULPS`` bf16 roundings at the compared
  tensor's largest magnitude.  Every projection is a bf16 matmul whatever
  the compute dtype; most runs agree within 5e-7 in float32, but where an
  accumulator lies at a bf16 rounding boundary the two packages round it
  one ulp apart and the next layer carries the step.  The untied heads
  give logits up to 2.7 (qwen2.5-3b's tied head stays under 1), so one
  bf16 ulp there is 0.0156: over 12 seeds x bits 0/8/4 x both dtypes the
  largest difference was 0.014 in float32 and 0.023 in bf16 (1.5 ulps).
* Decode equals the full-sequence forward inside the port within the
  reference's 2e-3 (``tests/test_archs.py``), on that test's own
  parameters and tokens, at bits 0, 8 and 4.
* ``loss_fn`` (with qwen2-vl's vision prefix, which carries no loss) and
  its ``torch.autograd`` gradients against ``jax.value_and_grad`` in
  float32 on ``tests/test_archs.py``'s batch: the loss within rtol 1e-4
  (2e-5 measured), every gradient leaf within 2^-6 of its largest
  |gradient| (7.3e-3 measured over seeds 0-2).
* The pieces alone: ``apply_mrope`` against JAX and against RoPE at t ==
  h == w; ``_chunked_sdpa`` against JAX and against ``_sdpa``; a forward
  long enough to take the chunked attention; the float32 product of codes.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

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

ARCHS = ["qwen2-vl-7b", "qwen3-14b", "phi3-medium-14b"]
# (compute dtype, bits) held against the reference, end to end and block
# by block: every bit-width in float32, the serving default (w8) in bf16
COMBOS = [("float32", 0), ("float32", 8), ("float32", 4), ("bfloat16", 8)]
B, S = 2, 16
BLOCK_ULPS = 2
ULPS = 4
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


def _jax_blocks(jp, jc, toks):
    """Each block's (input, output) along the reference's forward, every
    block run by one jitted function."""
    x = jnp.take(jp["embed"], toks, axis=0).astype(jnp.dtype(jc.compute_dtype))
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32)[None],
                           toks.shape)
    pos3 = jlm._positions3_for({}, jc, pos)
    block = jax.jit(lambda bp, x: jlm._attn_block(bp, x, jc, pos, pos3)[0])
    out = []
    for i in range(jc.n_layers):
        y = block(jax.tree.map(lambda a: a[i], jp["blocks"]), x)
        out.append((_f32(x), _f32(y)))
        x = y
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch, bits):
    """The reference's parameters (key ``bits``), serving-quantized at
    ``bits``: float32 whatever the compute dtype, so both dtypes share
    them (the reference's eager quantization costs seconds a tree)."""
    jp = jlm.init_params(jax.random.PRNGKey(bits), _cfgs(arch)[0])
    return j_quantize_tree(jp, bits) if bits else jp


def _jax_run(arch, compute_dtype, bits):
    jc, _ = _cfgs(arch, compute_dtype)
    jp = _jax_params(arch, bits)
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, S)
                                             ).astype(np.int32)
    both = jax.jit(lambda p, t: (jlm.forward(p, {"tokens": t}, jc)[0],
                                 jlm.prefill(p, {"tokens": t}, jc)))
    logits, pre = both(jp, jnp.asarray(toks))
    return {"jax_params": jp, "params": _np_tree(jp), "tokens": toks,
            "forward": np.asarray(logits), "prefill": np.asarray(pre),
            "blocks": _jax_blocks(jp, jc, jnp.asarray(toks))}


def _jax_decode(r, arch, compute_dtype):
    """The reference's jitted decode step over the run's tokens: each
    step's logits and the final cache."""
    jc, _ = _cfgs(arch, compute_dtype)
    cache = jlm.init_cache(jc, B, S + 4, dtype=jnp.dtype(compute_dtype))
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jc))
    dec = []
    for t in range(S):
        lt, cache = step(r["jax_params"], jnp.asarray(r["tokens"][:, t:t + 1]),
                         cache)
        dec.append(np.asarray(lt))
    return {"decode": np.stack(dec, 1), "cache": _np_tree(cache)}


@pytest.fixture(scope="module")
def ref():
    """The reference's results per (arch, compute dtype, bits), computed
    once, on first use; ``decode=True`` adds its decode steps."""
    memo = {}

    def get(arch, compute_dtype, bits, decode=False):
        key = (arch, compute_dtype, bits)
        if key not in memo:
            memo[key] = _jax_run(arch, compute_dtype, bits)
        r = memo[key]
        if decode and "decode" not in r:
            r.update(_jax_decode(r, arch, compute_dtype))
        return r

    return get


# ---------------------------------------------------------------------------
# The three configs against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_equal_jax(ref, arch, compute_dtype, bits):
    r = ref(arch, compute_dtype, bits)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    toks = torch.from_numpy(r["tokens"])
    V = tc.vocab
    if bits:
        assert "w_codes" in tp["lm_head"]              # the untied head
    tl, aux = tlm.forward(tp, {"tokens": toks}, tc)
    assert tl.dtype == getattr(torch, compute_dtype) and float(aux) == 0.0
    _ulp_close(tl[..., :V], r["forward"][..., :V], ULPS, "forward")
    tpf = tlm.prefill(tp, {"tokens": toks}, tc)
    assert tuple(tpf.shape) == (B, tc.vocab_padded)
    _ulp_close(tpf[..., :V], r["prefill"][..., :V], ULPS, "prefill")


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache_equal_jax(ref, arch, compute_dtype, bits):
    """Every token's logits (M-RoPE at the cache length for qwen2-vl) and,
    after the last, the KV cache and its lengths."""
    r = ref(arch, compute_dtype, bits, decode=True)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    toks = torch.from_numpy(r["tokens"])
    cache = tlm.init_cache(tc, B, S + 4, dtype=getattr(torch, compute_dtype),
                           device="cpu")
    for t in range(S):
        lt, cache = tlm.decode_step(tp, toks[:, t:t + 1], cache, tc)
        _ulp_close(lt[..., :tc.vocab], r["decode"][:, t, :tc.vocab], ULPS,
                   f"step {t}")
    want = r["cache"]
    assert set(cache) == set(want) == {"attn"}
    for path, got, exp in zip(tree_paths(cache), tree_flatten(cache)[0],
                              tree_flatten(want)[0]):
        if path.endswith("len"):
            np.testing.assert_array_equal(got.numpy(), exp)
        else:
            _ulp_close(got, exp, ULPS, path)


@pytest.mark.parametrize("compute_dtype,bits", COMBOS)
@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_equal_jax_on_the_same_inputs(ref, arch, compute_dtype, bits):
    """Every attention+MLP block (M-RoPE for qwen2-vl, qk-norm for qwen3),
    fed the reference's input to it, gives the reference's output within
    ``BLOCK_ULPS`` bf16 roundings at the output's largest magnitude."""
    r = ref(arch, compute_dtype, bits)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    pos3 = tlm._positions3_for({}, tc, pos)
    layers = tlm._stacked_views(tp["blocks"])
    for i, (bp, (x, want)) in enumerate(zip(layers, r["blocks"])):
        got, _ = tlm._attn_block(
            bp, torch.from_numpy(x).to(getattr(torch, compute_dtype)), tc,
            pos, positions3=pos3)
        _ulp_close(got, want, BLOCK_ULPS, f"block {i}")


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, bits):
    """Token-by-token decode reproduces the full-sequence forward inside
    the port within the reference's 2e-3, on ``tests/test_archs.py``'s
    parameters (key 0) and tokens (key 1), float32 compute, text only."""
    jc, cfg = _cfgs(arch)
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


def _archs_batch(jc):
    """``tests/test_archs.py``'s batch: tokens, next-token labels, and
    for the vision-language config a prefix of patch embeddings."""
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    tokens = jax.random.randint(ks[0], (B, S), 0, jc.vocab)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
    if jc.family == "vlm":
        batch["patch_embeds"] = jax.random.normal(
            ks[2], (B, jc.vision_patches, jc.d_model), jnp.float32) * 0.02
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch):
    jc, tc = _cfgs(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    batch = _archs_batch(jc)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jc)))(jp, batch)
    leaves, unflatten = tree_flatten(_carry(jp))
    live = [leaf.requires_grad_(True) for leaf in leaves]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss = tlm.loss_fn(unflatten(live), tb, tc)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    tgrads = torch.autograd.grad(tloss, live)
    want = tree_flatten(_np_tree(grads))[0]
    for path, got, exp in zip(tree_paths(_np_tree(jp)), tgrads, want):
        scale = float(np.abs(exp).max())
        np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                                   atol=GRAD_TOL * scale, err_msg=path)


def test_vision_prefix_and_mrope_streams_equal_jax():
    """qwen2-vl with a prefix of 6 patch embeddings and position streams
    that differ (t, h, w of a 2 x 3 patch grid, then text): the forward's
    logits (prefix included) and ``prefill`` against the reference."""
    jc, tc = _cfgs("qwen2-vl-7b")
    jp = jlm.init_params(jax.random.PRNGKey(5), jc)
    tp = _carry(jp)
    P = jc.vision_patches
    toks = np.random.default_rng(2).integers(0, jc.vocab, (B, S)
                                             ).astype(np.int32)
    patches = (np.random.default_rng(3).standard_normal(
        (B, P, jc.d_model)) * 0.02).astype(np.float32)
    t_ids = np.concatenate([np.zeros(P), 2 + np.arange(S)])
    h_ids = np.concatenate([np.repeat(np.arange(2), 3), 2 + np.arange(S)])
    w_ids = np.concatenate([np.tile(np.arange(3), 2), 2 + np.arange(S)])
    pos3 = np.broadcast_to(np.stack([t_ids, h_ids, w_ids])[:, None],
                           (3, B, P + S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches),
          "positions3": jnp.asarray(pos3)}
    tb = {"tokens": torch.from_numpy(toks),
          "patch_embeds": torch.from_numpy(patches),
          "positions3": torch.from_numpy(np.ascontiguousarray(pos3))}
    jl, jpre = jax.jit(lambda p, b: (jlm.forward(p, b, jc)[0],
                                     jlm.prefill(p, b, jc)))(jp, jb)
    tl, _ = tlm.forward(tp, tb, tc)
    assert tuple(tl.shape) == (B, P + S, jc.vocab_padded)
    _ulp_close(tl[..., :jc.vocab], np.asarray(jl)[..., :jc.vocab], ULPS,
               "forward")
    _ulp_close(tlm.prefill(tp, tb, tc)[:, :jc.vocab],
               np.asarray(jpre)[:, :jc.vocab], ULPS, "prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    jc, tc = _cfgs(arch)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jlm.init_params(jax.random.PRNGKey(0), jc))
    tp = tlm.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    got = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert got == want
    assert "lm_head" in tp and "embed_head" not in \
        tlm.with_head_copy(tp, tc)                    # untied: no copy


@pytest.mark.parametrize("arch", ARCHS)
def test_reduce_config_equals_reference(arch):
    jc, tc = _cfgs(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_reduced_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced --bits 8
    --device cpu``: 16 greedy tokens for 4 sequences, in the vocabulary."""
    from repro_torch.launch import serve

    ids = serve.main(["--arch", arch, "--reduced", "--bits", "8",
                      "--device", "cpu"])
    assert tuple(ids.shape) == (4, 16)
    assert bool(((ids >= 0) & (ids < reduce_config(get_config(arch)).vocab)
                 ).all())
    assert "serving at w8" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The pieces alone
# ---------------------------------------------------------------------------
def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_equals_jax_and_rope_on_text(hd):
    """Distinct t/h/w streams against the reference (the section bounds
    of hd/2 = 8 and 64 pairs: 2/5/8 and 16/40/64); at t == h == w the
    port's M-RoPE is its RoPE bit for bit."""
    x = _rand((2, 5, 4, hd), 0)
    pos3 = np.random.default_rng(1).integers(0, 50, (3, 2, 5)
                                             ).astype(np.int32)
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6)
    want = jax.jit(lambda x, p: JL.apply_mrope(x, p, 1e6))(
        jnp.asarray(x), jnp.asarray(pos3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pos = torch.from_numpy(pos3[0])
    assert torch.equal(L.apply_mrope(torch.from_numpy(x),
                                     pos[None].expand(3, 2, 5), 1e4),
                       L.apply_rope(torch.from_numpy(x), pos, 1e4))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_sdpa_equals_jax_and_plain_attention(dtype):
    """Flash-style attention at S = 4 x chunk, GQA (4 heads over 2 KV
    heads), causal: against the reference's ``_chunked_sdpa`` (which
    scans the blocks past the diagonal and discards them) and against the
    port's plain ``_sdpa``."""
    chunk, Sq = 8, 32
    q, k, v = (_rand((2, Sq, 4, 16), 2), _rand((2, Sq, 2, 16), 3),
               _rand((2, Sq, 2, 16), 4))
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    got = L._chunked_sdpa(tq, tk, tv, chunk)
    assert got.dtype == td and tuple(got.shape) == q.shape
    want = jax.jit(lambda q, k, v: JL._chunked_sdpa(q, k, v, chunk))(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)
    np.testing.assert_allclose(_f32(got), _f32(L._sdpa(tq, tk, tv, True)),
                               **tol)


def test_chunked_prefill_forward_equals_jax():
    """qwen3 at S = 32 > 2 x prefill_chunk: the forward takes the chunked
    attention in both packages; logits against the reference, and against
    the port's plain attention (prefill_chunk 64)."""
    jc, tc = _cfgs("qwen3-14b")
    jp = jlm.init_params(jax.random.PRNGKey(7), jc)
    tp = _carry(jp)
    toks = np.random.default_rng(4).integers(0, jc.vocab, (B, 32)
                                             ).astype(np.int32)
    jl = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jc)[0])(
        jp, jnp.asarray(toks))
    tl, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _ulp_close(tl[..., :jc.vocab], np.asarray(jl)[..., :jc.vocab], ULPS,
               "chunked")
    plain, _ = tlm.forward(tp, {"tokens": torch.from_numpy(toks)},
                           dataclasses.replace(tc, prefill_chunk=64))
    _ulp_close(tl[..., :jc.vocab], plain[..., :jc.vocab], ULPS, "plain")


@pytest.mark.parametrize("bits", [8, 4])
def test_float32_dense_on_codes_equals_jax(bits):
    """The untied quantized head of a float32 model: x and the codes in
    float32, a float32 product, times the scale, against the reference's
    ``dense``; in bf16 the same leaf runs ``qmatmul``."""
    w = _rand((48, 96), 5) * 0.1
    x = _rand((3, 48), 6)
    jq = JL.quantize_dense_for_serving({"w": jnp.asarray(w)}, bits)
    tq = L.quantize_dense_for_serving({"w": torch.from_numpy(w)}, bits)
    got = L.dense(tq, torch.from_numpy(x), dtype=torch.float32)
    jdense = jax.jit(JL.dense, static_argnames="dtype")
    want = jdense(jq, jnp.asarray(x), dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    bf = L.dense(tq, torch.from_numpy(x))
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(bf), _f32(jdense(jq, jnp.asarray(x))),
                               rtol=1e-2, atol=1e-2)
