"""The port's SSM (``mamba2-780m``) and hybrid (``zamba2-7b``) families on
the CPU, against the JAX package.

The same JAX parameter tree crosses with ``params_from_numpy``; the same
numpy tokens go through both packages at ``reduce_config`` size (d 64;
mamba2 2 Mamba2 blocks, zamba2 7 slots: 5 Mamba2 blocks and 2 invocations
of the shared attention+MLP block; SSM state 16, head dim 8, chunk 8),
float32 compute at bits 0, 8 and 4 and bf16 compute at w8 (``RUNS``).
The reference's init leaves ``dt_bias`` and ``conv_b`` zero and ``D`` and
``gnorm`` one; those leaves are drawn (``_trained_like``), so a fault in
their use shows.

* Each block, fed the reference's input to that block, gives the
  reference's output within ``BLOCK_ULPS`` bf16 roundings at the output's
  largest magnitude: one projection output at a rounding boundary moves
  by one ulp (0.0078 at |x| in [1, 2), beyond ``tests/test_torch_lm.py``'s
  atol 5e-3; 1.0 ulp was the most measured).  The same holds for the
  last decode step block by block from the reference's own state, and
  for every state leaf that step writes (Mamba2 conv and SSM state, the
  shared block's KV): measured 0 ulps for conv and KV, at most 0.001 ulp
  for the SSM state.
* End to end (``forward``, ``prefill``, every token of ``decode_step``
  and every cache leaf), within ``ULPS`` bf16 roundings at the compared
  tensor's largest magnitude.  Every projection of the reference is a bf16
  matmul whatever the compute dtype, and the chunked SSD (cumsums, the
  segment sums' exponentials, three-operand einsums) sums in another
  order than XLA:CPU, so where a value lies at a bf16 rounding boundary
  the two packages round it one ulp apart, and the next block amplifies
  the step (the gated RMSNorm, the softplus of dt and exp(dt A) in the
  scan).  On these inputs the largest difference is 2.25 ulps for mamba2
  and 4.5 ulps for zamba2 (a decode step's logits), held at 4 and 6: a
  margin of 1.8x and 1.3x.
* Decode equals the full-sequence forward inside the port within the
  reference's 2e-3 (``tests/test_archs.py``), on that test's own
  parameters and tokens, at bits 0, 8 and 4.
* ``loss_fn`` and its ``torch.autograd`` gradients against
  ``jax.value_and_grad`` in float32, on ``tests/test_archs.py``'s batch:
  the loss within rtol 1e-4 and every gradient leaf within ``GRAD_TOL``
  of its largest |gradient| (measured over seeds 0-2: 2.7e-3 for mamba2,
  1.2e-2 for zamba2).
* The pieces alone: ``_causal_conv``, ``_segsum``, softplus and
  ``mamba_apply`` (chunked and decode) against JAX; the chunked SSD
  against its own decode recurrence.

Faults these checks were seen to catch, each put into a copy of the port
alone: the decode step dropping ``D`` or ``dt_bias`` or leaving the conv
state stale (the end-to-end decode and cache check and the block-by-block
decode check fail in every run), a 1% error in the decode step's decay
exp(dt A) (the pieces and decode == forward fail; it stays within the
block tolerance of one step), zamba2 reading its position one past the
shared KV's length (the end-to-end decode check and decode == forward).
``F.softplus`` in place of ``logaddexp(x, 0)`` passes: in float32 the two
agree to rounding.
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

ARCHS = ["mamba2-780m", "zamba2-7b"]
# (arch, compute dtype, bits) held against the reference, end to end and
# block by block: every bit-width in float32 and the serving default (w8)
# in bf16; zamba2, whose blocks are mamba2's and the dense attention+MLP
# block (held at every bit-width in tests/test_torch_lm_families.py), at
# bits 0 and 4 in float32.  Each run costs the reference seconds of eager
# quantization and three XLA compiles (5-7 s for zamba2's layout).
RUNS = [("mamba2-780m", "float32", 0), ("mamba2-780m", "float32", 8),
        ("mamba2-780m", "float32", 4), ("mamba2-780m", "bfloat16", 8),
        ("zamba2-7b", "float32", 0), ("zamba2-7b", "float32", 4),
        ("zamba2-7b", "bfloat16", 8)]
B, S = 2, 16
BLOCK_ULPS = 2
ULPS = {"mamba2-780m": 4, "zamba2-7b": 6}
GRAD_TOL = {"mamba2-780m": 2.0 ** -6, "zamba2-7b": 2.0 ** -5}


def _cfgs(arch, compute_dtype="float32"):
    return (j_reduce(j_get_config(arch), compute_dtype=compute_dtype),
            reduce_config(get_config(arch), compute_dtype=compute_dtype))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(tree):
    return params_from_numpy(_np_tree(tree), device="cpu")


def _tensor(a):
    """A numpy array (bfloat16 from ``ml_dtypes`` too) as a CPU tensor of
    its dtype."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


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
    """Each block's (kind, input, output) along the reference's forward,
    every block run by its own jitted function."""
    x = jnp.take(jp["embed"], toks, axis=0).astype(jnp.dtype(jc.compute_dtype))
    pos = jnp.broadcast_to(jnp.arange(toks.shape[1], dtype=jnp.int32)[None],
                           toks.shape)
    mamba = jax.jit(lambda bp, x: jlm._mamba_block(bp, x, jc)[0])
    attn = jax.jit(lambda bp, x: jlm._attn_block(bp, x, jc, pos, None)[0])
    out, m = [], 0
    for kind in jlm._layer_kinds(jc):
        if kind == "mamba":
            y = mamba(jax.tree.map(lambda a: a[m], jp["mamba_blocks"]), x)
            m += 1
        else:
            y = attn(jp["shared_block"], x)
        out.append((kind, _f32(x), _f32(y)))
        x = y
    return out


def _trained_like(mamba, seed):
    """A Mamba2 parameter tree with its float leaves drawn as training
    leaves them.  The reference's init sets ``dt_bias`` and ``conv_b`` to
    zero and ``D`` and ``gnorm`` to one, so a port that dropped or
    misplaced one of them would agree with it; drawn, they count.
    ``dt_bias`` is Mamba2's inverse softplus of a dt in [1e-3, 0.1];
    leading axes (stacked blocks) are kept."""
    rng = np.random.default_rng(seed)

    def draw(shape, lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32))

    dt = np.exp(rng.uniform(np.log(1e-3), np.log(0.1),
                            mamba["dt_bias"].shape)).astype(np.float32)
    return dict(mamba, dt_bias=jnp.asarray(dt + np.log(-np.expm1(-dt))),
                A_log=jnp.log(draw(mamba["A_log"].shape, 1.0, 16.0)),
                D=draw(mamba["D"].shape, 0.5, 1.5),
                conv_b=draw(mamba["conv_b"].shape, -0.1, 0.1),
                gnorm={"g": draw(mamba["gnorm"]["g"].shape, 0.8, 1.2)})


@functools.lru_cache(maxsize=None)
def _jax_params(arch, bits):
    """The reference's parameters (key ``bits``) with the Mamba2 float
    leaves drawn (:func:`_trained_like`), serving-quantized at ``bits``:
    float32 whatever the compute dtype, so both dtypes share them (the
    reference's eager quantization costs seconds a tree)."""
    jp = jlm.init_params(jax.random.PRNGKey(bits), _cfgs(arch)[0])
    mb = jp["mamba_blocks"]
    jp = dict(jp, mamba_blocks=dict(mb, mamba=_trained_like(mb["mamba"],
                                                            bits)))
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


def _jax_decode_blocks(jp, jc, tok, cache):
    """One reference decode step from ``cache``, run block by block: each
    block's (kind, input, state before, output, state after), numpy."""
    x = jnp.take(jp["embed"], tok, axis=0).astype(jnp.dtype(jc.compute_dtype))
    mamba = jax.jit(lambda bp, x, st: jlm._mamba_block(bp, x, jc, state=st))
    attn = jax.jit(lambda bp, x, c: jlm._attn_block(
        bp, x, jc, jnp.full((B, 1), c["len"], jnp.int32), None, cache=c)[::2])
    out, m, s = [], 0, 0
    for kind in jlm._layer_kinds(jc):
        if kind == "mamba":
            st = jax.tree.map(lambda a: a[m], cache["mamba"])
            y, new = mamba(jax.tree.map(lambda a: a[m], jp["mamba_blocks"]),
                           x, st)
            m += 1
        else:
            st = jax.tree.map(lambda a: a[s], cache["shared"])
            y, new = attn(jp["shared_block"], x, st)
            s += 1
        out.append((kind, _f32(x), _np_tree(st), _f32(y), _np_tree(new)))
        x = y
    return out


def _jax_decode(r, arch, compute_dtype):
    """The reference's jitted decode step over the run's tokens: each
    step's logits and the final cache; the last step is also run block by
    block from the cache before it (``decode_blocks``)."""
    jc, _ = _cfgs(arch, compute_dtype)
    cache = jlm.init_cache(jc, B, S + 4, dtype=jnp.dtype(compute_dtype))
    step = jax.jit(lambda p, t, c: jlm.decode_step(p, t, c, jc))
    dec = []
    for t in range(S):
        tok = jnp.asarray(r["tokens"][:, t:t + 1])
        if t == S - 1:
            blocks = _jax_decode_blocks(r["jax_params"], jc, tok, cache)
        lt, cache = step(r["jax_params"], tok, cache)
        dec.append(np.asarray(lt))
    return {"decode": np.stack(dec, 1), "cache": _np_tree(cache),
            "decode_blocks": blocks}


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
# The two configs against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,compute_dtype,bits", RUNS)
def test_forward_and_prefill_equal_jax(ref, arch, compute_dtype, bits):
    r = ref(arch, compute_dtype, bits)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    toks = torch.from_numpy(r["tokens"])
    V, ulps = tc.vocab, ULPS[arch]
    tl, aux = tlm.forward(tp, {"tokens": toks}, tc)
    assert tl.dtype == getattr(torch, compute_dtype) and float(aux) == 0.0
    _ulp_close(tl[..., :V], r["forward"][..., :V], ulps, "forward")
    tpf = tlm.prefill(tp, {"tokens": toks}, tc)
    assert tuple(tpf.shape) == (B, tc.vocab_padded)
    _ulp_close(tpf[..., :V], r["prefill"][..., :V], ulps, "prefill")


@pytest.mark.parametrize("arch,compute_dtype,bits", RUNS)
def test_decode_steps_and_cache_equal_jax(ref, arch, compute_dtype, bits):
    """Every token's logits and, after the last, every cache leaf: the
    Mamba2 conv state (the in-projection's last 3 rows, in the cache
    dtype) and the float32 SSM state, zamba2's shared-block KV and
    lengths."""
    r = ref(arch, compute_dtype, bits, decode=True)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    toks = torch.from_numpy(r["tokens"])
    V, ulps = tc.vocab, ULPS[arch]
    cache = tlm.init_cache(tc, B, S + 4, dtype=getattr(torch, compute_dtype),
                           device="cpu")
    for t in range(S):
        lt, cache = tlm.decode_step(tp, toks[:, t:t + 1], cache, tc)
        _ulp_close(lt[..., :V], r["decode"][:, t, :V], ulps, f"step {t}")
    want = r["cache"]
    assert set(cache) == set(want)
    for path, got, exp in zip(tree_paths(cache), tree_flatten(cache)[0],
                              tree_flatten(want)[0]):
        if path.endswith("len"):
            np.testing.assert_array_equal(got.numpy(), exp)
        else:
            assert tuple(got.shape) == exp.shape, path
            _ulp_close(got, exp, ulps, path)
    assert cache["mamba"]["ssm"].dtype == torch.float32


@pytest.mark.parametrize("arch,compute_dtype,bits", RUNS)
def test_blocks_equal_jax_on_the_same_inputs(ref, arch, compute_dtype, bits):
    """Every block (Mamba2 and the shared attention+MLP block), fed the
    reference's input to it, gives the reference's output within
    ``BLOCK_ULPS`` bf16 roundings at the output's largest magnitude."""
    r = ref(arch, compute_dtype, bits)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    mblocks = tlm._stacked_views(tp["mamba_blocks"]) \
        if "mamba_blocks" in tp else []
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    m = 0
    for i, (kind, x, want) in enumerate(r["blocks"]):
        x = torch.from_numpy(x).to(getattr(torch, compute_dtype))
        if kind == "mamba":
            got, _ = tlm._mamba_block(mblocks[m], x, tc)
            m += 1
        else:
            got, _ = tlm._attn_block(tp["shared_block"], x, tc, pos)
        _ulp_close(got, want, BLOCK_ULPS, f"block {i} ({kind})")


@pytest.mark.parametrize("arch,compute_dtype,bits", RUNS)
def test_decode_blocks_and_state_equal_jax_from_its_state(
        ref, arch, compute_dtype, bits):
    """The last decode step block by block: each block, fed the
    reference's input and the reference's state before the step, gives
    the reference's output and writes the reference's state (the Mamba2
    conv and SSM state, the shared block's KV rows and length) within
    ``BLOCK_ULPS`` bf16 roundings at each leaf's largest magnitude."""
    r = ref(arch, compute_dtype, bits, decode=True)
    _, tc = _cfgs(arch, compute_dtype)
    tp = _carry(r["params"])
    mblocks = tlm._stacked_views(tp["mamba_blocks"])
    m = 0
    for i, (kind, x, st, want, want_st) in enumerate(r["decode_blocks"]):
        x = torch.from_numpy(x).to(getattr(torch, compute_dtype))
        st = {k: _tensor(v) for k, v in st.items()}
        if kind == "mamba":
            got, got_st = tlm._mamba_block(mblocks[m], x, tc, state=st)
            m += 1
        else:
            got, got_st = tlm._attn_block(tp["shared_block"], x, tc,
                                          st["len"].expand(B, 1), cache=st)
        what = f"block {i} ({kind})"
        _ulp_close(got, want, BLOCK_ULPS, what)
        assert tree_paths(got_st) == tree_paths(want_st), what
        for path, g, e in zip(tree_paths(got_st), tree_flatten(got_st)[0],
                              tree_flatten(want_st)[0]):
            assert tuple(g.shape) == e.shape and str(g.dtype) == \
                f"torch.{e.dtype}", f"{what} {path}: {g.dtype} {e.dtype}"
            if path == "len":
                np.testing.assert_array_equal(g.numpy(), e)
            else:
                _ulp_close(g, e, BLOCK_ULPS, f"{what} {path}")


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch, bits):
    """Token-by-token decode reproduces the full-sequence forward inside
    the port within the reference's 2e-3, on ``tests/test_archs.py``'s
    parameters (key 0) and tokens (key 1), float32 compute."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch):
    jc, tc = _cfgs(arch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tokens = jax.random.randint(jax.random.split(jax.random.PRNGKey(1), 3)[0],
                                (B, S), 0, jc.vocab)
    batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, axis=1)}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jc)))(jp, batch)
    leaves, unflatten = tree_flatten(_carry(jp))
    live = [leaf.requires_grad_(True) for leaf in leaves]
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss = tlm.loss_fn(unflatten(live), tb, tc)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-4)
    tgrads = torch.autograd.grad(tloss, live)
    want = tree_flatten(_np_tree(grads))[0]
    assert len(want) == len(tgrads)
    for path, got, exp in zip(tree_paths(_np_tree(jp)), tgrads, want):
        assert bool(torch.isfinite(got).all()), path
        scale = float(np.abs(exp).max())
        np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                                   atol=GRAD_TOL[arch] * scale, err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_reference(arch):
    """The port's own init has the reference tree's keys, shapes and dtypes
    (``mamba_blocks`` stacked, zamba2's one ``shared_block``) and the
    reference's constants."""
    jc, tc = _cfgs(arch)
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                  jlm.init_params(jax.random.PRNGKey(0), jc))
    tp = tlm.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    got = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tp)
    assert got == want
    m = tp["mamba_blocks"]["mamba"]
    jm = jlm.init_params(jax.random.PRNGKey(0), jc)["mamba_blocks"]["mamba"]
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(m[name].numpy(), np.asarray(jm[name]),
                                   rtol=1e-6, err_msg=name)
    assert abs(float(m["conv_w"].std()) - 0.1) < 0.02


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_the_tree_unchanged(arch):
    """``params_from_numpy`` is generic: the ``mamba_blocks`` and
    ``shared_block`` trees cross with their keys, shapes, dtypes and
    values, and ``params_to_numpy`` brings them back equal."""
    from repro_torch.convert import params_to_numpy

    jc, _ = _cfgs(arch)
    jp = _np_tree(j_quantize_tree(jlm.init_params(jax.random.PRNGKey(3), jc),
                                  4))
    tp = params_from_numpy(jp, device="cpu")
    assert tree_paths(tp) == tree_paths(jp)
    for a, b in zip(tree_flatten(tp)[0], tree_flatten(jp)[0]):
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    back = params_to_numpy(tp)
    assert all(np.array_equal(a, b) for a, b in
               zip(tree_flatten(back)[0], tree_flatten(jp)[0]))


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
def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_equals_jax(dtype, with_state):
    x, w, b = _rand((2, 5, 12), 0), _rand((4, 12), 1) * 0.1, _rand((12,), 2)
    st = _rand((2, 3, 12), 3) if with_state else None
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    jy, jst = JL._causal_conv(jx, jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    ty, tst = L._causal_conv(torch.from_numpy(x).to(getattr(torch, dtype)),
                             torch.from_numpy(w), torch.from_numpy(b),
                             None if st is None else torch.from_numpy(st))
    assert ty.dtype == torch.float32 and tst.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(_f32(tst), _f32(jst))


def test_segsum_and_softplus_equal_jax():
    a = -np.abs(_rand((2, 3, 8), 4))
    got, want = L._segsum(torch.from_numpy(a)), JL._segsum(jnp.asarray(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    assert not bool(torch.triu(got, 1).any())         # masked before the exp
    x = np.concatenate([_rand((64,), 5) * 30, [0.0, 25.0, -25.0, 80.0]]
                       ).astype(np.float32)
    np.testing.assert_allclose(L._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2e-7, atol=0)


def _block(arch="mamba2-780m", compute_dtype="float32", seed=6):
    jc, tc = _cfgs(arch, compute_dtype)
    jp = _trained_like(jax.tree.map(
        lambda a: a[0], jlm.init_params(jax.random.PRNGKey(seed), jc)
        ["mamba_blocks"]["mamba"]), seed)
    return jc, tc, jp, _carry(jp)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mamba_apply_equals_jax(compute_dtype):
    """One Mamba2 block, chunked over 3 chunks from a given state, then
    decode steps carrying the state: outputs and both state leaves."""
    jc, tc, jp, tp = _block(compute_dtype=compute_dtype)
    dt = jnp.dtype(compute_dtype)
    u = _rand((B, 24, jc.d_model), 7)
    di, N = jc.d_inner, jc.ssm_state
    state = {"conv": _rand((B, jc.ssm_conv - 1, di + 2 * N), 8),
             "ssm": _rand((B, jc.ssm_heads, jc.ssm_head_dim, N), 9) * 0.1}
    apply = jax.jit(lambda p, u, st: JL.mamba_apply(p, u, jc, state=st))
    jy, jst = apply(jp, jnp.asarray(u).astype(dt),
                    jax.tree.map(jnp.asarray, state))
    tst = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    ty, out_st = L.mamba_apply(tp, torch.from_numpy(u).to(getattr(torch, compute_dtype)),
                               tc, state=tst)
    assert out_st is tst                       # written in place
    _ulp_close(ty, jy, BLOCK_ULPS, "chunked")
    np.testing.assert_allclose(tst["ssm"].numpy(), np.asarray(jst["ssm"]),
                               rtol=1e-4, atol=1e-5)
    _ulp_close(tst["conv"], jst["conv"], BLOCK_ULPS, "conv state")
    for t in range(3):
        ut = _rand((B, 1, jc.d_model), 10 + t)
        jy, jst = apply(jp, jnp.asarray(ut).astype(dt), jst)
        ty, _ = L.mamba_apply(tp, torch.from_numpy(ut).to(
            getattr(torch, compute_dtype)), tc, state=tst)
        _ulp_close(ty, jy, BLOCK_ULPS, f"step {t}")
        np.testing.assert_allclose(tst["ssm"].numpy(),
                                   np.asarray(jst["ssm"]), rtol=1e-4,
                                   atol=1e-5)


def test_mamba_chunked_equals_its_decode_recurrence():
    """Inside the port: the chunked SSD over 24 positions (3 chunks)
    equals 24 decode steps from a zero state, outputs within the
    reference's 2e-3 and the final SSM state within float32 roundings;
    a chunked pass with a state carries on from where the steps stopped."""
    _, tc, _, tp = _block()
    u = torch.from_numpy(_rand((B, 24, tc.d_model), 11))
    full, none = L.mamba_apply(tp, u, tc)
    assert none is None
    di, N = tc.d_inner, tc.ssm_state

    def zero_state():
        return {"conv": torch.zeros((B, tc.ssm_conv - 1, di + 2 * N)),
                "ssm": torch.zeros((B, tc.ssm_heads, tc.ssm_head_dim, N))}

    st = zero_state()
    steps = [L.mamba_apply(tp, u[:, t:t + 1], tc, state=st)[0]
             for t in range(24)]
    np.testing.assert_allclose(_f32(torch.cat(steps, 1)), _f32(full),
                               rtol=2e-3, atol=2e-3)
    st2 = zero_state()
    L.mamba_apply(tp, u, tc, state=st2)
    np.testing.assert_allclose(st2["ssm"].numpy(), st["ssm"].numpy(),
                               rtol=1e-4, atol=1e-6)
    assert torch.equal(st2["conv"], st["conv"])
    nxt = torch.from_numpy(_rand((B, 8, tc.d_model), 12))
    whole, _ = L.mamba_apply(tp, torch.cat([u, nxt], 1), tc)
    tail, _ = L.mamba_apply(tp, nxt, tc, state=st2)
    np.testing.assert_allclose(_f32(tail), _f32(whole[:, 24:]),
                               rtol=2e-3, atol=2e-3)


def test_ssm_prefill_keeps_the_chunk_assertion():
    _, tc, _, tp = _block()
    u = torch.zeros((1, tc.ssm_chunk + 3, tc.d_model))
    with pytest.raises(AssertionError, match="ssm_chunk"):
        L.mamba_apply(tp, u, tc)
