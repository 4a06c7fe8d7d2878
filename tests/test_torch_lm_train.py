"""The port's LM training path against the JAX package, on the CPU.

On ``reduce_config(qwen2.5-3b)`` (float32 compute, tied head, QKV bias,
swiglu, 2 layers) and on ``lm-tiny`` (w8a8 QAT, tanh gelu, untied head),
the same JAX parameter tree carried across with ``params_from_numpy`` and
the same ``token_lm_batch`` data:

* silu's and gelu's gradients equal ``jax.grad``'s bit for bit in bf16
  (the port repeats JAX's derivative formulas op for op), within a few
  float32 ulps in float32;
* ``loss_fn`` within rtol 1e-5 of JAX;
* every gradient leaf within 2^-6 of the leaf's largest |gradient|
  (2^-4 for the QKV biases), elementwise.  Every projection of the
  reference is a bf16 matmul whatever the compute dtype, so float32
  summation-order differences (attention, softmax, rmsnorm) flip a bf16
  rounding now and then, and the flipped operand (one bf16 ulp, 2^-8
  relative) moves the gradients downstream of it; across seeds 0-2 the
  largest move was 0.0084 of the leaf's scale (most seeds: none outside
  rtol 1e-4, atol 1e-6, the ResNet-9 tolerance).  A bias gradient is a
  sum over the tokens of bf16 cotangents: JAX's XLA:CPU sums it in bf16,
  one token after another, the port in float32 (PyTorch's bf16 sum), which
  differ by up to tokens x 2^-9 of the running sum: 2^-4 at 32 tokens;
* the tied embedding's gradient reaches ``embed`` (a head copy made by
  ``with_head_copy`` is ignored by ``loss_fn``);
* remat (``""`` and ``"tp_outputs"``) against no remat, bit for bit;
* ``make_train_step`` for 1 and 3 steps against JAX's (jitted), with
  ``compress_pod_grads`` off and on; tolerances at ``_check_step``.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data.synthetic import token_lm_batch  # noqa: E402
from repro.dist.compression import init_residuals as j_init_residuals  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import lm as JL  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro.models.testing import reduce_config as j_reduce  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.dist.compression import init_residuals  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm as TL  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402
from repro_torch.models.testing import reduce_config  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_flatten, tree_paths  # noqa: E402

LR = 3e-4
GRAD_TOL = 2.0 ** -6
BIAS_TOL = 2.0 ** -4
ARCHS = ["qwen2.5-3b", "lm-tiny"]


def _cfgs(arch, **over):
    if arch == "lm-tiny":
        return (dataclasses.replace(j_get_config(arch), **over),
                dataclasses.replace(get_config(arch), **over))
    return (j_reduce(j_get_config(arch), **over),
            reduce_config(get_config(arch), **over))


def _params(jc, seed):
    jp = jax.tree_util.tree_map(np.asarray,
                                JL.init_params(jax.random.PRNGKey(seed), jc))
    return jp, params_from_numpy(jp, device="cpu")


def _batch(seed, vocab, batch=2, seq=16, n_micro=None):
    b = token_lm_batch(seed, batch, seq, vocab)
    if n_micro:
        b = {k: v.reshape(n_micro, batch // n_micro, -1) for k, v in b.items()}
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _port_grads(tp, tb, tc):
    leaves, unflatten = tree_flatten(tp)
    live = [t.detach().clone().requires_grad_(True) for t in leaves]
    loss = TL.loss_fn(unflatten(live), tb, tc)
    return loss.detach(), torch.autograd.grad(loss, live)


def _check_grads(paths, want, got, what="gradient"):
    for path, a, g in zip(paths, want, got):
        a = np.asarray(a, np.float32)
        g = g.to(torch.float32).numpy()
        assert a.shape == g.shape, path
        tol = (BIAS_TOL if path.endswith("/b") else GRAD_TOL) \
            * float(np.abs(a).max())
        np.testing.assert_allclose(g, a, rtol=0, atol=tol,
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# elementwise derivatives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["silu", "gelu"])
def test_activation_gradients_equal_jax_bit_for_bit(name, dtype):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(3, 5, 96)) * 3).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)
    jf = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[name]
    tf = {"silu": L.silu, "gelu": L.gelu_tanh}[name]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    jv, jg = jax.value_and_grad(lambda v: jnp.sum(
        jf(v.astype(jdt)).astype(jnp.float32) * c))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tf(tx.to(tdt))
    (tg,) = torch.autograd.grad((y.float() * torch.from_numpy(c)).sum(), tx)
    # bf16 (the projections' dtype, where the model runs them): bit for
    # bit.  float32: XLA's fused exp/tanh and PyTorch's differ in the last
    # bits, and XLA's tanh reaches exactly 1 sooner (6.3e-6 apart there)
    tol = {"bfloat16": dict(rtol=0, atol=0),
           "float32": dict(rtol=4e-6, atol=1e-5)}[dtype]
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **tol)
    with torch.no_grad():       # without autograd: the same values
        assert torch.equal(tf(tx.to(tdt)), y.detach())
    np.testing.assert_allclose(
        y.detach().float().numpy(),
        np.asarray(jf(jnp.asarray(x).astype(jdt)), np.float32), **tol)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_jax(arch, seed):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed)
    jb, tb = _batch(seed, jc.vocab)
    jloss, jgrads = jax.value_and_grad(JL.loss_fn)(
        jax.tree_util.tree_map(jnp.asarray, jp), jb, jc)
    loss, grads = _port_grads(tp, tb, tc)
    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    paths = tree_paths(tp)
    assert paths == ["/".join(str(getattr(k, "key", k)) for k in p)
                     for p, _ in jax.tree_util.tree_leaves_with_path(jgrads)]
    _check_grads(paths, jax.tree_util.tree_leaves(jgrads), grads)


def test_tied_embedding_gradient_reaches_the_table():
    jc, tc = _cfgs("qwen2.5-3b")
    assert tc.tie_embeddings
    _, tp = _params(jc, 3)
    _, tb = _batch(3, jc.vocab)
    loss, grads = _port_grads(tp, tb, tc)
    g_embed = dict(zip(tree_paths(tp), grads))["embed"]
    unseen = torch.ones(tc.vocab_padded, dtype=torch.bool)
    unseen[tb["tokens"].flatten().long()] = False
    # the head's gradient reaches every row, the gather's only the seen ones
    assert bool(g_embed[unseen].abs().sum(dim=1).gt(0).all())
    assert bool(g_embed[~unseen].abs().sum(dim=1).gt(0).all())
    # a serving head copy changes neither the loss nor the table's gradient
    copy = TL.with_head_copy(dict(tp, embed=tp["embed"]),
                             dataclasses.replace(tc, compute_dtype="bfloat16"))
    assert "embed_head" in copy
    leaves, unflatten = tree_flatten(tp)
    live = [t.detach().clone().requires_grad_(True) for t in leaves]
    tree = unflatten(live)
    tree["embed_head"] = torch.zeros_like(copy["embed_head"])  # stale copy
    loss2 = TL.loss_fn(tree, tb, tc)
    assert torch.equal(loss2.detach(), loss)
    g2 = torch.autograd.grad(loss2, live)
    assert all(torch.equal(a, b) for a, b in zip(g2, grads))


@pytest.mark.parametrize("policy", ["", "tp_outputs"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat_bit_for_bit(arch, policy):
    jc, plain = _cfgs(arch, remat=False)
    remat = dataclasses.replace(plain, remat=True, remat_policy=policy)
    _, tp = _params(jc, 4)
    _, tb = _batch(4, jc.vocab)
    loss0, g0 = _port_grads(tp, tb, plain)
    loss1, g1 = _port_grads(tp, tb, remat)
    assert torch.equal(loss0, loss1)
    for path, a, b in zip(tree_paths(tp), g0, g1):
        assert torch.equal(a, b), path
    # remat only applies where gradients are taken
    with torch.no_grad():
        l0, _ = TL.forward(tp, tb, plain)
        l1, _ = TL.forward(tp, tb, remat)
    assert torch.equal(l0, l1)


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------
def _check_step(step, jloss, loss, jp, tp, jm, tm, jres, tres, arch):
    """Tolerances of one compared train step.

    * the loss: rtol 1e-5 at step 0 (the same parameters).  Later steps
      start from parameters that differ (below): rtol 1e-4 for the float
      model (measured up to 9.6e-6), 5e-3 for lm-tiny, whose QAT weights
      snap to a grid of 1/64: a master weight that moved 2 x lr more in
      one package may cross a grid midpoint and change its code (measured
      up to 1.6e-3 at step 2);
    * the first moment ``m`` (after one step, 0.1 x the clipped
      gradients) at the gradient tolerance; after three steps doubled for
      the float model (each step's gradients carry the last step's
      differences) and 4x for lm-tiny, where a weight code that flipped
      moves the gradients by a grid step (measured up to 2.3% of a leaf's
      scale);
    * the parameters: AdamW's first update is ``lr * mhat / (sqrt(vhat)
      + eps)``, close to ``lr * sign(g)``, so where the two gradients lie
      within the bf16 noise of 0 the signs may disagree and an element
      differ by up to 2 lr; where JAX's gradient exceeds 4x the tolerance
      both signs agree and the update is the same to 1e-7.  After three
      steps every element within 3 x 2 lr (x 1.1 for weight decay and
      the moments' bias correction);
    * the EF residuals (compression on): float32 and finite.  They are
      not compared with JAX's: a code at a rounding boundary flips under
      gradient differences far below the gradient tolerance, which is
      itself two int8 steps of a leaf.  ``ef_compress_tree`` itself is
      held against JAX bit for bit in ``test_torch_substrate.py``, and
      the step's residuals against half a step below.
    """
    rtol = 1e-5 if step == 0 else (5e-3 if arch == "lm-tiny" else 1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol,
                               err_msg=f"loss at step {step}")
    paths = tree_paths(tp)
    scale = 1 if step == 0 else (4 if arch == "lm-tiny" else 2)
    for path, a, g in zip(paths, jax.tree_util.tree_leaves(jm),
                          tree_flatten(tm)[0]):
        a, g = np.asarray(a), g.numpy()
        tol = scale * (BIAS_TOL if path.endswith("/b") else GRAD_TOL) \
            * float(np.abs(a).max())
        np.testing.assert_allclose(g, a, rtol=0, atol=tol,
                                   err_msg=f"m {path} at step {step}")
    for path, a, g, m in zip(paths, jax.tree_util.tree_leaves(jp),
                             tree_flatten(tp)[0],
                             jax.tree_util.tree_leaves(jm)):
        a, g, m = np.asarray(a), g.numpy(), np.asarray(m)
        d = np.abs(g - a)
        if step == 0:
            assert d.max() <= 2 * LR * (1 + 1e-3), path
            tol = 4 * (BIAS_TOL if path.endswith("/b") else GRAD_TOL)
            big = np.abs(m) > tol * np.abs(m).max()
            assert d[big].max(initial=0) <= 1e-7, path
        else:
            assert d.max() <= 3 * 2 * LR * 1.1, path
    if jres is not None:
        assert tree_paths(tres) == paths
        assert all(r.dtype == torch.float32 and bool(torch.isfinite(r).all())
                   for r in tree_flatten(tres)[0])


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_jax(arch, compress):
    jc, tc = _cfgs(arch, grad_accum=2)
    jp0, tp = _params(jc, 5)
    jp = jax.tree_util.tree_map(jnp.asarray, jp0)
    jopt, opt = j_adamw_init(jp), adamw_init(tp)
    jstep = jax.jit(JS.make_train_step(jc, lr=LR, compress_pod_grads=compress))
    step = TS.make_train_step(tc, lr=LR, compress_pod_grads=compress)
    jres = j_init_residuals(jp) if compress else None
    res = init_residuals(tp) if compress else None
    for i in range(3):
        jb, tb = _batch(50 + i, jc.vocab, batch=4, n_micro=2)
        if compress:
            jp, jopt, jloss, jres = jstep(jp, jopt, jb, jres)
            tp, opt, loss, res = step(tp, opt, tb, res)
        else:
            jp, jopt, jloss = jstep(jp, jopt, jb)
            tp, opt, loss = step(tp, opt, tb)
        assert loss.shape == () and loss.dtype == torch.float32
        assert int(opt.step) == int(jopt.step) == i + 1
        if i in (0, 2):
            _check_step(i, jloss, loss, jp, tp, jopt.m, opt.m, jres, res,
                        arch)


def test_train_step_residuals_bounded_by_half_a_step():
    _, tc = _cfgs("qwen2.5-3b", grad_accum=2)
    _, tp = _params(_cfgs("qwen2.5-3b")[0], 6)
    _, tb = _batch(6, tc.vocab, batch=4, n_micro=2)
    step = TS.make_train_step(tc, lr=LR, compress_pod_grads=True)
    res0 = init_residuals(tp)
    # the averaged gradients, as the step computes them, give each leaf's
    # quantization step
    leaves, unflatten = tree_flatten(tp)
    acc = [torch.zeros_like(t) for t in leaves]
    for i in range(2):
        _, g = _port_grads(tp, {k: v[i] for k, v in tb.items()}, tc)
        for a, gi in zip(acc, g):
            a.add_(gi)
    _, opt, loss, res = step(tp, adamw_init(tp), tb, res0)
    assert math.isfinite(loss.item())
    for a, r in zip(acc, tree_flatten(res)[0]):
        scale = float((a / 2).abs().max()) / 127
        # half a step, up to the float32 rounding of codes x scale
        assert float(r.abs().max()) <= scale / 2 * (1 + 1e-4)
    # without residuals the step returns three values, as the reference
    assert len(step(tp, adamw_init(tp), tb)) == 3


def test_train_step_contract():
    _, tc = _cfgs("qwen2.5-3b", grad_accum=2)
    _, tp = _params(_cfgs("qwen2.5-3b")[0], 7)
    _, tb = _batch(7, tc.vocab, batch=4, n_micro=2)
    # on plain tensors (one device) acc_shardings picks no layout: the
    # same step, bit for bit (the sharded buffer: test_torch_dist_ranks.py)
    _, _, plain = TS.make_train_step(tc)(tp, adamw_init(tp), tb)
    _, _, hinted = TS.make_train_step(tc, acc_shardings={})(
        tp, adamw_init(tp), tb)
    assert torch.equal(plain, hinted)
    with pytest.raises(ValueError, match="embed_head"):
        TS.make_train_step(tc)(
            TL.with_head_copy(tp, dataclasses.replace(
                tc, compute_dtype="bfloat16")), adamw_init(tp), tb)
    # a bf16 accumulation buffer: the same step shape, finite
    p, o, loss = TS.make_train_step(tc, grad_dtype=torch.bfloat16)(
        tp, adamw_init(tp), tb)
    assert math.isfinite(loss.item())
    assert all(a.dtype == b.dtype for a, b in
               zip(tree_flatten(p)[0], tree_flatten(tp)[0]))
    # the step leaves the caller's tree as it was: the same step again
    # gives the same loss
    again = TS.make_train_step(tc)(tp, adamw_init(tp), tb)[2]
    assert torch.equal(again, TS.make_train_step(tc)(tp, adamw_init(tp),
                                                     tb)[2])


@pytest.mark.parametrize("arch,n_layers", [("qwen2.5-3b", 36),
                                           ("qwen2.5-3b", 1000),
                                           ("lm-tiny", 2)])
def test_train_dtype_policy_equals_reference(arch, n_layers):
    jc = dataclasses.replace(j_get_config(arch), n_layers=n_layers)
    tc = dataclasses.replace(get_config(arch), n_layers=n_layers)
    want = [jnp.dtype(d).name for d in JS.train_dtype_policy(jc)]
    got = [str(d).replace("torch.", "") for d in TS.train_dtype_policy(tc)]
    assert got == want
    assert (want[0] == "bfloat16") == (jc.n_params() > 5e10)
