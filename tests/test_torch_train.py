"""The port's training slice against the JAX reference, on the CPU.

Same numpy inputs through both packages:

* ``fake_quant``'s straight-through gradient equals ``jax.grad``'s bit for
  bit, at, inside and beyond the saturation bounds;
* the ResNet-9 loss (rtol 1e-5) and its gradient with respect to every leaf
  (rtol 1e-4, atol 1e-6) on the same converted params and batch, also on
  frames whose max-pool windows tie;
* AdamW over 5 steps, the cosine-warmup schedule, global-norm clipping and
  bf16 moments within 1e-6;
* one full pretraining step against a JAX step rebuilt from
  ``resnet9.forward`` + ``adamw_update`` + ``cosine_warmup``;
* the reference's pretraining contract (the loss drops, transfer beats
  random features) and deployed == QAT features after training, on both
  datapaths.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.data.synthetic import SyntheticImages  # noqa: E402
from repro_torch.fsl.pipeline import (FSLPipeline, evaluate_episodes,  # noqa: E402
                                      pretrain_backbone, pretrain_init,
                                      pretrain_step)
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0.0)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores,
    and torch's default (one thread per core in every worker) makes these
    small ops wait on each other many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fake_quant: the straight-through backward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,frac,signed", [(4, 2, True), (4, 2, False),
                                              (6, 5, True), (2, 1, False)])
def test_fake_quant_gradient_equals_jax_bit_for_bit(bits, frac, signed):
    js = JQ.FixedPointSpec(bits, frac, signed=signed)
    ts = TQ.FixedPointSpec(bits, frac, signed=signed)
    rng = np.random.default_rng(bits * 10 + frac)
    lo, hi = np.float32(ts.min_value), np.float32(ts.max_value)
    # one ulp beyond each bound; below an unsigned grid's 0 that ulp would
    # be a subnormal, which XLA's CPU backend flushes to zero, so the
    # smallest normal float stands in for it
    below = (np.nextafter(lo, np.float32(-np.inf)) if lo != 0
             else -np.finfo(np.float32).tiny)
    x = np.concatenate([
        rng.normal(size=200).astype(np.float32) * 2 * max(abs(lo), hi),
        [lo, hi, below, np.nextafter(hi, np.float32(np.inf)), 0.0,
         ts.scale / 2]
    ]).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    want_v, vjp = jax.vjp(lambda v: JQ.fake_quant(v, js), jnp.asarray(x))
    want_g = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    got_v = TQ.fake_quant(xt, ts)
    got_v.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got_v.detach().numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)
    inside = (x >= ts.min_value) & (x <= ts.max_value)
    np.testing.assert_array_equal(xt.grad.numpy(), g * inside)
    assert inside.any() and (~inside).any()


# ---------------------------------------------------------------------------
# ResNet-9: the forward with gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0),
                                          (3, 2, 0)])
def test_im2col_slices_equal_the_gather(k, stride, pad):
    """The shifted-slice im2col (a backward of plain adds) gives the
    reference's gather bit for bit, in (kh, kw, c) order."""
    x = np.random.default_rng(k + stride).normal(size=(2, 7, 9, 5)
                                                 ).astype(np.float32)
    got = TR._im2col(torch.from_numpy(x), k, stride, pad)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JR._im2col(jnp.asarray(x), k, stride, pad)))
    np.testing.assert_array_equal(
        got.numpy(), tref.im2col(torch.from_numpy(x), k, stride, pad).numpy())


def _ce_loss_jax(params, x, y, qcfg, width):
    f = JR.forward(params["backbone"], x, qcfg, width)
    logits = f @ params["head"]["w"]
    lse = jax.nn.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
    return (lse - gold).mean()


# one XLA program per shape: op-by-op dispatch of the grad takes ~20 s
_jax_loss_and_grads = jax.jit(jax.value_and_grad(_ce_loss_jax),
                              static_argnums=(3, 4))


def _frames(kind: str, n: int, img: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "random":
        return rng.random((n, img, img, 3), dtype=np.float32)
    # flat 2x2 blocks: every max-pool window of the early layers ties
    blocks = rng.random((n, img // 2, img // 2, 3), dtype=np.float32)
    return np.repeat(np.repeat(blocks, 2, axis=1), 2, axis=2)


@pytest.mark.parametrize("width,kind,point", [(4, "random", (6, 4)),
                                              (8, "random", (6, 4)),
                                              (4, "ties", (6, 4)),
                                              (8, "ties", (3, 2))])
def test_resnet9_loss_and_grads_match_jax(width, kind, point):
    qj = JQ.QuantConfig.grid_point(*point)
    qt = TQ.QuantConfig.grid_point(*point)
    n_cls, img = 5, 16
    pj = {"backbone": JR.init_params(jax.random.PRNGKey(width), width),
          "head": {"w": jax.random.normal(jax.random.PRNGKey(7),
                                          (8 * width, n_cls)) * 0.05}}
    x = _frames(kind, 6, img)
    y = np.arange(6, dtype=np.int32) % n_cls
    loss_j, grads_j = _jax_loss_and_grads(
        pj, jnp.asarray(x), jnp.asarray(y), qj, width)

    pt = params_from_numpy(_np_tree(pj), device="cpu")
    leaves, unflatten = tree_flatten(pt)
    leaves = [p.requires_grad_(True) for p in leaves]
    p = unflatten(leaves)
    f = TR.forward(p["backbone"], torch.from_numpy(x), qt, width)
    logits = f @ p["head"]["w"]
    loss_t = (torch.logsumexp(logits, -1)
              - logits.gather(1, torch.from_numpy(y).long()[:, None])[:, 0]
              ).mean()
    grads_t = torch.autograd.grad(loss_t, leaves)

    np.testing.assert_allclose(loss_t.item(), float(loss_j), **LOSS_TOL)
    want = tree_flatten(_np_tree(grads_j))[0]
    assert len(want) == len(grads_t) == 8 * 3 + 1
    for gw, gt in zip(want, grads_t):
        np.testing.assert_allclose(gt.numpy(), gw, **GRAD_TOL)
    if kind == "ties":
        # every 2x2 window of the frames holds four equal maxima
        np.testing.assert_array_equal(x[:, 0::2, 0::2], x[:, 1::2, 1::2])


def test_maxpool_splits_gradient_between_ties_like_jax():
    x = np.array([[[[1.0], [1.0]], [[0.5], [1.0]]]], np.float32)   # 3 ties
    g = np.array([[[[3.0]]]], np.float32)
    _, vjp = jax.vjp(JR._maxpool, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    TR._maxpool(xt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(xt.grad.numpy().ravel(), [1, 1, 0, 1])


# ---------------------------------------------------------------------------
# AdamW, schedule, clipping
# ---------------------------------------------------------------------------
def _tree(rng):
    return {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                  "gamma": np.ones((4,), np.float32)},
            "head": {"w": rng.normal(size=(4, 2)).astype(np.float32)}}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_five_steps_match_jax(moments, schedule):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    lr_j = JA.cosine_warmup(1e-2, 2, 5) if schedule else 1e-2
    lr_t = TA.cosine_warmup(1e-2, 2, 5) if schedule else 1e-2
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    oj = JA.adamw_init(pj, getattr(jnp, moments))
    pt = params_from_numpy(params, device="cpu")
    ot = TA.adamw_init(pt, getattr(torch, moments))
    for g in grads:
        pj, oj = JA.adamw_update(pj, jax.tree_util.tree_map(jnp.asarray, g),
                                 oj, lr_j, weight_decay=1e-2)
        pt, ot = TA.adamw_update(pt, params_from_numpy(g, device="cpu"), ot,
                                 lr_t, weight_decay=1e-2)
    assert int(ot.step) == int(oj.step) == 5
    for want, got in ((pj, pt), (oj.m, ot.m), (oj.v, ot.v)):
        for w, t in zip(tree_flatten(_np_tree(want))[0],
                        tree_flatten(got)[0]):
            assert str(t.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(w, np.float32), **OPT_TOL)


@pytest.mark.parametrize("base,warmup,total", [(2e-3, 7, 150), (1e-2, 1, 5),
                                               (3e-4, 10, 10)])
def test_cosine_warmup_matches_jax(base, warmup, total):
    sj = JA.cosine_warmup(base, warmup, total)
    st = TA.cosine_warmup(base, warmup, total)
    for step in range(total + 2):
        want = np.asarray(sj(jnp.asarray(step, jnp.int32)))
        got = st(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **OPT_TOL)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(4))
    cj, nj = JA.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                    max_norm)
    ct, nt = TA.clip_by_global_norm(params_from_numpy(g, device="cpu"),
                                    max_norm)
    np.testing.assert_allclose(float(nt), float(nj), **OPT_TOL)
    for w, t in zip(tree_flatten(_np_tree(cj))[0],
                    tree_flatten(ct)[0]):
        np.testing.assert_allclose(t.numpy(), w, **OPT_TOL)


# ---------------------------------------------------------------------------
# pretraining
# ---------------------------------------------------------------------------
def test_one_pretraining_step_matches_jax():
    """The port's init drawn, carried to JAX as numpy, then one step in
    each: JAX's rebuilt from resnet9.forward + adamw_update +
    cosine_warmup, the port's ``pretrain_step``."""
    width, steps, lr = 4, 150, 2e-3
    data = SyntheticImages(n_base=6, n_novel=5, seed=2, img=16)
    pipe = FSLPipeline(width=width, qcfg=TQ.QuantConfig.paper_w6a4(),
                       device="cpu")
    pt = pretrain_init(data, pipe, seed=5)
    pn = params_to_numpy(pt)
    x, y = data.base_batch(np.random.default_rng(5), 8)

    qj = JQ.QuantConfig.paper_w6a4()
    pj = jax.tree_util.tree_map(jnp.asarray, pn)
    sched_j = JA.cosine_warmup(lr, warmup=max(steps // 20, 1), total=steps)
    loss_j, g_j = _jax_loss_and_grads(
        pj, jnp.asarray(x), jnp.asarray(y), qj, width)
    new_j, opt_j = JA.adamw_update(pj, g_j, JA.adamw_init(pj), sched_j,
                                   weight_decay=1e-4)

    sched_t = TA.cosine_warmup(lr, warmup=max(steps // 20, 1), total=steps)
    new_t, opt_t, loss_t = pretrain_step(
        pipe, pt, TA.adamw_init(pt), sched_t, torch.from_numpy(x),
        torch.from_numpy(y).long())
    np.testing.assert_allclose(float(loss_t), float(loss_j), **LOSS_TOL)
    for w, t in zip(tree_flatten(_np_tree(opt_j.m))[0],
                    tree_flatten(opt_t.m)[0]):
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-4, atol=1e-7)
    for w, t in zip(tree_flatten(_np_tree(new_j))[0],
                    tree_flatten(new_t)[0]):
        assert not t.requires_grad
        np.testing.assert_allclose(t.numpy(), w, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def trained():
    """The reference's pretraining contract setup: width 8, w6a4, 240
    steps on 12 base classes (the quantized backbone's plateau lasts ~150
    steps)."""
    data = SyntheticImages(n_base=12, n_novel=6, seed=3)
    pipe = FSLPipeline(width=8, qcfg=TQ.QuantConfig.paper_w6a4(),
                       easy_augment=False, device="cpu")
    return data, pipe, pretrain_backbone(data, pipe, steps=240, batch=32)


def test_pretraining_improves_over_random(trained):
    data, pipe, out = trained
    rand = TR.init_params(torch.Generator().manual_seed(9), 8, "cpu")
    acc_rand, _ = evaluate_episodes(rand, data, pipe, n_episodes=6)
    acc_trained, _ = evaluate_episodes(out["params"], data, pipe,
                                       n_episodes=6)
    assert len(out["losses"]) == 240
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0], "pretraining loss must drop"
    assert acc_trained >= acc_rand - 0.05, \
        f"training hurt transfer: {acc_rand} -> {acc_trained}"
    assert acc_trained > 0.4, f"way above 5-way chance expected: {acc_trained}"
    for blk in out["params"].values():
        assert (blk["gamma"] > 0).all()
        assert not any(v.requires_grad for v in blk.values())


def _qat_mismatch(got, want):
    """Per frame: any feature outside the reference's rtol 1e-5, atol 1e-6."""
    return ~torch.isclose(got, want, rtol=1e-5, atol=1e-6).all(dim=1)


def _ties(params, x, pipe):
    n = TR.midpoint_ties(params, x, pipe.qcfg, pipe.width)
    if pipe.easy_augment:
        n = n + TR.midpoint_ties(params, torch.flip(x, dims=[2]),
                                 pipe.qcfg, pipe.width)
    return n > 0


def _assert_qat_contract(got, want, ties, pipe, max_tied):
    """Deployed == QAT (rtol 1e-5, atol 1e-6) on every frame without a
    midpoint tie; at most ``max_tied`` tied frames, each within one code
    of the last block's activation grid."""
    bad = _qat_mismatch(got, want)
    assert not (bad & ~ties).any(), (bad, ties)
    assert int(ties.sum()) <= max_tied, ties
    code = pipe.qcfg.layer(TR.plan(pipe.width)[-1]["name"]).act.scale
    assert ((got - want).abs()[ties] <= code).all()


@pytest.mark.parametrize("flip", [False, True])
def test_deployed_equals_qat_after_training(trained, flip):
    """The deployed-accuracy contract on trained weights: both datapaths
    give the QAT features (the reference's rtol 1e-5, atol 1e-6) on every
    frame where no pre-activation lies on a grid midpoint, at most one
    tied frame of 4 and within a code there, int == f32 bit for bit, and
    equal episode accuracy."""
    data, pipe0, out = trained
    pipe = FSLPipeline(width=8, qcfg=pipe0.qcfg, easy_augment=flip,
                       device="cpu")
    x = torch.from_numpy(
        np.random.default_rng(6).random((4, 32, 32, 3), dtype=np.float32))
    want = pipe.features(out["params"], x)
    ties = _ties(out["params"], x, pipe)
    got = {}
    for datapath in ("f32", "int"):
        feats = pipe.deploy(out["params"], datapath=datapath)
        got[datapath] = feats(x)
        _assert_qat_contract(got[datapath], want, ties, pipe, max_tied=1)
    assert torch.equal(got["int"], got["f32"])
    acc_qat, _ = evaluate_episodes(out["params"], data, pipe, n_episodes=4)
    acc_dep, _ = evaluate_episodes(out["params"], data, pipe, n_episodes=4,
                                   feats_fn=pipe.deploy(out["params"], "int"))
    assert abs(acc_dep - acc_qat) < 0.01


def test_threshold_ties_explain_deployed_vs_qat_in_both_packages():
    """Five steps from seed 3 give BN parameters for which one flipped
    frame's pre-activation lands on a grid midpoint: the deployed
    features differ from QAT there, in the JAX reference exactly as in the
    port, and ``midpoint_ties`` finds that frame and no other."""
    from repro.fsl.pipeline import FSLPipeline as JPipe

    data = SyntheticImages(n_base=6, n_novel=5, seed=2)
    pipe = FSLPipeline(width=8, qcfg=TQ.QuantConfig.paper_w6a4(),
                       device="cpu")
    params = pretrain_backbone(data, pipe, steps=5, batch=16,
                               seed=3)["params"]
    x = np.random.default_rng(2).random((4, 32, 32, 3)).astype(np.float32)
    got = pipe.deploy(params, "int")(x)
    bad = _qat_mismatch(got, pipe.features(params, x))
    ties = _ties(params, torch.from_numpy(x), pipe)
    assert bad.any() and torch.equal(bad, ties)
    _assert_qat_contract(got, pipe.features(params, x), ties, pipe,
                         max_tied=1)
    jpipe = JPipe(width=8, qcfg=JQ.QuantConfig.paper_w6a4())
    pn = params_to_numpy(params)
    jgot = np.asarray(jpipe.deploy(pn, "int")(jnp.asarray(x)))
    jwant = np.asarray(jpipe.features(pn, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), jgot)
    np.testing.assert_array_equal(
        ~np.isclose(jgot, jwant, rtol=1e-5, atol=1e-6).all(axis=1),
        bad.numpy())


def test_wrong_threshold_export_fails_the_qat_check(trained, monkeypatch):
    """The tie test reads the grid and the BN parameters, not the exported
    thresholds: thresholds folded 5% off leave the ties as they were, and
    the deployed features then differ from QAT on untied frames."""
    _, pipe0, out = trained
    x = torch.from_numpy(
        np.random.default_rng(6).random((4, 32, 32, 3), dtype=np.float32))
    pipe = FSLPipeline(width=8, qcfg=pipe0.qcfg, device="cpu")
    ties = _ties(out["params"], x, pipe)
    fold = TR._block_thresholds
    monkeypatch.setattr(TR, "_block_thresholds",
                        lambda p, a: fold(p, a) * np.float32(1.05))
    got = pipe.deploy(out["params"], datapath="int")(x)
    assert torch.equal(_ties(out["params"], x, pipe), ties)
    assert (_qat_mismatch(got, pipe.features(out["params"], x))
            & ~ties).any()


def test_trained_artifact_matches_jax_compile_of_the_same_weights(trained):
    """The port's trained weights, carried to JAX as numpy and compiled
    there: the same int artifact's features, bit for bit."""
    from repro.core.deploy import compile as jcompile
    from repro_torch.core.deploy import compile as tcompile

    _, pipe, out = trained
    pn = params_to_numpy(out["params"])
    x = np.random.default_rng(8).random((3, 32, 32, 3), dtype=np.float32)
    xq = np.asarray(JQ.fake_quant(jnp.asarray(x), JQ.QuantConfig.paper_w6a4().act))
    dj = jcompile(pn, JQ.QuantConfig.paper_w6a4(), recipe="resnet9",
                  datapath="int")
    dt = tcompile(pn, pipe.qcfg, recipe="resnet9", datapath="int",
                  device="cpu")
    np.testing.assert_array_equal(dt(xq).numpy(), np.asarray(dj(xq)))
    assert dt.weight_bytes() == dj.weight_bytes()


def test_pretraining_is_deterministic_and_seeded():
    data = SyntheticImages(n_base=4, n_novel=5, seed=1, img=8)
    pipe = FSLPipeline(width=2, qcfg=TQ.QuantConfig.paper_w6a4(),
                       device="cpu")
    a = pretrain_backbone(data, pipe, steps=3, batch=4, seed=7)
    b = pretrain_backbone(data, pipe, steps=3, batch=4, seed=7)
    c = pretrain_backbone(data, pipe, steps=3, batch=4, seed=8)
    assert a["losses"] == b["losses"] != c["losses"]
    for u, v in zip(tree_flatten(a["params"])[0],
                    tree_flatten(b["params"])[0]):
        assert torch.equal(u, v)


def test_params_to_numpy_round_trips():
    p = TR.init_params(torch.Generator().manual_seed(1), 2, "cpu")
    p["c0"]["w"].requires_grad_(True)
    n = params_to_numpy(p)
    assert isinstance(n["c0"]["w"], np.ndarray)
    back = params_from_numpy(n, device="cpu")
    for u, v in zip(tree_flatten(p)[0], tree_flatten(back)[0]):
        assert torch.equal(u.detach(), v)


def test_pretraining_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FSLPipeline(width=2, qcfg=TQ.QuantConfig.paper_w6a4())
