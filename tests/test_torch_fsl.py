"""The port's few-shot head and serving store against the JAX reference.

Row L2 norms and the cosine similarity are float reductions whose order
differs between the frameworks, so normalized means and similarities are
held to a tolerance (rtol 1e-5, atol 1e-6) and predictions to equality.
Inside the port, the store's chunked registrations equal ``class_means``
bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.quant import QuantConfig as JCfg  # noqa: E402
from repro.data.synthetic import SyntheticImages as JData  # noqa: E402
from repro.fsl import ncm as jncm  # noqa: E402
from repro.fsl.pipeline import FSLPipeline as JPipe  # noqa: E402
from repro.fsl.pipeline import evaluate_episodes as j_evaluate  # noqa: E402
from repro.models import resnet9 as JR  # noqa: E402
from repro.serve.store import PrototypeStore as JStore  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.quant import QuantConfig as TCfg  # noqa: E402
from repro_torch.data.synthetic import SyntheticImages as TData  # noqa: E402
from repro_torch.fsl import ncm as tncm  # noqa: E402
from repro_torch.fsl.pipeline import FSLPipeline as TPipe  # noqa: E402
from repro_torch.fsl.pipeline import evaluate_episodes as t_evaluate  # noqa: E402
from repro_torch.serve.store import PrototypeStore as TStore  # noqa: E402

WIDTH = 8
TOL = dict(rtol=1e-5, atol=1e-6)


def test_synthetic_images_identical():
    a, b = JData(n_base=6, n_novel=5, seed=3), TData(n_base=6, n_novel=5, seed=3)
    np.testing.assert_array_equal(a.protos, b.protos)
    ea = a.episode(np.random.default_rng(9), 3, 2, 4)
    eb = b.episode(np.random.default_rng(9), 3, 2, 4)
    for k in ea:
        np.testing.assert_array_equal(ea[k], eb[k])
    xa, ya = a.base_batch(np.random.default_rng(1), 5)
    xb, yb = b.base_batch(np.random.default_rng(1), 5)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(ya, yb)


def test_ncm_matches_reference():
    rng = np.random.default_rng(5)
    f = rng.normal(size=(13, 8)).astype(np.float32)
    labs = rng.integers(0, 3, 13).astype(np.int32)
    q = rng.normal(size=(9, 8)).astype(np.float32)
    mj = np.asarray(jncm.class_means(jnp.asarray(f), jnp.asarray(labs), 3))
    mt = tncm.class_means(torch.from_numpy(f), torch.from_numpy(labs), 3)
    np.testing.assert_allclose(mt.numpy(), mj, **TOL)
    np.testing.assert_array_equal(
        tncm.ncm_classify(torch.from_numpy(q), mt).numpy(),
        np.asarray(jncm.ncm_classify(jnp.asarray(q), jnp.asarray(mj))))
    acc_j = float(jncm.ncm_accuracy(jnp.asarray(q), jnp.asarray(labs[:9]),
                                    jnp.asarray(f), jnp.asarray(labs), 3))
    acc_t = float(tncm.ncm_accuracy(torch.from_numpy(q),
                                    torch.from_numpy(labs[:9]),
                                    torch.from_numpy(f),
                                    torch.from_numpy(labs), 3))
    assert acc_t == acc_j


@pytest.mark.parametrize("splits", [[4, 9], [1, 2, 7], [13], [1] * 12])
def test_class_means_equals_chunked_running_update(splits):
    """Inside the port the fold is strict and the row norm batch-invariant,
    so any chunking equals the one-batch means bit for bit."""
    rng = np.random.default_rng(5)
    f = torch.from_numpy(rng.normal(size=(13, 8)).astype(np.float32))
    labs = torch.from_numpy(rng.integers(0, 3, 13).astype(np.int32))
    want = tncm.class_means(f, labs, 3)
    sums, counts = torch.zeros((3, 8)), torch.zeros((3,))
    lo = 0
    for hi in list(np.cumsum(splits)) + [13]:
        sums, counts = tncm.running_update(sums, counts, f[lo:hi], labs[lo:hi])
        lo = int(hi)
    assert torch.equal(tncm.finalize_means(sums, counts), want)


def test_class_means_single_shot_and_empty_way():
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32))
    means = tncm.class_means(f, torch.tensor([0, 1, 2, 2]), 4)
    fn = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    np.testing.assert_allclose(means[0].numpy(), fn[0].numpy(), rtol=1e-6)
    assert torch.equal(means[3], torch.zeros(6))


def test_store_chunked_interleaved_bitforbit_and_vs_reference():
    rng = np.random.default_rng(2)
    f = rng.normal(size=(11, 16)).astype(np.float32)
    labs = np.array([0] * 7 + [1] * 1 + [2] * 3, np.int32)
    stores = (TStore(device="cpu"), JStore())
    for s in stores:
        s.register("a", f[0:3])
        s.register("c", f[8:9])
        s.register("a", f[3:7])
        s.register("b", f[7:8])
        s.register("c", f[9:11])
    ts, js = stores
    assert ts.counts() == js.counts() == {"a": 7, "b": 1, "c": 3}
    means, ids = ts.prototypes()
    idx = {c: i for i, c in enumerate(ids)}
    offline = tncm.class_means(torch.from_numpy(f), torch.from_numpy(labs), 3)
    np.testing.assert_array_equal(means[[idx["a"], idx["b"], idx["c"]]],
                                  offline.numpy())
    np.testing.assert_allclose(means, js.prototypes()[0], **TOL)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    (t_ids, t_sims), (j_ids, j_sims) = ts.classify(q), js.classify(q)
    assert t_ids == j_ids and t_sims.shape == (6, 3)
    np.testing.assert_allclose(t_sims, j_sims, **TOL)
    ts.prime(16, buckets=(1, 2, 8))


def test_store_single_shot_and_errors():
    f = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    store = TStore(device="cpu")
    for i, c in enumerate(("a", "b", "c")):
        assert store.register(c, f[i]) == 1          # 1-D single shot
    assert store.class_ids == ("a", "b", "c")
    offline = tncm.class_means(torch.from_numpy(f), torch.tensor([0, 1, 2]), 3)
    np.testing.assert_array_equal(store.prototypes()[0], offline.numpy())
    ids, sims = store.classify(f[1])
    assert ids == ["b"] and sims.shape == (1, 3)
    with pytest.raises(ValueError):
        store.register("a", np.ones((2, 5), np.float32))   # dim mismatch
    with pytest.raises(ValueError):
        store.register("d", np.zeros((0, 8), np.float32))  # empty chunk
    store.reset()
    assert len(store) == 0
    with pytest.raises(RuntimeError):
        store.prototypes()


@pytest.fixture(scope="module")
def pipes():
    pj = JR.init_params(jax.random.PRNGKey(4), WIDTH)
    pt = params_from_numpy(jax.tree_util.tree_map(np.asarray, pj), "cpu")
    jpipe = JPipe(width=WIDTH, qcfg=JCfg.paper_w6a4(), n_way=5, k_shot=2,
                  n_query=3)
    tpipe = TPipe(width=WIDTH, qcfg=TCfg.paper_w6a4(), n_way=5, k_shot=2,
                  n_query=3, device="cpu")
    return pj, pt, jpipe, tpipe


def test_deployed_flip_ensemble_matches_reference(pipes):
    pj, pt, jpipe, tpipe = pipes
    x = np.random.default_rng(5).random((2, 32, 32, 3)).astype(np.float32)
    qat = tpipe.features(pt, x)
    for datapath in ("int", "f32"):
        tf = tpipe.deploy(pt, datapath=datapath)
        jf = jpipe.deploy(pj, datapath=datapath)
        assert tf is tpipe.deploy(pt, datapath=datapath)       # memoized
        got = tf(x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jf(x)))
        np.testing.assert_allclose(got.numpy(), qat.numpy(), **TOL)
        assert tf.deployed_model.datapath == datapath
    assert torch.equal(tpipe.deploy(pt, "int")(x), tpipe.deploy(pt, "f32")(x))
    tf = tpipe.deploy(pt, "int")
    tf.warmup([1, 2])
    n = tf.trace_count()
    tf(x[:1])
    assert tf.trace_count() == n


def test_register_classify_and_episodes_match_reference(pipes):
    """Same numpy episodes through both packages' deployed int artifacts:
    the store's predictions and evaluate_episodes' accuracy are equal."""
    pj, pt, jpipe, tpipe = pipes
    data = TData(n_base=6, n_novel=6, seed=1)
    jdata = JData(n_base=6, n_novel=6, seed=1)
    tfe, jfe = tpipe.deploy(pt, "int"), jpipe.deploy(pj, "int")
    ep = data.episode(np.random.default_rng(3), 5, 2, 3)
    ts, js = TStore(device="cpu"), JStore()
    for way in range(5):
        shots = ep["support_x"][ep["support_y"] == way]
        ts.register(way, tfe(shots))
        js.register(way, np.asarray(jfe(shots)))
    np.testing.assert_allclose(ts.prototypes()[0], js.prototypes()[0], **TOL)
    assert ts.classify(tfe(ep["query_x"]))[0] == \
        js.classify(np.asarray(jfe(ep["query_x"])))[0]
    acc_t = t_evaluate(pt, data, tpipe, n_episodes=2, feats_fn=tfe)
    acc_j = j_evaluate(pj, jdata, jpipe, n_episodes=2, feats_fn=jfe)
    assert acc_t == acc_j


def test_for_point_grid():
    p = TPipe.for_point(6, 4, width=4, device="cpu")
    assert p.qcfg == TCfg.paper_w6a4() and p.width == 4
