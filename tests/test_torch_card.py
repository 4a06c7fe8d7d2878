"""The port's CUDA kernels and main path on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode; on the CPU each wrapper takes its plain version,
which the other ``test_torch_*`` files hold against the JAX reference).
This file imports no JAX, so it also runs on the machine with the card::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import quant as Q  # noqa: E402
from repro_torch.kernels import build as B  # noqa: E402
from repro_torch.kernels import gap as KG  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.models import resnet9  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,levels", [(7, 36, 8, 15), (130, 200, 96, 512),
                                          (1, 27, 64, 255), (70, 40, 24, 4095),
                                          (9, 64, 136, 65535)])
def test_mvau_kernels_equal_plain(card, m, k, n, levels):
    rng = np.random.default_rng(m * n)
    x = _t(rng.integers(0, 16, size=(m, k)).astype(np.int8), card)
    w = _t(rng.integers(-8, 8, size=(k, n)).astype(np.int8), card)
    t = _t(np.sort(rng.integers(-500, 800, size=(n, levels)), axis=1
                   ).astype(np.int32), card)
    assert torch.equal(KM.mvau_int(x, w, t, 1), KM.mvau_int_plain(x, w, t, 1))
    xi = x.to(torch.int32)
    assert torch.equal(KM.mvau_int(xi, w, t, 1), KM.mvau_int_plain(xi, w, t, 1))
    wp = Q.pack_int4(w.to(torch.int32))
    assert torch.equal(KM.mvau_int(x, wp, t, 1, w_packed=True),
                       KM.mvau_int_plain(x, wp, t, 1, w_packed=True))
    xf, wf, tf = x.float() * 0.25, w.float() / 32, t.float() / 128
    assert torch.equal(KM.mvau(xf, wf, tf, 0.0, 0.25, 0.0),
                       KM.mvau_plain(xf, wf, tf, 0.0, 0.25, 0.0))


@pytest.mark.cuda
def test_gap_kernel_and_wrapper_checks(card):
    rng = np.random.default_rng(3)
    for dt in (np.int8, np.int32):
        xi = _t(rng.integers(-100, 100, size=(3, 5, 7, 24)).astype(dt), card)
        got = KG.gap(xi)
        assert got.dtype == torch.int32 and torch.equal(got, KG.gap_plain(xi))
    before = B.launch_counts["gap"]
    KG.gap(_t(rng.random((2, 4, 4, 8)).astype(np.float32), card))
    assert B.launch_counts["gap"] == before + 1
    with pytest.raises(ValueError):
        KG.gap(_t(np.zeros((2, 4, 4, 8), np.float64), card))
    with pytest.raises(ValueError):
        KM.mvau_int(_t(np.zeros((2, 4), np.int8), card),
                    _t(np.zeros((4, 3), np.int8), card),
                    _t(np.zeros((2, 15), np.int32), card))   # N mismatch


@pytest.mark.cuda
def test_main_path_card_equals_cpu(card):
    qcfg = repro_torch.QuantConfig.paper_w6a4()
    params = resnet9.init_params(torch.Generator().manual_seed(0), 8,
                                 device=card)
    cpu = {k: {kk: v.cpu() for kk, v in b.items()} for k, b in params.items()}
    x = np.random.default_rng(1).random((3, 32, 32, 3)).astype(np.float32)
    dm = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int")
    dm32 = repro_torch.compile(params, qcfg, recipe="resnet9")
    dm_cpu = repro_torch.compile(cpu, qcfg, recipe="resnet9", datapath="int",
                                 device="cpu")
    before = dict(B.launch_counts)
    f = dm(x)
    assert B.launch_counts["mvau_int"] - before["mvau_int"] == 8
    assert B.launch_counts["gap"] - before["gap"] == 1
    assert torch.equal(f.cpu(), dm_cpu(x))
    assert torch.equal(f, dm32(Q.fake_quant(_t(x, card), qcfg.act)))


@pytest.mark.cuda
def test_store_head_on_the_card(card):
    """The store's default device is the card; its prototypes and
    similarities agree with a CPU store's within rtol 1e-5 / atol 1e-6 and
    its predictions are equal; chunked registrations equal class_means."""
    from repro_torch.fsl import ncm
    from repro_torch.serve.store import PrototypeStore

    rng = np.random.default_rng(2)
    f = rng.normal(size=(11, 64)).astype(np.float32)
    labs = np.array([0] * 7 + [1] * 1 + [2] * 3)
    gpu, cpu = PrototypeStore(), PrototypeStore(device="cpu")
    assert gpu.device.type == "cuda"
    for s in (gpu, cpu):
        s.register(0, f[0:3])
        s.register(2, f[8:9])
        s.register(0, f[3:7])
        s.register(1, _t(f[7:8], card))
        s.register(2, f[9:11])
    means = gpu.prototypes()[0]
    offline = ncm.class_means(_t(f, card), torch.from_numpy(labs), 3)
    assert np.array_equal(means[[0, 2, 1]], offline.cpu().numpy())
    np.testing.assert_allclose(means, cpu.prototypes()[0], rtol=1e-5, atol=1e-6)
    q = rng.normal(size=(6, 64)).astype(np.float32)
    (g_ids, g_sims), (c_ids, c_sims) = gpu.classify(_t(q, card)), cpu.classify(q)
    assert g_ids == c_ids
    np.testing.assert_allclose(g_sims, c_sims, rtol=1e-5, atol=1e-6)
