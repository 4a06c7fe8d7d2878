"""The plane route's 24-bit codes and one-plane weights, on the CPU against
the JAX package.

On the card activation codes of 17 to 24 bits take three byte planes and
int8 weights one plane of ``mvau_conv_kernel``'s plane route (2, 3, 4 or 6
``wgmma`` products).  Here its plain version (``kernels.mvau.plane_matmul``
through ``mvau_int_plain`` and ``mvau_int_conv_plain``: what a CPU tensor
takes, and the bar the kernel is held to on the card) equals the
reference's ``ref.mvau_int`` and ``mvau_int_pallas`` in interpret mode on
the same numpy codes, bit for bit: 17-bit and 24-bit codes, signed and
unsigned, against int8 weights (one plane) and 16-bit weights (two planes),
15 and 255 levels, the GEMM and the conv form.  And every ``mvau_int`` node
of ``paper_w16a16()`` and ``grid_point(8, 8)`` at width 8, handed the
operands its lowering prepares for the card (c2's 17-bit codes as int32,
six products; the (8, 8) c2's 9-bit codes against one weight plane, two),
gives the interpreter's output on the same frame.  The kernel itself runs
only on the card: see ``tests/test_torch_card.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro_torch  # noqa: E402
from repro.core import graph as JG  # noqa: E402
from repro.kernels import mvau as jmvau  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import graph as TG  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import mvau as KM  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import resnet9 as TR  # noqa: E402

# activation codes [lo, hi) of the three-plane kinds, and their top plane
X_KINDS = {"u17": ((0, 2**17), False), "s24": ((-2**23, 2**23), False),
           "u24": ((0, 2**24), True)}


def _codes(rng, lo, hi, shape):
    """Codes in [lo, hi), half of them at an end of the range."""
    v = rng.integers(lo, hi, size=shape)
    ends = np.where(rng.random(shape) < 0.5, lo, hi - 1)
    return np.where(rng.random(shape) < 0.5, ends, v)


def _case(kind, planes, k, seed):
    """x codes of ``kind`` at their extremes, and weights at the ends of
    the largest range whose sums stay inside int32 at this K (as the
    integer lowering admits; 16-bit storage with two planes, int8 with
    one), and the kernel's weight operand."""
    rng = np.random.default_rng(seed)
    (lo, hi), _ = X_KINDS[kind]
    xmax = max(abs(lo), hi - 1)
    wlim = min(128 if planes == 1 else 32768, (2**31 - 1) // (k * xmax))
    w = _codes(rng, -wlim, wlim, (k, 6)).astype(
        np.int8 if planes == 1 else np.int16)
    wp = KM.weight_planes(torch.from_numpy(w), planes=planes)
    return rng, (lo, hi), xmax * wlim, w, wp


def _tables(rng, n, levels, span):
    return np.sort(rng.integers(-span, span, size=(n, levels)),
                   axis=1).astype(np.int32)


@pytest.mark.parametrize("kind", sorted(X_KINDS))
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("levels", [15, 255])
def test_three_plane_gemm_equals_reference(kind, planes, levels):
    """GEMM form, M 10, K 24: ``mvau_int_plain`` (and the CPU wrapper) on
    int32 codes against one or two weight planes == ``ref.mvau_int`` and
    ``mvau_int_pallas(interpret=True)`` on the same codes."""
    k = 24
    rng, (lo, hi), span, w, wp = _case(kind, planes, k, 7 * levels + planes)
    x = _codes(rng, lo, hi, (10, k)).astype(np.int32)
    t = _tables(rng, 6, levels, span * 6)
    xu = X_KINDS[kind][1]
    want = np.asarray(jref.mvau_int(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(t), out_base=-2))
    pallas = np.asarray(jmvau.mvau_int_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(t), out_base=-2,
        interpret=True))
    np.testing.assert_array_equal(pallas, want)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    got = KM.mvau_int_plain(xt, wp, tt, -2, x_unsigned=xu)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(KM.mvau_int(xt, wp, tt, -2, x_unsigned=xu), got)
    # the counts are not all at one end of the tables
    assert 0 < int((want > -2).sum()) and int((want < levels - 2).sum()) > 0


@pytest.mark.parametrize("kind", sorted(X_KINDS))
@pytest.mark.parametrize("planes", [1, 2])
def test_three_plane_conv_equals_reference(kind, planes):
    """Conv form, 3 x 3 pad 1 over (2, 5, 5, 3) codes: the plain version on
    the NHWC int32 codes and the weights' planes == ``_ex_im2col`` +
    ``mvau_int_pallas(interpret=True)``, 255 levels."""
    k = 27
    rng, (lo, hi), span, w, wp = _case(kind, planes, k, 11 + planes)
    x = _codes(rng, lo, hi, (2, 5, 5, 3)).astype(np.int32)
    t = _tables(rng, 6, 255, span * 6)
    node = JG.Node("im2col", ["x"], ["x_col"],
                   {"kernel": 3, "stride": 1, "pad": 1})
    patches = JG._ex_im2col(node, jnp.asarray(x))
    want = np.asarray(jmvau.mvau_int_pallas(
        patches.reshape(-1, k), jnp.asarray(w), jnp.asarray(t), out_base=1,
        interpret=True)).reshape(2, 5, 5, 6)
    got = KM.mvau_int_conv_plain(torch.from_numpy(x), wp, torch.from_numpy(t),
                                 3, 1, 1, 1, x_unsigned=X_KINDS[kind][1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("config,c2", [
    ("paper_w16a16", ("planes", "s24", 6)),
    ("grid_point_8_8", ("planes", "s16", 2))])
def test_artifact_nodes_through_their_plane_operands(config, c2):
    """Every ``mvau_int`` of the width-8 artifact, on the patch rows the
    interpreter gives it for one frame, through the operands the lowering
    prepares for the card (``prepare_tables``, ``_kernel_codes``) and the
    plane route's plain version == the interpreter's output, bit for bit;
    c2 takes the route ``c2`` names."""
    qcfg = {"paper_w16a16": TQ.QuantConfig.paper_w16a16(),
            "grid_point_8_8": TQ.QuantConfig.grid_point(8, 8)}[config]
    params = TR.init_params(torch.Generator().manual_seed(3), 8, device="cpu")
    dm = repro_torch.compile(params, qcfg, recipe="resnet9", datapath="int",
                             device="cpu")
    g = dm.graph
    mv = [n for n in g.nodes if n.op == "mvau_int"]
    probe = g.copy()
    probe.outputs = [t for n in mv for t in (n.inputs[0], n.outputs[0])]
    x = TQ.fake_quant(torch.from_numpy(np.random.default_rng(5).random(
        (1, 32, 32, 3)).astype(np.float32)), qcfg.act)
    env = dict(zip(probe.outputs, TG.execute(probe, {g.inputs[0]: x})))
    nodes = [n.copy() for n in mv]
    consts = {k: torch.as_tensor(np.asarray(v))
              for k, v in g.initializers.items()}
    tops.prepare_tables(nodes, g.initializers, consts, g.dtypes)
    for n in nodes:
        route = tops.int_route_of(n)
        assert route[0] == "planes"
        if n.outputs[0].startswith("c2_"):
            assert route == c2
        patches = env[n.inputs[0]]
        rows = patches.reshape(-1, patches.shape[-1]).to(torch.int32)
        xk, wk, packed, xu = tops._kernel_codes(
            n, rows, consts[n.inputs[1]], consts.get(n.attrs.get("w_kernel")))
        got = KM.mvau_int(xk.contiguous(), wk, consts[n.inputs[-1]],
                          n.attrs.get("out_base", 0), packed, x_unsigned=xu)
        want = env[n.outputs[0]]
        assert torch.equal(got, want.reshape(got.shape).to(torch.int32)), \
            n.outputs[0]
