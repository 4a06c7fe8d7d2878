"""The chunked attention's groups of query blocks (``layers._chunked_heads``).

* The grouped form against the per-block loop it replaced (one query block
  at a time over its kv blocks), written out here: chunk 8 and 16, groups
  of 1 block, of some blocks and of all blocks (``_GROUP_TILE`` set to
  ``g·chunk²``), causal and not, GQA rep 1 and 2, float32 on the CPU, bit
  for bit: every element takes the same ops in the same order.
* The group size: one block at a chunk of 1,024 (every real config), all
  blocks at lm-tiny's chunk of 8 up to 16,384 blocks.
* lm-tiny's float ``lm.forward`` at S 512 (64 blocks of 8, one group)
  against the JAX ``lm.forward``, at ``test_torch_lm.py``'s tolerance for
  bf16 activations (rtol 1e-2, atol 1e-2); at w8a8, the grouped forward
  against the per-block loop, bit for bit.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs.lm_tiny  # noqa: E402,F401  (registers the arch)
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import get_config as j_get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import get_config  # noqa: E402


def per_block(q, k, v, chunk, causal):
    """The form the groups replace: each query block in turn over kv blocks
    0 up to its diagonal (all of them when not causal)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    rep = H // KV
    nq, nk = Sq // chunk, Sk // chunk
    qb = q.reshape(B, nq, chunk, KV, rep, hd)
    kb = k.reshape(B, nk, chunk, KV, hd)
    vb = v.reshape(B, nk, chunk, KV, hd)
    scale = 1.0 / math.sqrt(hd)
    rows = torch.arange(chunk)
    blocks = []
    for iq in range(nq):
        qi = qb[:, iq].to(torch.float32)
        m = torch.full((B, KV, rep, chunk), -math.inf)
        den = torch.zeros((B, KV, rep, chunk))
        acc = torch.zeros((B, chunk, KV, rep, hd))
        for ik in range(min(iq + 1, nk) if causal else nk):
            kj = kb[:, ik].to(torch.float32)
            vj = vb[:, ik].to(torch.float32)
            s = torch.einsum("bqgrh,bkgh->bgrqk", qi, kj) * scale
            if causal:
                keep = ((ik * chunk + rows)[None, :]
                        <= (iq * chunk + rows)[:, None])
                s = torch.where(keep, s, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            den = den * corr + pr.sum(-1)
            acc = (acc * corr.permute(0, 3, 1, 2)[..., None]
                   + torch.einsum("bgrqk,bkgh->bqgrh", pr, vj))
            m = m_new
        out = acc / den.permute(0, 3, 1, 2)[..., None]
        blocks.append(out.to(q.dtype))
    return torch.stack(blocks, dim=1).reshape(B, Sq, H, hd)


def _qkv(seed, S, H, KV, hd=16, B=2):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 3, "all"])
@pytest.mark.parametrize("chunk", [8, 16])
def test_groups_equal_the_per_block_loop(monkeypatch, chunk, group, causal,
                                         rep):
    nq = 7                          # 3 does not divide it: a short group
    q, k, v = _qkv(chunk + rep, nq * chunk, 2 * rep, 2)
    g = nq if group == "all" else group
    monkeypatch.setattr(L, "_GROUP_TILE", g * chunk * chunk)
    got = L._chunked_sdpa(q, k, v, chunk, causal=causal)
    want = per_block(q, k, v, chunk, causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, want)


def test_group_size_keeps_the_real_configs_tile():
    """At chunk 1,024 a group is one block (the tile stays 1,024²); at
    chunk 8 one group takes every block of a 32k prefill (4,096), up to
    16,384 blocks."""
    assert L._GROUP_TILE == 1024 * 1024
    assert [L._group_blocks(n, 1024) for n in (1, 4, 32)] == [1, 1, 1]
    assert L._group_blocks(8, 512) == 4
    assert [L._group_blocks(n, 8) for n in (64, 512, 4096, 20000)] == \
        [64, 512, 4096, 16384]


@pytest.fixture(scope="module")
def lm_tiny_512():
    jp = jlm.init_params(jax.random.PRNGKey(3), j_get_config("lm-tiny"))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(5).integers(0, 97, (2, 512)
                                             ).astype(np.int32)
    return jp, tp, toks


def test_lm_tiny_float_forward_at_512_equals_jax(lm_tiny_512):
    """The float forward (``quant=None`` in both packages), at the LM
    tolerance of ``test_torch_lm.py`` for bf16 activations: lm-tiny's q, k
    and v round to bf16 in both packages, so a sum in another order moves
    an attention output by a bf16 ulp, and the logits by up to 8e-3 (JAX's
    own chunked and plain attention differ by 7.7e-3 here).  At w8a8 the
    activation quantizers turn such a move at a grid midpoint into a
    code: 0.9% of the logits then differ by up to 0.124, as much with the
    per-block loop and with plain attention as with the groups, so the
    next test holds the w8a8 forward to the per-block loop instead."""
    jp, tp, toks = lm_tiny_512
    cfg = dataclasses.replace(get_config("lm-tiny"), quant=None)
    jcfg = dataclasses.replace(j_get_config("lm-tiny"), quant=None)
    assert cfg.prefill_chunk == 8 and toks.shape[1] > 2 * cfg.prefill_chunk
    want, _ = jax.jit(lambda p, t: jlm.forward(p, {"tokens": t}, jcfg))(
        jp, jnp.asarray(toks))
    got, _ = lm.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy()[..., :cfg.vocab],
                               np.asarray(want)[..., :cfg.vocab],
                               rtol=1e-2, atol=1e-2)


def test_lm_tiny_forward_at_512_equals_the_per_block_loop(monkeypatch,
                                                          lm_tiny_512):
    _, tp, toks = lm_tiny_512
    cfg = get_config("lm-tiny")
    batch = {"tokens": torch.from_numpy(toks)}
    grouped, _ = lm.forward(tp, batch, cfg)
    monkeypatch.setattr(L, "_GROUP_TILE", cfg.prefill_chunk ** 2)
    blocks, _ = lm.forward(tp, batch, cfg)
    assert torch.equal(grouped, blocks)
