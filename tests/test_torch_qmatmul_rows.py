"""qmatmul's many-row route on the CPU: the route and the plan that pick
``qmm_rows_kernel``, a model of its code decode and of its shared-memory
layout, and the plain version (what a CPU tensor takes, and the bar the
kernel is held to on the card) against the JAX package's Pallas kernel at
a shape that crosses the reference's 128-row tile.

The kernel itself runs only on the card: see ``tests/test_torch_card.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import quant as JQ  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import quant as TQ  # noqa: E402
from repro_torch.kernels import qmatmul as KQ  # noqa: E402
from repro_torch.models.common import get_config, list_configs  # noqa: E402

SMS = 132
WHISPER_ROWS = ((6000, 384, 384), (6000, 384, 1536), (6000, 1536, 384))


def _products(cfg):
    """(K, N) of every quantized projection a decode step of ``cfg`` can
    run: attention (MHA/GQA or MLA), MLP or experts, Mamba2, the head."""
    d, hd = cfg.d_model, cfg.hd
    out = {(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
           (cfg.n_heads * hd, d), (d, cfg.vocab_padded)}
    if cfg.d_ff:
        out |= {(d, cfg.d_ff), (cfg.d_ff, d)}
    if getattr(cfg, "mla_q_rank", 0):
        rd = cfg.mla_rope_dim
        out |= {(d, cfg.mla_q_rank), (cfg.mla_q_rank, cfg.n_heads * (hd + rd)),
                (d, cfg.mla_kv_rank + rd)}
    if getattr(cfg, "d_inner", 0):
        di = cfg.d_inner
        out |= {(d, 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state
                 + cfg.ssm_heads), (di, d)}
    return sorted(out)


def test_every_decode_shape_takes_the_decode_kernel():
    """Batch 1 to 8 of every LM config: the decode kernel, so a decode
    step's launches stay on ``qmm_kernel`` (252 a Qwen2.5-3B step)."""
    names = [n for n in list_configs() if get_config(n).family != "cnn"]
    assert {"qwen2.5-3b", "whisper-tiny", "grok-1-314b"} <= set(names)
    for name in names:
        for k, n in _products(get_config(name)):
            for m in range(1, 9):
                for bits in (8, 4):
                    assert KQ.qmm_route(m, k, n, SMS, bits) == "decode", (
                        name, m, k, n, bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_many_rows_take_the_rows_kernel(bits):
    """whisper's encoder and cross-cache products (4 x 1,500 frames) on the
    rows kernel, and the crossover's own boundary on either side."""
    for m, k, n in WHISPER_ROWS:
        assert KQ.qmm_route(m, k, n, SMS, bits) == "rows"
    for k, n in ((384, 384), (2048, 256), (2048, 11008), (11008, 2048)):
        m = max(KQ.ROWS_M, -(-KQ.ROWS_MN // n))    # the first rows shape
        assert KQ.qmm_route(m, k, n, SMS, bits) == "rows"
        assert KQ.qmm_route(m - 1, k, n, SMS, bits) == "decode"
        assert KQ.qmm_route(8192, k, n, SMS, bits) == "rows"
    assert KQ.qmm_route(KQ.ROWS_M - 1, 2048, 1 << 20, SMS, bits) == "decode"


@pytest.mark.parametrize("m,k,n", [*WHISPER_ROWS, (64, 2048, 256),
                                   (257, 200, 136), (1000, 37, 66),
                                   (8192, 2048, 11008), (8192, 11008, 2048),
                                   (130, 300, 1536), (65, 1536, 264)])
def test_rows_plan_covers_the_output_and_fits_the_card(m, k, n):
    """The tiles cover (M, N); the block's shared memory fits the 227 KB a
    block may use, and the resident blocks the 228 KB of an SM, at w8 and
    w4.  The plan does not depend on x's dtype: a float32 x is converted
    to bf16 on its way into shared memory, so both stage the same tile.
    No other height gives the busiest SM less to do."""

    def busiest(bm, bn):
        tiles = -(-m // bm) * -(-n // bn)
        return -(-tiles // SMS) * (KQ.ROWS_STEP_ROWS + bm)

    for bits in (8, 4):
        bm, bn, stages, resident, smem = KQ.rows_plan(m, k, n, SMS, bits)
        assert bm in KQ.ROWS_BMS and bn == KQ.ROWS_BN and stages >= 3
        assert -(-m // bm) * bm >= m and -(-n // bn) * bn >= n
        assert smem == KQ.rows_smem(bits, bm) <= KQ.SMEM_PER_BLOCK
        assert resident >= 2
        assert resident * (smem + KQ.SMEM_RESERVED) <= KQ.SMEM_PER_SM
        assert resident * KQ.ROWS_THREADS * KQ.ROWS_REGS <= KQ.REGS_PER_SM
        assert all(busiest(bm, bn) <= busiest(o, bn) for o in KQ.ROWS_BMS)
        for other in KQ.ROWS_BMS:      # every height the kernel takes fits
            assert KQ.rows_smem(bits, other) <= KQ.SMEM_PER_SM // 2 - 1024


def test_rows_plan_at_whisper_spreads_the_tiles():
    """At whisper's N 384 the 80-row tiles number 225: 2 on the busiest
    SM; 96-row tiles would put 2 of 96 rows there, 128-row tiles leave 9
    SMs with 2 tiles of 128 rows and the rest with 1, 64-row tiles 18 SMs
    with 3."""
    for m, k, n in (WHISPER_ROWS[0], WHISPER_ROWS[2]):
        assert KQ.rows_plan(m, k, n, SMS, 8)[:2] == (80, 128)
    assert KQ.rows_plan(*WHISPER_ROWS[1], SMS, 8)[:2] == (128, 128)


# ---------------------------------------------------------------------------
# a model of the kernel's decode: bits into a biased bf16 and one bf16x2 FMA
# ---------------------------------------------------------------------------
def _bf16(bits16):
    """int64 tensor of bf16 bit patterns -> float32 values."""
    return (bits16.to(torch.int32) << 16).view(torch.float32)


def _fma_bf16(a, b, c):
    """fma.rn.bf16x2 on one half: bf16(a * b + c), exact where the result
    is (all cases here)."""
    return (_bf16(a) * _bf16(b) + _bf16(c)).to(torch.bfloat16).float()


def _i8_pair(word):
    """i8x2_to_bf16x2 on bytes 0 and 2 of a 32-bit word: the low half."""
    lo = (word & 0x007F) | 0x4300          # 128 + (c & 127)
    hi = (word & 0x0080) | 0x4300          # 128 + (c & 128)
    return _fma_bf16(hi, torch.full_like(hi, 0xBF80), lo)


def _i4_pair(word):
    """i4x2_to_bf16x2 on bits 0-3 of a word: the low half."""
    v = (word & 0x000F) ^ 0x4308           # 136 + c
    return _fma_bf16(v, torch.full_like(v, 0x3F80),
                     torch.full_like(v, 0xC308))


def _byte_perm(x, y, sel):
    """__byte_perm on int64 tensors holding 32-bit words."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)]
    b += [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def test_decode_trick_gives_every_int8_code():
    codes = torch.arange(-128, 128)
    byte = codes & 0xFF
    word = byte | (byte << 16)
    assert torch.equal(_i8_pair(word), codes.float())


def test_decode_trick_gives_every_int4_code():
    codes = torch.arange(-8, 8)
    nib = codes & 0xF
    assert torch.equal(_i4_pair(nib | (nib << 16)), codes.float())


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_task_puts_eight_columns_in_order(bits):
    """One decode task of ``decode_step``: 8 consecutive columns of a row
    from their raw bytes (w8: two words; w4: one packed word, the low
    nibble the even column) to 8 bf16 values in column order."""
    rng = np.random.default_rng(bits)
    lim = 8 if bits == 4 else 128
    codes = torch.from_numpy(rng.integers(-lim, lim, size=(512, 8)))
    if bits == 8:
        raw = codes.to(torch.int8).view(torch.uint8).to(torch.int64)
        words = [sum(raw[:, 4 * w + i] << (8 * i) for i in range(4))
                 for w in range(2)]
        got = [_i8_pair(_byte_perm(words[q // 2], torch.zeros_like(words[0]),
                                   0x7170 if q % 2 == 0 else 0x7372))
               for q in range(4)]
        hi = [_i8_pair(_byte_perm(words[q // 2], torch.zeros_like(words[0]),
                                  0x7170 if q % 2 == 0 else 0x7372) >> 16)
              for q in range(4)]
    else:
        packed = TQ.pack_int4(codes.to(torch.int32)).view(torch.uint8)
        word = sum(packed.to(torch.int64)[:, i] << (8 * i) for i in range(4))
        lo, hi_n = word & 0x0F0F0F0F, (word >> 4) & 0x0F0F0F0F
        pairs = [_byte_perm(lo, hi_n, q | ((4 + q) << 8)) for q in range(4)]
        got = [_i4_pair(p) for p in pairs]
        hi = [_i4_pair(p >> 16) for p in pairs]
    out = torch.stack([v for q in range(4) for v in (got[q], hi[q])], dim=1)
    assert torch.equal(out, codes.float())


# ---------------------------------------------------------------------------
# a model of the operands: the x tile read back through wgmma's descriptor,
# and the codes' A fragments, each from the kernel's own index arithmetic
# ---------------------------------------------------------------------------
def _swz128(r, c):
    return r * 128 + (((c ^ r) & 7) << 4)


def _phys(addr):
    """The 128-byte swizzle as the hardware applies it to the address a
    descriptor yields: address bits 4-6 XOR bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


@pytest.mark.parametrize("bm", [64, 80, 96, 128])
def test_x_tile_reads_back_through_the_descriptor(bm):
    """The x tile (K-major, 128-byte rows, 16-byte chunk c of row r at slot
    c ^ (r & 7)): element (row, k) of each m64nNk16 step's B operand,
    addressed as the descriptor says (start + 32 s, 8-row groups 1024
    bytes apart), is the element the copies stored there."""
    rbk = KQ.ROWS_BK
    assert rbk * 2 == 128
    a = np.full(bm * rbk, -1, np.int64)          # element ids, by 2 bytes
    for r in range(bm):
        for c in range(8):
            for e in range(8):
                a[(_swz128(r, c) + 2 * e) // 2] = r * rbk + 8 * c + e
    n, kq = np.meshgrid(np.arange(bm), np.arange(16), indexing="ij")
    for s in range(rbk // 16):
        addr = 32 * s + (n % 8) * 128 + (n // 8) * 1024 + 2 * kq
        assert np.array_equal(a[_phys(addr) // 2], n * rbk + 16 * s + kq)


def _fragments(raw, rs, bits, wg, warp, g, t):
    """a_fragments_rows on the raw tile ``raw`` (bytes, rows of ``rs``):
    per 16-deep slice s the four bf16x2 registers of thread (g, t) of warp
    ``warp`` in warpgroup ``wg``, each as its (low, high) pair of codes."""
    c0 = 64 * wg + 16 * warp + 2 * g
    col = c0 if bits == 8 else c0 // 2
    out = []
    for s in range(4):
        regs = [None] * 4
        for h in range(2):
            k = 16 * s + 2 * t + 8 * h
            if bits == 8:
                lo, hi = raw[k * rs + col:k * rs + col + 2]
                lo1, hi1 = raw[(k + 1) * rs + col:(k + 1) * rs + col + 2]
                w = lo | (hi << 8) | (lo1 << 16) | (hi1 << 24)
                regs[2 * h] = (_i8_pair(torch.tensor(w)).item(),
                               _i8_pair(torch.tensor(w >> 16)).item())
                regs[2 * h + 1] = (_i8_pair(torch.tensor(w >> 8)).item(),
                                   _i8_pair(torch.tensor(w >> 24)).item())
            else:
                w = raw[k * rs + col] | (raw[(k + 1) * rs + col] << 16)
                regs[2 * h] = (_i4_pair(torch.tensor(w)).item(),
                               _i4_pair(torch.tensor(w >> 16)).item())
                regs[2 * h + 1] = (_i4_pair(torch.tensor(w >> 4)).item(),
                                   _i4_pair(torch.tensor(w >> 20)).item())
        out.append(regs)
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_code_fragments_hold_the_transposed_codes(bits):
    """Swap-AB: the A operand of warpgroup wg is the codes of its 64 output
    columns, transposed.  Reading each thread's registers in mma's
    m16n8k16 A layout (register 0: M row g, K 2t and 2t + 1; 1: row g + 8;
    2 and 3: K + 8) gives A[M row][k] = code[k][column], M row 16 w + g
    being column 16 w + 2 g and row 16 w + g + 8 column 16 w + 2 g + 1;
    and a warp's fragment reads hit distinct banks."""
    rng = np.random.default_rng(bits)
    lim = 8 if bits == 4 else 128
    codes = rng.integers(-lim, lim, size=(KQ.ROWS_BK, KQ.ROWS_BN))
    if bits == 8:
        row = codes.astype(np.int8).view(np.uint8)
    else:
        row = TQ.pack_int4(torch.from_numpy(codes).to(torch.int32)).view(
            torch.uint8).numpy()
    rs = row.shape[1] + 16
    raw = np.zeros(KQ.ROWS_BK * rs, np.int64)
    for k in range(KQ.ROWS_BK):
        raw[k * rs:k * rs + row.shape[1]] = row[k]
    for wg in range(2):
        a = np.full((4, 64, 16), np.nan)
        for warp in range(4):
            for g in range(8):
                for t in range(4):
                    fr = _fragments(raw, rs, bits, wg, warp, g, t)
                    for s in range(4):
                        for reg in range(4):
                            mrow = 16 * warp + g + 8 * (reg & 1)
                            kk = 2 * t + 8 * (reg >> 1)
                            a[s, mrow, kk:kk + 2] = fr[s][reg]
        cols = np.array([64 * wg + 16 * (r // 16) + 2 * (r % 8) + (r % 16) // 8
                         for r in range(64)])
        want = codes[:, cols].T.reshape(64, 4, 16).transpose(1, 0, 2)
        np.testing.assert_array_equal(a, want)
    # bank of each thread's first read (row 2t, its byte(s)): a warp's 32
    # reads at one instruction touch 32 distinct 4-byte words at most 2 per
    # bank... here: distinct banks for distinct words
    for warp in range(4):
        words = {}
        for g in range(8):
            for t in range(4):
                c0 = 16 * warp + 2 * g
                addr = 2 * t * rs + (c0 if bits == 8 else c0 // 2)
                words.setdefault((addr // 4) % 32, set()).add(addr // 4)
        assert all(len(v) == 1 for v in words.values())


# ---------------------------------------------------------------------------
# the plain version against the reference's Pallas kernel, many rows
# ---------------------------------------------------------------------------
def _inputs(bits, integer, seed):
    rng = np.random.default_rng(seed)
    m, k, n = 257, 200, 136
    lim = 8 if bits == 4 else (32 if integer else 128)
    codes = rng.integers(-lim, lim, size=(k, n)).astype(np.int32)
    if integer:
        x = rng.integers(-16, 17, size=(m, k)).astype(np.float32)
        s = np.full((n,), 0.5, np.float32)
    else:
        x = rng.uniform(-1, 1, size=(m, k)).astype(np.float32)
        s = rng.uniform(0.001, 0.02, size=(n,)).astype(np.float32)
    w = (np.asarray(JQ.pack_int4(jnp.asarray(codes))) if bits == 4
         else codes.astype(np.int8))
    return x, w, s


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_equals_pallas_on_integers_across_row_tiles(bits):
    """M 257 crosses the reference's 128-row tile twice, N 136 its
    128-column tile, K 200 its 128-deep step: integer-valued x and small
    codes keep every partial sum an integer below 2^24, so the plain
    version equals the Pallas kernel bit for bit."""
    x, w, s = _inputs(bits, True, bits)
    pallas = np.asarray(jops.qmatmul(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(s), bits=bits,
                                     interpret=True))
    got = KQ.qmatmul(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(s), bits=bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_pallas_across_row_tiles(bits, dtype):
    """The same shape on random x: within the tolerance of
    ``test_qmatmul_w8_plain_equals_pallas_and_ref`` (rtol/atol 2e-2: bf16
    outputs round, and the two sum in another order)."""
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    x, w, s = _inputs(bits, False, 10 + bits)
    pallas = jops.qmatmul(jnp.asarray(x, jdt), jnp.asarray(w),
                          jnp.asarray(s), bits=bits, interpret=True)
    got = KQ.qmatmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                     torch.from_numpy(s), bits=bits)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), rtol=2e-2,
                               atol=2e-2)
