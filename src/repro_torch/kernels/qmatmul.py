"""Weight-only quantized matmul on the card: the wrapper around the
hand-written CUDA kernels (``csrc/qmatmul.cu``) beside their plain version.

Counterpart of the JAX package's ``kernels/qmatmul.py``
(``qmatmul_pallas``): ``bf16(x) @ codes`` with float32 accumulation, times
a per-output-channel scale, cast to x's dtype; codes are int8 (w8) or
packed int4 (w4, low nibble = even column).  The wrapper takes the plain
version only for tensors that lie on the CPU; for CUDA tensors it launches
the kernel or raises.  It allocates the output (and, when K is split, the
float32 scratch of the splits' sums) with ``torch.empty``, launches on
PyTorch's current stream, checks ``cudaGetLastError`` and counts the
launch.  Two kernels share the function, and :func:`qmm_route` picks one
per shape: ``qmm_kernel`` for decode shapes (up to 8 rows a block, the
codes streamed once per row tile, K split over the card), and
``qmm_rows_kernel`` for many rows (tiles of 128 columns by 64 to 128 rows
on bf16 ``wgmma``, each code decoded once per tile into the registers of
the A operand).  How the work is cut into blocks
(:func:`split_plan`, :func:`rows_plan`) is decided here, in Python, so the
CPU tests reach it.  When K is split, the decode kernel adds the splits
itself (one launch per call): the wrapper hands it float32 scratch from the
caching allocator and the device's tile counters.

Called while a CUDA graph captures (the decode step of
``launch.steps.GraphedDecodeStep``), the same code is captured: the output
and the scratch come from ``torch.empty`` in the graph's private memory
pool, which is what a replay reuses; the tile counters are the graph's own
(``build.GraphState``); and the launch is recorded in the graph and counted
at each replay.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build as B
from repro_torch.kernels import ref

__all__ = ["qmatmul", "qmatmul_plain", "qmm_route", "rows_plan",
           "split_plan"]

STAGE_BYTES = 16384    # codes per ring stage (csrc/qmatmul.cu)
MAX_SPLITS = 16        # more never measured faster at the decode shapes
RESIDENT_PER_SM = 2    # blocks of 256 threads an SM holds at once
X_SMEM_MAX = 64 * 1024  # staged x of a block, bytes
_X_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = ("decode", "rows")

# The many-row kernel (csrc/qmatmul.cu, qmm_rows_kernel): a block of 256
# threads owns ROWS_BMS rows of x and ROWS_BN columns and walks K in
# ROWS_BK-row steps through a ring of ROWS_STAGES stages.
ROWS_M = 16              # the rows route from this many rows of x on,
ROWS_MN = 1 << 17        # and an output of at least this many elements
ROWS_BN, ROWS_BK, ROWS_STAGES = 128, 64, 4
ROWS_BMS = (64, 80, 96, 128)  # tile rows the kernel is built for
# A K step of a tile costs about ROWS_STEP_ROWS + tile rows rows' worth of
# tensor-core time: the decode, the copies and the barrier are paid per
# tile, whatever its rows (tools/sweep_qmatmul_splits.py --rows)
ROWS_STEP_ROWS = 128
ROWS_THREADS, ROWS_REGS = 256, 128   # __launch_bounds__(256, 2)
SMEM_PER_SM = 233472     # bytes an SM holds for blocks (228 KB)
SMEM_PER_BLOCK = 232448  # bytes one block may use (227 KB)
SMEM_RESERVED = 1024     # bytes the card keeps for each resident block
REGS_PER_SM = 65536


def stage_rows(bits: int, bn: int) -> int:
    """Rows of K in one ring stage of a ``bn``-column tile."""
    return STAGE_BYTES // (bn * bits // 8)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _reject(x, w_codes, scale, bits) -> None:
    """Raise naming the first argument ``qmatmul`` does not take."""
    _require(bits in (4, 8), f"bits must be 4 or 8, got {bits}")
    for name, t, nd in (("x", x, 2), ("w_codes", w_codes, 2),
                        ("scale", scale, 1)):
        _require(t.ndim == nd, f"{name} must be {nd}-D, got shape "
                 f"{tuple(t.shape)}")
        _require(t.device == x.device, f"{name} is on {t.device}, expected "
                 f"{x.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(x.dtype in _X_BF16, f"x must be float32 or bfloat16, got {x.dtype}")
    _require(w_codes.dtype == torch.int8, f"codes must be int8, got "
             f"{w_codes.dtype}")
    _require(scale.dtype == torch.float32, f"scale must be float32, got "
             f"{scale.dtype}")
    _require(w_codes.shape[0] == x.shape[1], f"codes rows {w_codes.shape[0]} "
             f"!= x cols {x.shape[1]}")
    n = w_codes.shape[1] * (2 if bits == 4 else 1)
    raise ValueError(f"scale must be ({n},), got {tuple(scale.shape)}")


def _rows_per_block(m: int) -> int:
    return 1 if m <= 1 else 2 if m <= 2 else 4 if m <= 4 else 8


def _cut_k(k: int, splits: int, quantum: int) -> Tuple[int, int]:
    """(splits, rows per split): ``splits`` slices of a multiple of
    ``quantum`` rows, none empty."""
    kps = -(-max(k, 1) // max(1, splits))
    kps = -(-kps // quantum) * quantum
    return -(-max(k, 1) // kps), kps


@functools.lru_cache(maxsize=None)
def split_plan(m: int, k: int, n: int, sms: int,
               bits: int = 8) -> Tuple[int, int, int, int]:
    """(rows per block, column-tile width, K splits, K rows per split) for
    an (m, k) x (k, n) product on a card with ``sms`` multiprocessors.

    A block takes the smallest of 1, 2, 4 or 8 rows that holds all of a
    decode batch (more rows come in further blocks) and 128 columns, or 64
    where 128-column tiles would number under half the SMs.  K is split as
    far as each split streams at least one ring stage (:func:`stage_rows`)
    and the blocks still fit on the card at once: ``RESIDENT_PER_SM`` per
    SM with 128-column tiles, one longer block per SM with 64 (fewer
    blocks, each prologue and split handshake paid over more bytes), up
    to ``MAX_SPLITS``; further while a block's staged x would exceed
    ``X_SMEM_MAX``.  ``tools/sweep_qmatmul_splits.py`` on the H100: a
    second wave of blocks, or splits shorter than a stage, cost more than
    they bring (wk and wv, N = 256, are fastest with 16 to 32 blocks: their
    time is the launch's fixed latency, not bandwidth).
    """
    mt = _rows_per_block(m)
    row_tiles = -(-max(m, 1) // mt)
    bn = 128 if -(-n // 128) * row_tiles * 2 >= sms else 64
    tiles = -(-n // bn) * row_tiles
    ks = stage_rows(bits, bn)
    resident = RESIDENT_PER_SM if bn == 128 else 1
    want = min(MAX_SPLITS, resident * sms // tiles, k // ks)
    splits, kps = _cut_k(k, max(1, want), 16)
    while (splits < MAX_SPLITS and kps >= 2 * ks
           and mt * (-(-kps // ks) * ks + 8) * 2 > X_SMEM_MAX):
        splits, kps = _cut_k(k, splits + 1, 16)
    return mt, bn, splits, kps


def rows_smem(bits: int, bm: int) -> int:
    """Dynamic shared memory of a many-row block of ``bm`` rows of x: 1 KB
    to align the ring to a swizzle atom, and ROWS_STAGES x (x tile in bf16
    + raw code tile, its rows padded by 16 bytes) (csrc/qmatmul.cu,
    RTile::SMEM)."""
    return 1024 + ROWS_STAGES * (bm * ROWS_BK * 2
                                 + ROWS_BK * (ROWS_BN * bits // 8 + 16))


@functools.lru_cache(maxsize=None)
def rows_plan(m: int, k: int, n: int, sms: int,
              bits: int = 8) -> Tuple[int, int, int, int, int]:
    """(tile rows, tile columns, stages, resident blocks per SM, shared
    memory bytes) of the many-row kernel for an (m, k) x (k, n) product on
    a card with ``sms`` multiprocessors.

    A tile is ROWS_BN = 128 columns by 64, 80, 96 or 128 rows of x: the
    height whose busiest SM has the least to do, its tiles (rounded up)
    times ROWS_STEP_ROWS + the height, the tallest on a tie.  At whisper's
    N 384 and M 6,000 that is 80: 225 tiles, 2 of 80 rows on the busiest
    SM, against 189 of 96 (2 of 96), 141 of 128 (2 of 128 on 9 SMs) and
    282 of 64 (3).  Two blocks fit on an SM at once (shared memory and 128
    registers a thread), so a second tile on an SM runs beside the
    first."""
    cols = -(-max(n, 1) // ROWS_BN)

    def busiest(bm):
        return -(-(-(-max(m, 1) // bm) * cols) // sms) * (ROWS_STEP_ROWS + bm)

    bm = min(reversed(ROWS_BMS), key=busiest)
    smem = rows_smem(bits, bm)
    resident = min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                   REGS_PER_SM // (ROWS_THREADS * ROWS_REGS))
    return bm, ROWS_BN, ROWS_STAGES, resident, smem


@functools.lru_cache(maxsize=None)
def qmm_route(m: int, k: int, n: int, sms: int, bits: int = 8) -> str:
    """``"decode"`` (``qmm_kernel``) or ``"rows"`` (``qmm_rows_kernel``)
    for an (m, k) x (k, n) product on a card with ``sms`` multiprocessors.

    The rows route from ``ROWS_M`` rows of x and ``ROWS_MN`` output
    elements on.  Below that the many-row kernel has few tiles, each
    walking all of K alone (22 us at K 2,048 whatever the rows), while the
    decode kernel splits K over the card; above it the decode kernel,
    which streams and decodes every code once per 8 rows, loses.  On the
    H100 (``tools/sweep_qmatmul_splits.py --rows``, 14 shapes x 15 sizes
    from M 16) this rule costs 1.2% over the faster route in geometric
    mean; the crossover itself runs from M 16 (N 11,008) to M 1,024 (N
    256).  A decode batch (M <= 8) always takes the decode kernel."""
    return "rows" if m >= ROWS_M and m * n >= ROWS_MN else "decode"


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def qmatmul_plain(x: torch.Tensor, w_codes: torch.Tensor,
                  scale: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Plain version: ``(f32(bf16(x)) @ f32(codes)) * scale`` cast to
    x's dtype."""
    return ref.qmatmul(x, w_codes, scale, bits)


def qmatmul(x: torch.Tensor, w_codes: torch.Tensor, scale: torch.Tensor,
            bits: int = 8, *, splits: Optional[int] = None,
            bn: Optional[int] = None, bm: Optional[int] = None,
            route: Optional[str] = None) -> torch.Tensor:
    """(M, K) float32/bf16 x (K, N) int8 codes (bits 8) or (K, N/2) packed
    int4 (bits 4), per-channel (N,) float32 scale -> (M, N) of x's dtype.

    ``route`` overrides :func:`qmm_route`; ``bn`` and ``splits`` override
    the decode kernel's column-tile width and K splits
    (:func:`split_plan`), ``bm`` the many-row kernel's tile rows
    (:func:`rows_plan`), for measurement and tests.  The result differs
    from the plain version only in the order of the float32 sum."""
    if not x.is_cuda:
        return qmatmul_plain(x, w_codes, scale, bits)
    # one boolean test on the hot path (252 calls per decode step); the
    # messages are built only when it fails
    dev = x.device
    m, k = x.shape if x.ndim == 2 else (-1, -1)
    n = (w_codes.shape[-1] if w_codes.ndim else 0) * (2 if bits == 4 else 1)
    if not (bits in (4, 8) and x.ndim == 2 and w_codes.ndim == 2
            and scale.ndim == 1 and w_codes.device == dev
            and scale.device == dev and x.is_contiguous()
            and w_codes.is_contiguous() and scale.is_contiguous()
            and x.dtype in _X_BF16 and w_codes.dtype == torch.int8
            and scale.dtype == torch.float32 and w_codes.shape[0] == k
            and scale.shape[0] == n):
        _reject(x, w_codes, scale, bits)
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    sms = _sms(dev.index or 0)
    if route is None:
        route = qmm_route(m, k, n, sms, bits)
    _require(route in _ROUTES, f"route must be one of {_ROUTES}, got {route!r}")
    if route == "rows":
        _require(splits is None and bn is None,
                 "the rows route takes neither splits nor bn")
        _require(bm is None or bm in ROWS_BMS,
                 f"bm must be one of {ROWS_BMS}, got {bm}")
        tbm = rows_plan(m, k, n, sms, bits)[0] if bm is None else bm
        rc = B.library().qmatmul_rows(x.data_ptr(), _X_BF16[x.dtype],
                                      w_codes.data_ptr(), bits,
                                      scale.data_ptr(), out.data_ptr(),
                                      m, k, n, tbm, _stream())
        B.check(rc, "qmatmul_rows")
        B.count_launch("qmatmul", "qmatmul_rows")
        return out
    _require(bm is None, "the decode route takes no bm")
    mt, tbn, sp, kps = split_plan(m, k, n, sms, bits)
    if bn is not None:
        _require(bn in (64, 128), f"bn must be 64 or 128, got {bn}")
        tbn = bn
    if splits is not None:
        sp, kps = _cut_k(k, min(int(splits), MAX_SPLITS), 16)
    ws = counts = None
    if sp > 1:
        tiles = -(-m // mt) * -(-n // tbn)
        counts = B.tile_counters(dev, tiles)
        # the caching allocator reuses ws only after this launch on the stream
        ws = torch.empty(tiles * sp * 8 * tbn, dtype=torch.float32, device=dev)
    rc = B.library().qmatmul(x.data_ptr(), _X_BF16[x.dtype],
                             w_codes.data_ptr(), bits, scale.data_ptr(),
                             out.data_ptr(),
                             None if ws is None else ws.data_ptr(),
                             None if counts is None else counts.data_ptr(),
                             m, k, n, mt, tbn, sp, kps, _stream())
    B.check(rc, "qmatmul")
    B.count_launch("qmatmul")
    return out
