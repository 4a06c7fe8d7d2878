"""MVAU on the card: wrappers around the hand-written CUDA kernels
(``csrc/mvau.cu``), each beside its plain PyTorch version.

Counterpart of the JAX package's ``kernels/mvau.py`` (``mvau_int_pallas``,
``mvau_pallas``).  Three kernels serve every MVAU on the card, and the
integer MVAU takes one of three routes, chosen by the codes' ranges
(:func:`int_route`, decided once when a graph is lowered) and carried by
the dtype of the activation codes a wrapper is handed:

* ``int8`` -- int8 activation codes x int8 (or packed int4) weight codes on
  the tensor cores (``mvau_conv_kernel``, ``wgmma`` s8.s8), except the GEMM
  form at decode shapes (M at most :data:`SMALL_M_ROWS`, tables of at most
  :data:`SMALL_M_MAX_LEVELS` levels: :func:`int8_gemm_route`), which runs
  ``mvau_small_m_kernel`` (``mma.sync`` with the output columns on the
  MMA's 16-wide side, the threshold rows searched in shared memory);
* ``planes`` -- activation codes of up to 24 bits against weights of up to
  16 on the same int8 tensor cores (``mvau_conv_kernel``): uint8 activation
  codes (0..255) x int8 weights as one ``wgmma`` u8.s8 (the DSE's (8, 8)
  point), and wider codes as byte planes, one ``wgmma`` product for each
  pair of an activation plane and a weight plane, recombined exactly: int16
  codes (9 to 16 bits, two planes) or int32 codes (17 to 24 bits, three
  planes) x the weights' (P_w, N, Kp) byte planes from
  :func:`weight_planes` (two for 16-bit weights, one for int8 weights), 2
  to 6 products (``paper_w16a16()``, its 17-bit c2 among them), while K is
  at most :data:`PLANE_MAX_K`;
* ``core`` -- int32 activation codes past 24 bits (or weights past 16, or
  K past the limit) and the float MVAU on the CUDA cores
  (``mvau_core_kernel``: exact int32 multiply-add, or float32 FMA).

The wgmma and CUDA-core kernels read conv patch rows straight from the
NHWC activation (:func:`mvau_int_conv`, :func:`mvau_conv`: the ``im2col``
before them folded into their loads); the GEMM form (M, K) is their 1 x 1
case.  The
tensor-core kernel also folds a residual ``add`` and the GlobalAccPool
after it into its epilogue (:func:`mvau_int_conv_gap`).  A
wrapper takes the plain version only for tensors that lie on the CPU; for
CUDA tensors it launches a kernel or raises.  It allocates the output (and
any split-K scratch) with ``torch.empty``, launches on PyTorch's current
stream, checks ``cudaGetLastError`` and counts the launch.  Called while a
CUDA graph captures (a warmed bucket of ``core.deploy.DeployedModel``), the
same code is captured: the output and the split-K scratch then come from
``torch.empty`` in the graph's private memory pool, which is what a replay
reuses; the tile counters are the graph's own (``build.GraphState``); and
the launch is recorded in the graph and counted at each replay.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import build as B
from repro_torch.kernels import gap as kgap
from repro_torch.kernels import ref

__all__ = ["mvau_int", "mvau_int_conv", "mvau_int_conv_gap", "mvau", "mvau_conv",
           "mvau_int_plain", "mvau_int_conv_plain", "mvau_int_conv_gap_plain",
           "mvau_plain", "mvau_conv_plain", "tc_splits", "core_splits",
           "int8_gemm_route", "SMALL_M_ROWS", "SMALL_M_MAX_LEVELS",
           "int_route", "code_kind", "weight_planes", "plane_matmul",
           "plane_depth", "plane_tile_rows", "x_planes", "x_dtype",
           "PLANE_MAX_K"]

# weight kinds of csrc/mvau.cu
_W_KIND = {torch.int8: 0, torch.int32: 1, torch.int16: 4}
W_F32, W_PACKED4 = 2, 3


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_2d(name: str, t: torch.Tensor, device: torch.device) -> None:
    _require(t.ndim == 2, f"{name} must be 2-D, got shape {tuple(t.shape)}")
    _require(t.device == device, f"{name} is on {t.device}, expected {device}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# Split K
# ---------------------------------------------------------------------------
TC_TILE = (128, 128, 64)      # csrc/mvau.cu tensor-core tile: M x N x K bytes
CORE_TILE_M, CORE_TILE_K = 128, 16   # CUDA-core tile: 128 x core_tile_n x 16


def core_tile_n(n: int) -> int:
    """Output columns of a CUDA-core block: 64 where N <= 64, else 128."""
    return 64 if n <= 64 else 128


def _plan(tiles: int, k_tiles: int, sms: int) -> int:
    # 1 where the output tiles cover the SMs, else up to two blocks per SM,
    # each split keeping at least 16 K-tiles
    if tiles >= sms:
        return 1
    return max(1, min(k_tiles // 16, (2 * sms) // tiles))


def tc_splits(m: int, n: int, k: int, sms: int, bm: int = TC_TILE[0]) -> int:
    """K-splits of one tensor-core launch of ``bm``-row tiles (64 for the
    plane route's 24-bit codes, :func:`plane_tile_rows`): 1 where the
    output tiles cover the SMs, else up to two blocks per SM, each split
    keeping at least 16 K-tiles (shorter splits lose more to the
    partial-sum round trip than the extra blocks gain:
    ``tools/probe_mvau_conv.py``'s sweep on the H100).  The split changes
    no bit (integer sums)."""
    _, bn, bk = TC_TILE
    return _plan(-(-m // bm) * -(-n // bn), -(-k // bk), sms)


# The int8 GEMM form's route: rows of x up to which mvau_small_m_kernel is
# no slower than the wgmma kernel at every shape tools/probe_mvau_conv.py
# --only gemm sweeps on the H100 (the least crossover: K 1,152 x N 512 at
# 15 levels, 0.0279 against 0.0300 ms at 512 rows, slower at 768; at
# lm-tiny's w_down it never crosses up to 8,192), and the longest table
# whose 16 rows a block stages in shared memory (csrc/mvau.cu SM_MAX_L).
SMALL_M_ROWS = 512
SMALL_M_MAX_LEVELS = 2048


def int8_gemm_route(m: int, levels: int) -> str:
    """Which kernel runs an int8 GEMM-form MVAU of ``m`` rows against
    tables of ``levels`` levels: ``"small_m"`` (``mvau_small_m_kernel``)
    where ``m <= SMALL_M_ROWS`` and the table fits its shared memory,
    else ``"wgmma"`` (``mvau_conv_kernel``).  A pure function of the
    shapes; either route gives the same bits (integer sums)."""
    if m <= SMALL_M_ROWS and levels <= SMALL_M_MAX_LEVELS:
        return "small_m"
    return "wgmma"


# The byte-plane route's longest K (csrc/mvau.cu PLANE_MAX_K): a k adds to
# one accumulator set at most two byte products, 2 * 255 * 255, so every
# set's sum stays inside int32, for every plane kind.
PLANE_MAX_K = (2**31 - 1) // (2 * 255 * 255)
# the activation-code kinds of csrc/mvau.cu's repro_mvau_int_planes_conv
_X_KIND = {"u8": 1, "s16": 2, "u16": 3, "s24": 4, "u24": 5}
# activation planes of each kind, and its tensor's dtype on the card
_X_PLANES = {"u8": 1, "s16": 2, "u16": 2, "s24": 3, "u24": 3}
_X_DTYPE = {"u8": torch.uint8, "s16": torch.int16, "u16": torch.int16,
            "s24": torch.int32, "u24": torch.int32}


def code_kind(lo: int, hi: int) -> Optional[str]:
    """The narrowest tensor-core operand form of integer codes in [lo, hi]:
    ``"s8"``, ``"u8"`` (0..255), ``"s16"``, ``"u16"`` (0..65535),
    ``"s24"`` (-2^23 .. 2^23 - 1), ``"u24"`` (0 .. 2^24 - 1), or None for
    codes wider than 24 bits."""
    for kind, a, b in (("s8", -128, 127), ("u8", 0, 255),
                       ("s16", -32768, 32767), ("u16", 0, 65535),
                       ("s24", -2**23, 2**23 - 1), ("u24", 0, 2**24 - 1)):
        if a <= lo and hi <= b:
            return kind
    return None


def int_route(x_range: Tuple[int, int], w_range: Tuple[int, int],
              k: int) -> Tuple[str, Optional[str], int]:
    """The card's route for an integer MVAU of K = ``k`` whose activation
    and weight codes lie in ``x_range`` and ``w_range``: ``(route, x kind,
    wgmma products a K-step)``.

    * ``("int8", "s8", 1)``: both fit int8, ``wgmma`` s8.s8;
    * ``("planes", "u8", 1)``: unsigned activations of up to 8 bits
      (0..255) against int8 weights, one ``wgmma`` u8.s8;
    * ``("planes", "s16" | "u16", 2 P_w)``: activation codes of up to 16
      bits against weights that do not both fit 8 bits, two activation
      byte planes; ``"u16"`` where the codes reach past 32,767 (their high
      byte is then unsigned);
    * ``("planes", "s24" | "u24", 3 P_w)``: activation codes of 17 to 24
      bits, three planes; ``"u24"`` where they reach past 2^23 - 1;

      P_w, the weights' planes, is 1 for int8 weights and 2 for weights of
      up to 16 bits, so 2, 4, 3 or 6 products, each one ``wgmma``, while
      ``k`` is at most :data:`PLANE_MAX_K`;
    * ``("core", None, 1)``: activation codes past 24 bits, weights past
      16, or K past the limit, on the CUDA cores."""
    xk, wk = code_kind(*x_range), code_kind(*w_range)
    if xk == "s8" and wk == "s8":
        return "int8", "s8", 1
    if xk == "u8" and wk == "s8":
        return "planes", "u8", 1
    if xk is None or wk not in ("s8", "u8", "s16") or k > PLANE_MAX_K:
        return "core", None, 1
    if xk in ("s8", "u8"):
        xk = "s16"
    return "planes", xk, _X_PLANES[xk] * (1 if wk == "s8" else 2)


def x_planes(kind: str) -> int:
    """Activation byte planes of plane-route kind ``kind``: 1 (``u8``), 2
    (``s16``, ``u16``) or 3 (``s24``, ``u24``)."""
    return _X_PLANES[kind]


def x_dtype(kind: str) -> torch.dtype:
    """The dtype in which the card's plane route takes activation codes of
    ``kind``: uint8, int16 (the low 16 bits) or int32."""
    return _X_DTYPE[kind]


def plane_tile_rows(kind: Optional[str]) -> int:
    """Rows of the tensor-core kernel's output tile for activation codes of
    ``kind``: 64 for three planes (24-bit codes: four accumulator sets of a
    128-row tile would fill the register file), else 128."""
    return 64 if kind in ("s24", "u24") else TC_TILE[0]


def plane_depth(k: int) -> int:
    """K of the byte planes: ``k`` rounded up to a multiple of 16."""
    return -(-k // 16) * 16


def weight_planes(w: torch.Tensor, w_packed: bool = False,
                  planes: int = 2) -> torch.Tensor:
    """(K, N) integer weight codes (int8, int16 or int32; or (K, N/2)
    packed int4 with ``w_packed``) -> their byte planes, the weight operand
    of the byte-plane route: (``planes``, N, Kp) int8, K-major, Kp =
    :func:`plane_depth` (K), zero past K.  Two planes for codes within
    int16: plane 0 holds each code's low byte (read as unsigned), plane 1
    its high byte (signed), so that ``code = 256 * plane1 + (plane0 &
    255)``; one plane for codes within int8: the codes.  The lowering
    prepares them once per graph; no call splits weights."""
    if w_packed:
        w = quant.unpack_int4(w)
    wi = w.to(torch.int32)
    _require(wi.ndim == 2, f"w must be 2-D, got shape {tuple(wi.shape)}")
    _require(planes in (1, 2), f"weights take 1 or 2 byte planes, not "
             f"{planes}")
    lim = 128 if planes == 1 else 32768
    _require(bool((wi >= -lim).all()) and bool((wi < lim).all()),
             f"weight codes must fit int{8 * planes} for {planes} byte "
             "plane(s)")
    k, n = wi.shape
    out = torch.zeros((planes, n, plane_depth(k)), dtype=torch.int8,
                      device=w.device)
    wt = wi.t()
    if planes == 1:
        out[0, :, :k] = wt.to(torch.int8)
    else:
        out[0, :, :k] = (wt & 255).to(torch.uint8).view(torch.int8)
        out[1, :, :k] = (wt >> 8).to(torch.int8)
    return out


def _matmul_i64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # exact: in int64 on the CPU, in float64 (sums below 2^53) on the card
    if a.is_cuda:
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)
                            ).to(torch.int64)
    return torch.matmul(a.to(torch.int64), b.to(torch.int64))


def plane_matmul(x: torch.Tensor, planes: torch.Tensor,
                 x_unsigned: bool = False) -> torch.Tensor:
    """The byte-plane route's arithmetic as plain tensor code: (M, K)
    int16 codes (the low 16 bits of each; two planes) or int32 codes (of
    up to 24 bits; three planes, the fourth byte not read) x the (P_w, N,
    Kp) planes of :func:`weight_planes` -> (M, N) int32 ``Σ_s acc_s << 8
    s`` in uint32, reinterpreted, where ``acc_s`` sums the products
    ``x_i · w_j`` with ``i + j = s`` over the codes' bytes: every byte
    unsigned but the top one, which takes the code's sign (unsigned with
    ``x_unsigned``: codes up to 65535 or 2^24 - 1); a single weight plane
    is the int8 codes themselves.  That is the exact product wherever it
    fits int32."""
    _require(x.dtype in (torch.int16, torch.int32),
             f"the byte planes take int16 or int32 codes, got {x.dtype}")
    k = x.shape[-1]
    px, pw = (2 if x.dtype == torch.int16 else 3), planes.shape[0]
    xi = x.to(torch.int32)
    xs = [(xi >> (8 * i)) & 255 for i in range(px)]
    if not x_unsigned:
        xs[-1] = xs[-1] - ((xs[-1] & 128) << 1)
    wp = [planes[j, :, :k].to(torch.int32) for j in range(pw)]
    ws = [(p & 255 if j < pw - 1 else p).t() for j, p in enumerate(wp)]
    sets = [0] * (px + pw - 1)
    for i in range(px):
        for j in range(pw):
            sets[i + j] = sets[i + j] + _matmul_i64(xs[i], ws[j])
    v = sum(acc << (8 * s) for s, acc in enumerate(sets)) & 0xFFFFFFFF
    return (v - ((v >> 31) << 32)).to(torch.int32)


def core_splits(m: int, n: int, k: int, sms: int) -> int:
    """K-splits of one CUDA-core launch, by the same rule on its 128 x BN x
    16 tiles.  Integer sums and float sums on the fixed-point grid are
    exact, so the split changes no bit there; off the grid it may move a
    float sum by rounding, the same in every launch."""
    tiles = -(-m // CORE_TILE_M) * -(-n // core_tile_n(n))
    return _plan(tiles, -(-k // CORE_TILE_K), sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_scratch(m: int, n: int, k: int, dev: torch.device,
                   splits: Optional[int], core: bool = False,
                   bm: int = TC_TILE[0]
                   ) -> Tuple[int, Optional[int], Optional[int]]:
    """(splits, scratch pointer, counters pointer) for one launch of the
    tensor-core kernel on ``bm``-row tiles, or of the CUDA-core one
    (``core``); the scratch holds each output tile's and split's partial
    sums, 32 bits each."""
    if core:
        bm, bn, bk = CORE_TILE_M, core_tile_n(n), CORE_TILE_K
        planner = core_splits
    else:
        _, bn, bk = TC_TILE
        planner = functools.partial(tc_splits, bm=bm)
    if splits is None:
        splits = planner(m, n, k, _sm_count(dev.index or 0))
    kt = max(1, -(-k // bk))
    splits = max(1, min(int(splits), kt))
    splits = -(-kt // -(-kt // splits))   # as the launcher: no empty split
    if splits == 1:
        return 1, None, None
    tiles = -(-m // bm) * -(-n // bn)
    ws = torch.empty((tiles, splits, bm * bn), dtype=torch.int32, device=dev)
    counts = B.tile_counters(dev, tiles)
    # the caching allocator reuses ws only after this launch on the stream
    return splits, ws.data_ptr(), counts.data_ptr()


def _core(x: torch.Tensor, w: torch.Tensor, w_kind: int,
          thresholds: torch.Tensor, geom: Tuple[int, ...], n: int,
          out_base=0, out_scale: float = 1.0, out_bias: float = 0.0,
          splits: Optional[int] = None, name: str = "mvau") -> torch.Tensor:
    """One launch of the CUDA-core kernel on the NHWC activation ``x``
    (float32, or int32 codes), ``geom`` = (B, H, W, C, kernel, stride, pad)
    -> (B, OH, OW, N) of x's dtype."""
    b, h, wd, c, kernel, stride, pad = geom
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (wd + 2 * pad - kernel) // stride + 1
    floating = x.dtype == torch.float32
    out = torch.empty((b, oh, ow, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    m, k = b * oh * ow, kernel * kernel * c
    splits, ws, counts = _split_scratch(m, n, k, x.device, splits, core=True)
    rc = B.library().mvau_core_conv(
        x.data_ptr(), int(floating), w.data_ptr(), w_kind,
        thresholds.data_ptr(), out.data_ptr(), b, h, wd, c, kernel, stride,
        pad, n, thresholds.shape[1], 0 if floating else int(out_base),
        float(out_base) if floating else 0.0, float(out_scale),
        float(out_bias), splits, ws, counts, _stream())
    B.check(rc, name)
    if name == "mvau_int":
        B.count_launch(name, "mvau_int_wide")
    else:
        B.count_launch(name)
    return out


# ---------------------------------------------------------------------------
# Integer MVAU (replaces mvau_int_pallas)
# ---------------------------------------------------------------------------
def mvau_int_plain(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
                   out_base: int = 0, w_packed: bool = False,
                   x_unsigned: bool = False) -> torch.Tensor:
    """Plain version: ``out_base + Σ_l 1[x @ w ≥ T[n, l]]`` as int32; for
    (P_w, N, Kp) byte planes ``w`` (int16 or int32 ``x``), the byte-plane
    route's own decomposition (:func:`plane_matmul`)."""
    if w.ndim == 3:
        acc = plane_matmul(x, w, x_unsigned)
        return (out_base + quant.threshold_counts(acc, thresholds)
                ).to(torch.int32)
    if w_packed:
        w = quant.unpack_int4(w)
    return ref.mvau_int(x, w, thresholds, out_base=out_base)


def _w_kind(w: torch.Tensor, w_packed: bool) -> Tuple[int, int]:
    """(N, weight kind) of integer weight codes."""
    if w_packed:
        _require(w.dtype == torch.int8, "packed int4 weights must be int8")
        return 2 * w.shape[1], W_PACKED4
    _require(w.dtype in _W_KIND,
             f"w must be int8, int16 or int32 codes, got {w.dtype}")
    return w.shape[1], _W_KIND[w.dtype]


def _on_tensor_cores(x: torch.Tensor, w_kind: int) -> bool:
    return x.dtype == torch.int8 and w_kind in (_W_KIND[torch.int8],
                                                W_PACKED4)


def _planes(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
            geom: Tuple[int, ...], n: int, out_base, x_unsigned: bool,
            skip: Optional[torch.Tensor] = None,
            splits: Optional[int] = None) -> torch.Tensor:
    """One launch of the tensor-core kernel on the plane route, NHWC
    ``x`` of ``geom`` = (B, H, W, C, kernel, stride, pad): uint8 codes
    against (K, N) int8 weights, or int16 or int32 codes against (P_w, N,
    Kp) byte planes -> (B, OH, OW, N) int32, or (B, N) with the GAP
    epilogue on ``skip``.  Counted as ``mvau_int`` and ``mvau_int_planes``
    (and ``mvau_int_planes2`` or ``mvau_int_planes6`` for two or six
    products, and ``mvau_int_gap`` with a skip)."""
    b, h, wd, c, kernel, stride, pad = geom
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (wd + 2 * pad - kernel) // stride + 1
    k = kernel * kernel * c
    if x.dtype == torch.uint8:
        kind = "u8"
        _require(w.dtype == torch.int8 and tuple(w.shape) == (k, n),
                 f"uint8 codes take (K, N) = {(k, n)} int8 weights, got "
                 f"{w.dtype} {tuple(w.shape)}")
    else:
        _require(x.dtype in (torch.int16, torch.int32),
                 f"the plane route takes uint8, int16 or int32 codes, got "
                 f"{x.dtype}")
        kind = ("u" if x_unsigned else "s") + (
            "16" if x.dtype == torch.int16 else "24")
        kp = plane_depth(k)
        _require(w.dtype == torch.int8 and w.ndim == 3
                 and w.shape[0] in (1, 2) and tuple(w.shape[1:]) == (n, kp),
                 f"int16 and int32 codes take (P_w, N, Kp) = (1 or 2, {n}, "
                 f"{kp}) int8 byte planes, got {w.dtype} {tuple(w.shape)}")
        _require(k <= PLANE_MAX_K, f"K {k} is past the byte planes' limit "
                 f"{PLANE_MAX_K}: such codes take the CUDA-core route")
    _require(w.data_ptr() % 16 == 0, "the weights must be 16-byte aligned")
    shape = (b, oh, ow, n) if skip is None else (b, n)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    splits, ws, counts = _split_scratch(b * oh * ow, n, k, x.device, splits,
                                        bm=plane_tile_rows(kind))
    rc = B.library().mvau_int_planes_conv(
        x.data_ptr(), _X_KIND[kind], w.data_ptr(),
        0 if kind == "u8" else w.shape[0], thresholds.data_ptr(),
        None if skip is None else skip.data_ptr(), out.data_ptr(), b, h, wd,
        c, kernel, stride, pad, n, thresholds.shape[1], int(out_base),
        splits, ws, counts, _stream())
    B.check(rc, "mvau_int_planes")
    names = ["mvau_int", "mvau_int_planes"]
    products = 1 if kind == "u8" else x_planes(kind) * w.shape[0]
    if products in (2, 6):
        names.append(f"mvau_int_planes{products}")
    if skip is not None:
        names.append("mvau_int_gap")
    B.count_launch(*names)
    return out


def mvau_int(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
             out_base: int = 0, w_packed: bool = False,
             x_unsigned: bool = False) -> torch.Tensor:
    """Fused integer MVAU: (M, K) int8/uint8/int16/int32 codes x (K, N)
    int8/int16/int32 codes (or (K, N/2) packed int4 with ``w_packed``; or,
    for int16 and int32 codes, the (P_w, N, Kp) byte planes of
    :func:`weight_planes`) against (N, L) int32 thresholds -> (M, N) int32
    codes.  Each threshold row is sorted ascending, as the integer lowering
    leaves every ``mvau_int`` table: the kernels binary-search tables
    longer than 64 levels.  int8 x int8 (or packed int4) runs on the tensor
    cores: ``mvau_small_m_kernel`` where :func:`int8_gemm_route` says
    ``"small_m"`` (counted as ``mvau_int`` and ``mvau_int_small_m``), else
    the ``wgmma`` kernel; uint8 codes x int8 weights, and int16 or int32
    codes (up to 24 bits) x byte planes (``x_unsigned``: the codes' top
    byte unsigned, int16 codes up to 65535, int32 codes up to 2^24 - 1),
    take the plane route of the same kernel (counted as
    ``mvau_int_planes`` too); int32 codes x (K, N) weights run the
    CUDA-core kernel (counted as ``mvau_int_wide``)."""
    if not x.is_cuda:
        return mvau_int_plain(x, w, thresholds, out_base, w_packed,
                              x_unsigned)
    dev = x.device
    for name, t in (("x", x), ("thresholds", thresholds)):
        _check_2d(name, t, dev)
    _check_on(dev, w=w)
    m, k = x.shape
    _require(thresholds.dtype == torch.int32, "thresholds must be int32")
    if x.dtype in (torch.uint8, torch.int16) or w.ndim == 3:
        _require(not w_packed, "the plane route takes int8 weights")
        n = w.shape[1]      # of (K, N) codes or (P_w, N, Kp) byte planes
        _require(thresholds.shape[0] == n,
                 f"thresholds rows {thresholds.shape[0]} != N {n}")
        return _planes(x, w, thresholds, (1, m, 1, k, 1, 1, 0), n, out_base,
                       x_unsigned).reshape(m, n)
    _check_2d("w", w, dev)
    _require(x.dtype in (torch.int8, torch.int32),
             f"x must be int8, uint8, int16 or int32, got {x.dtype}")
    _require(w.shape[0] == k, f"w rows {w.shape[0]} != x cols {k}")
    n, w_kind = _w_kind(w, w_packed)
    _require(thresholds.shape[0] == n,
             f"thresholds rows {thresholds.shape[0]} != N {n}")
    if not _on_tensor_cores(x, w_kind):
        return _core(x.to(torch.int32), w, w_kind, thresholds,
                     (1, m, 1, k, 1, 1, 0), n, out_base,
                     name="mvau_int").reshape(m, n)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    levels = thresholds.shape[1]
    if int8_gemm_route(m, levels) == "small_m":
        rc = B.library().mvau_int_small_m(
            x.data_ptr(), w.data_ptr(), w_kind, thresholds.data_ptr(),
            out.data_ptr(), m, k, n, levels, int(out_base), _stream())
        B.check(rc, "mvau_int_small_m")
        B.count_launch("mvau_int", "mvau_int_small_m")
        return out
    splits, ws, counts = _split_scratch(m, n, k, dev, None)
    rc = B.library().mvau_int(x.data_ptr(), w.data_ptr(), w_kind,
                              thresholds.data_ptr(), out.data_ptr(), m, k, n,
                              levels, int(out_base), splits, ws,
                              counts, _stream())
    B.check(rc, "mvau_int")
    B.count_launch("mvau_int")
    return out


def _conv_dims(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
               kernel: int, stride: int, pad: int, w_packed: bool = False,
               floating: bool = False):
    """Checks the conv form's operands, for the kernels and their plain
    versions alike: integer codes (x int8/uint8/int16/int32; w
    int8/int16/int32, packed int4, or for int16 and int32 x the (P_w, N,
    Kp) byte planes; int32 thresholds) or, with ``floating``, float32 x, w
    and thresholds.  Returns (B, H, W, C, OH, OW, N)."""
    _require(x.ndim == 4, f"x must be 4-D NHWC, got shape {tuple(x.shape)}")
    planes = w.ndim == 3 and not floating
    _require((w.ndim == 2 or planes) and thresholds.ndim == 2,
             "w and thresholds must be 2-D (or w (P_w, N, Kp) byte planes)")
    if floating:
        _require(x.dtype == w.dtype == thresholds.dtype == torch.float32,
                 "the float MVAU takes float32 x, w and thresholds, got "
                 f"{x.dtype}, {w.dtype}, {thresholds.dtype}")
        n = w.shape[1]
    else:
        _require(x.dtype in (torch.int8, torch.uint8, torch.int16,
                             torch.int32),
                 f"x must be int8, uint8, int16 or int32 codes, got {x.dtype}")
        _require(thresholds.dtype == torch.int32, "thresholds must be int32")
        _require(not planes or (x.dtype in (torch.int16, torch.int32)
                                and not w_packed),
                 "byte-plane weights go with int16 or int32 codes")
        n = w.shape[1] if planes else _w_kind(w, w_packed)[0]
    _require(kernel >= 1 and stride >= 1 and pad >= 0,
             f"bad kernel/stride/pad {kernel}/{stride}/{pad}")
    b, h, wd, c = x.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (wd + 2 * pad - kernel) // stride + 1
    _require(oh >= 1 and ow >= 1,
             f"kernel {kernel} does not fit {h}x{wd} padded by {pad}")
    if planes:
        _require(w.shape[0] in (1, 2) and tuple(w.shape[1:])
                 == (n, plane_depth(kernel * kernel * c)),
                 f"byte planes {tuple(w.shape)} != (1 or 2, N, Kp) for K = "
                 f"kernel²·C {kernel * kernel * c}")
    else:
        _require(w.shape[0] == kernel * kernel * c,
                 f"w rows {w.shape[0]} != kernel²·C {kernel * kernel * c}")
    _require(thresholds.shape[0] == n,
             f"thresholds rows {thresholds.shape[0]} != N {n}")
    return b, h, wd, c, oh, ow, n


def _check_on(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        _require(t.device == dev, f"{name} is on {t.device}, expected {dev}")
        _require(t.is_contiguous(), f"{name} must be contiguous")


def mvau_int_conv_plain(x: torch.Tensor, w: torch.Tensor,
                        thresholds: torch.Tensor, kernel: int, stride: int,
                        pad: int, out_base: int = 0,
                        w_packed: bool = False,
                        x_unsigned: bool = False) -> torch.Tensor:
    """Plain version of the conv form: :func:`mvau_int_plain` on the patch
    rows of ``ref.im2col`` -> (B, OH, OW, N) int32."""
    b, _, _, _, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                       w_packed)
    patches = ref.im2col(x, kernel, stride, pad)
    y = mvau_int_plain(patches.reshape(b * oh * ow, -1), w, thresholds,
                       out_base, w_packed, x_unsigned)
    return y.reshape(b, oh, ow, n)


def mvau_int_conv(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
                  kernel: int, stride: int, pad: int, out_base: int = 0,
                  w_packed: bool = False, *, x_unsigned: bool = False,
                  splits: Optional[int] = None) -> torch.Tensor:
    """Conv-form integer MVAU: the ``im2col`` node folded into the kernel.

    (B, H, W, C) int8/uint8/int16/int32 NHWC codes x (K, N)
    int8/int16/int32 codes (or (K, N/2) packed int4 with ``w_packed``; or,
    for int16 and int32 codes, the (P_w, N, Kp) byte planes of
    :func:`weight_planes`), K = kernel² · C in patch order (kh, kw, c),
    against (N, L) int32 thresholds sorted ascending -> (B, OH, OW, N)
    int32 codes: :func:`mvau_int` on the patch rows, which never exist, on
    the route the operands name (``x_unsigned``: the codes' top byte
    unsigned).  The kernel reads the activation itself, zero outside the
    image.
    ``splits`` overrides the split-K planner (:func:`tc_splits`,
    :func:`core_splits`) for measurement."""
    if not x.is_cuda:
        return mvau_int_conv_plain(x, w, thresholds, kernel, stride, pad,
                                   out_base, w_packed, x_unsigned)
    dev = x.device
    kernel, stride, pad = int(kernel), int(stride), int(pad)
    b, h, wd, c, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                        w_packed)
    _check_on(dev, x=x, w=w, thresholds=thresholds)
    if x.dtype in (torch.uint8, torch.int16) or w.ndim == 3:
        _require(not w_packed, "the plane route takes int8 weights")
        return _planes(x, w, thresholds, (b, h, wd, c, kernel, stride, pad),
                       n, out_base, x_unsigned, splits=splits)
    _, w_kind = _w_kind(w, w_packed)
    if not _on_tensor_cores(x, w_kind):
        return _core(x.to(torch.int32), w, w_kind, thresholds,
                     (b, h, wd, c, kernel, stride, pad), n, out_base,
                     splits=splits, name="mvau_int")
    out = torch.empty((b, oh, ow, n), dtype=torch.int32, device=dev)
    splits, ws, counts = _split_scratch(b * oh * ow, n, kernel * kernel * c,
                                        dev, splits)
    rc = B.library().mvau_int_conv(
        x.data_ptr(), w.data_ptr(), w_kind, thresholds.data_ptr(),
        out.data_ptr(), b, h, wd, c, kernel, stride, pad, n,
        thresholds.shape[1], int(out_base), splits, ws, counts, _stream())
    B.check(rc, "mvau_int")
    B.count_launch("mvau_int")
    return out


def mvau_int_conv_gap_plain(x: torch.Tensor, w: torch.Tensor,
                            thresholds: torch.Tensor, skip: torch.Tensor,
                            kernel: int, stride: int, pad: int,
                            out_base: int = 0, w_packed: bool = False,
                            x_unsigned: bool = False) -> torch.Tensor:
    """Plain version of the fused tail: :func:`mvau_int_conv_plain`, plus
    ``skip``, then the spatial sum (``gap_plain``) -> (B, N) int32."""
    y = mvau_int_conv_plain(x, w, thresholds, kernel, stride, pad, out_base,
                            w_packed, x_unsigned)
    return kgap.gap_plain(y, skip)


def mvau_int_conv_gap(x: torch.Tensor, w: torch.Tensor,
                      thresholds: torch.Tensor, skip: torch.Tensor,
                      kernel: int, stride: int, pad: int, out_base: int = 0,
                      w_packed: bool = False, *, x_unsigned: bool = False,
                      splits: Optional[int] = None) -> torch.Tensor:
    """The tensor-core conv-form MVAU with the residual add and
    GlobalAccPool after it folded into its epilogue: ``Σ_{oh, ow}
    (mvau_int_conv(x, ...) + skip)`` -> (B, N) int32, wrapping like the
    reference's int32 sums.

    Operands as for :func:`mvau_int_conv`, on the tensor cores only (int8
    codes with int8 or packed int4 weights, or the plane route's uint8
    codes, or int16 or int32 codes with byte planes); ``skip`` is an
    integer tensor of the conv output's shape
    (B, OH, OW, N), added as int32.  OH·OW must divide 16: each image's rows
    then lie inside one warp's 16 accumulator rows, summed in registers and
    by shuffles, and the (B, OH, OW, N) codes are never written.  Counts
    one ``mvau_int`` launch (and one ``mvau_int_gap``, and on the plane
    route one ``mvau_int_planes``)."""
    if not x.is_cuda:
        return mvau_int_conv_gap_plain(x, w, thresholds, skip, kernel, stride,
                                       pad, out_base, w_packed, x_unsigned)
    dev = x.device
    kernel, stride, pad = int(kernel), int(stride), int(pad)
    b, h, wd, c, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                        w_packed)
    _check_on(dev, x=x, w=w, thresholds=thresholds, skip=skip)
    planes = x.dtype in (torch.uint8, torch.int16) or w.ndim == 3
    _require(planes or _on_tensor_cores(x, _w_kind(w, w_packed)[1]),
             "the fused GAP epilogue runs on the tensor cores: x must be "
             "int8 codes (w int8 or packed int4), uint8 codes, or codes "
             "with byte-plane weights")
    _require(16 % (oh * ow) == 0, f"the fused GAP epilogue needs OH·OW to "
             f"divide 16, got {oh}x{ow}")
    _require(tuple(skip.shape) == (b, oh, ow, n),
             f"skip {tuple(skip.shape)} != conv output {(b, oh, ow, n)}")
    _require(skip.dtype in (torch.int8, torch.uint8, torch.int16, torch.int32),
             f"skip must be integer codes of at most 32 bits, got {skip.dtype}")
    skip = skip.to(torch.int32)
    if planes:
        _require(not w_packed, "the plane route takes int8 weights")
        return _planes(x, w, thresholds, (b, h, wd, c, kernel, stride, pad),
                       n, out_base, x_unsigned, skip=skip, splits=splits)
    _, w_kind = _w_kind(w, w_packed)
    out = torch.empty((b, n), dtype=torch.int32, device=dev)
    splits, ws, counts = _split_scratch(b * oh * ow, n, kernel * kernel * c,
                                        dev, splits)
    rc = B.library().mvau_int_conv_gap(
        x.data_ptr(), w.data_ptr(), w_kind, thresholds.data_ptr(),
        skip.data_ptr(), out.data_ptr(), b, h, wd, c, kernel, stride, pad, n,
        thresholds.shape[1], int(out_base), splits, ws, counts, _stream())
    B.check(rc, "mvau_int_gap")
    B.count_launch("mvau_int", "mvau_int_gap")
    return out


# ---------------------------------------------------------------------------
# Float MVAU (replaces mvau_pallas)
# ---------------------------------------------------------------------------
def mvau_plain(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
               out_base: float = 0.0, out_scale: float = 1.0,
               out_bias: float = 0.0) -> torch.Tensor:
    """Plain version: float32 ``out_scale·(out_base + count) + out_bias``;
    int8 × int8 operands accumulate in int32, as ``mvau_pallas`` does."""
    if x.dtype == torch.int8 and w.dtype == torch.int8:
        counts = quant.threshold_counts(ref.matmul_int(x, w), thresholds)
        return out_scale * (out_base + counts.to(torch.float32)) + out_bias
    return ref.mvau(x, w, thresholds, out_base, out_scale, out_bias)


def mvau(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
         out_base: float = 0.0, out_scale: float = 1.0,
         out_bias: float = 0.0) -> torch.Tensor:
    """Fused float MVAU: (M, K) × (K, N) float32 against (N, L) float32
    thresholds (the CUDA-core kernel, float32 FMA), or int8 × int8 against
    int32 thresholds (the tensor cores) -> (M, N) float32."""
    if not x.is_cuda:
        return mvau_plain(x, w, thresholds, out_base, out_scale, out_bias)
    dev = x.device
    for name, t in (("x", x), ("w", w), ("thresholds", thresholds)):
        _check_2d(name, t, dev)
    m, k = x.shape
    _require(w.shape[0] == k, f"w rows {w.shape[0]} != x cols {k}")
    n = w.shape[1]
    _require(thresholds.shape[0] == n,
             f"thresholds rows {thresholds.shape[0]} != N {n}")
    if not (x.dtype == torch.int8 and w.dtype == torch.int8):
        _require(x.dtype == w.dtype == thresholds.dtype == torch.float32,
                 "mvau takes float32 x, w and thresholds (or int8 x, w with "
                 f"int32 thresholds), got {x.dtype}, {w.dtype}, "
                 f"{thresholds.dtype}")
        return _core(x, w, W_F32, thresholds, (1, m, 1, k, 1, 1, 0), n,
                     out_base, out_scale, out_bias).reshape(m, n)
    _require(thresholds.dtype == torch.int32,
             "int8 operands need int32 thresholds")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = B.library().mvau_i8(x.data_ptr(), w.data_ptr(), thresholds.data_ptr(),
                             out.data_ptr(), m, k, n, thresholds.shape[1],
                             float(out_base), float(out_scale),
                             float(out_bias), _stream())
    B.check(rc, "mvau")
    B.count_launch("mvau")
    return out


def mvau_conv_plain(x: torch.Tensor, w: torch.Tensor,
                    thresholds: torch.Tensor, kernel: int, stride: int,
                    pad: int, out_base: float = 0.0, out_scale: float = 1.0,
                    out_bias: float = 0.0) -> torch.Tensor:
    """Plain version of the float conv form: :func:`mvau_plain` on the
    patch rows of ``ref.im2col`` -> (B, OH, OW, N) float32."""
    b, _, _, _, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                       floating=True)
    patches = ref.im2col(x, kernel, stride, pad)
    y = mvau_plain(patches.reshape(b * oh * ow, -1), w, thresholds, out_base,
                   out_scale, out_bias)
    return y.reshape(b, oh, ow, n)


def mvau_conv(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
              kernel: int, stride: int, pad: int, out_base: float = 0.0,
              out_scale: float = 1.0, out_bias: float = 0.0, *,
              splits: Optional[int] = None) -> torch.Tensor:
    """Conv-form float MVAU: the ``im2col`` node folded into the CUDA-core
    kernel.  (B, H, W, C) float32 NHWC x (K, N) float32, K = kernel² · C in
    patch order (kh, kw, c), against (N, L) float32 thresholds (any order)
    -> (B, OH, OW, N) float32 ``out_scale·(out_base + count) + out_bias``:
    :func:`mvau` on the patch rows, which never exist.  ``splits``
    overrides the split-K planner (:func:`core_splits`)."""
    if not x.is_cuda:
        return mvau_conv_plain(x, w, thresholds, kernel, stride, pad,
                               out_base, out_scale, out_bias)
    kernel, stride, pad = int(kernel), int(stride), int(pad)
    b, h, wd, c, _, _, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                      floating=True)
    _check_on(x.device, x=x, w=w, thresholds=thresholds)
    return _core(x, w, W_F32, thresholds, (b, h, wd, c, kernel, stride, pad),
                 n, out_base, out_scale, out_bias, splits)
