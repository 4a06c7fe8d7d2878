"""MVAU on the card: wrappers around the hand-written CUDA kernels
(``csrc/mvau.cu``), each beside its plain PyTorch version.

Counterpart of the JAX package's ``kernels/mvau.py`` (``mvau_int_pallas``,
``mvau_pallas``).  Two kernels serve every MVAU on the card:

* int8 activation codes x int8 (or packed int4) weight codes run the
  tensor-core kernel (``mvau_conv_kernel``, int8 ``wgmma``);
* everything else -- the float MVAU, and integer codes that do not fit
  int8 (8-bit unsigned activations, 9- to 16-bit weights) -- runs the
  CUDA-core kernel (``mvau_core_kernel``: float32 FMA, or exact int32
  multiply-add).

Both read conv patch rows straight from the NHWC activation
(:func:`mvau_int_conv`, :func:`mvau_conv`: the ``im2col`` before them
folded into their loads); the GEMM form (M, K) is their 1 x 1 case.  The
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
           "mvau_plain", "mvau_conv_plain", "tc_splits", "core_splits"]

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


def tc_splits(m: int, n: int, k: int, sms: int) -> int:
    """K-splits of one tensor-core launch: 1 where the output tiles cover
    the SMs, else up to two blocks per SM, each split keeping at least 16
    K-tiles (shorter splits lose more to the partial-sum round trip than
    the extra blocks gain: ``tools/probe_mvau_conv.py``'s sweep on the
    H100).  The split changes no bit (integer sums)."""
    bm, bn, bk = TC_TILE
    return _plan(-(-m // bm) * -(-n // bn), -(-k // bk), sms)


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
                   splits: Optional[int], core: bool = False
                   ) -> Tuple[int, Optional[int], Optional[int]]:
    """(splits, scratch pointer, counters pointer) for one launch of the
    tensor-core kernel, or of the CUDA-core one (``core``); the scratch
    holds each output tile's and split's partial sums, 32 bits each."""
    if core:
        bm, bn, bk, planner = CORE_TILE_M, core_tile_n(n), CORE_TILE_K, \
            core_splits
    else:
        (bm, bn, bk), planner = TC_TILE, tc_splits
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
                   out_base: int = 0, w_packed: bool = False) -> torch.Tensor:
    """Plain version: ``out_base + Σ_l 1[x @ w ≥ T[n, l]]`` as int32."""
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


def mvau_int(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
             out_base: int = 0, w_packed: bool = False) -> torch.Tensor:
    """Fused integer MVAU: (M, K) int8/int32 codes x (K, N) int8/int16/int32
    codes (or (K, N/2) packed int4 with ``w_packed``) against (N, L) int32
    thresholds -> (M, N) int32 codes.  Each threshold row is sorted
    ascending, as the integer lowering leaves every ``mvau_int`` table: the
    kernels binary-search tables longer than 64 levels.  int8 x int8 (or
    packed int4) runs on the tensor cores; other codes run the CUDA-core
    kernel on int32 activation codes (int8 codes are widened first)."""
    if not x.is_cuda:
        return mvau_int_plain(x, w, thresholds, out_base, w_packed)
    dev = x.device
    for name, t in (("x", x), ("w", w), ("thresholds", thresholds)):
        _check_2d(name, t, dev)
    _require(x.dtype in (torch.int8, torch.int32),
             f"x must be int8 or int32, got {x.dtype}")
    m, k = x.shape
    _require(w.shape[0] == k, f"w rows {w.shape[0]} != x cols {k}")
    n, w_kind = _w_kind(w, w_packed)
    _require(thresholds.dtype == torch.int32, "thresholds must be int32")
    _require(thresholds.shape[0] == n,
             f"thresholds rows {thresholds.shape[0]} != N {n}")
    if not _on_tensor_cores(x, w_kind):
        return _core(x.to(torch.int32), w, w_kind, thresholds,
                     (1, m, 1, k, 1, 1, 0), n, out_base,
                     name="mvau_int").reshape(m, n)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    splits, ws, counts = _split_scratch(m, n, k, dev, None)
    rc = B.library().mvau_int(x.data_ptr(), w.data_ptr(), w_kind,
                              thresholds.data_ptr(), out.data_ptr(), m, k, n,
                              thresholds.shape[1], int(out_base), splits, ws,
                              counts, _stream())
    B.check(rc, "mvau_int")
    B.count_launch("mvau_int")
    return out


def _conv_dims(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
               kernel: int, stride: int, pad: int, w_packed: bool = False,
               floating: bool = False):
    """Checks the conv form's operands, for the kernels and their plain
    versions alike: integer codes (x int8/int32; w int8/int16/int32 or
    packed int4; int32 thresholds) or, with ``floating``, float32 x, w and
    thresholds.  Returns (B, H, W, C, OH, OW, N)."""
    _require(x.ndim == 4, f"x must be 4-D NHWC, got shape {tuple(x.shape)}")
    _require(w.ndim == 2 and thresholds.ndim == 2,
             "w and thresholds must be 2-D")
    if floating:
        _require(x.dtype == w.dtype == thresholds.dtype == torch.float32,
                 "the float MVAU takes float32 x, w and thresholds, got "
                 f"{x.dtype}, {w.dtype}, {thresholds.dtype}")
        n = w.shape[1]
    else:
        _require(x.dtype in (torch.int8, torch.int32),
                 f"x must be int8 or int32 codes, got {x.dtype}")
        _require(thresholds.dtype == torch.int32, "thresholds must be int32")
        n, _ = _w_kind(w, w_packed)
    _require(kernel >= 1 and stride >= 1 and pad >= 0,
             f"bad kernel/stride/pad {kernel}/{stride}/{pad}")
    b, h, wd, c = x.shape
    oh = (h + 2 * pad - kernel) // stride + 1
    ow = (wd + 2 * pad - kernel) // stride + 1
    _require(oh >= 1 and ow >= 1,
             f"kernel {kernel} does not fit {h}x{wd} padded by {pad}")
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
                        w_packed: bool = False) -> torch.Tensor:
    """Plain version of the conv form: :func:`mvau_int_plain` on the patch
    rows of ``ref.im2col`` -> (B, OH, OW, N) int32."""
    b, _, _, _, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                       w_packed)
    patches = ref.im2col(x, kernel, stride, pad)
    y = mvau_int_plain(patches.reshape(b * oh * ow, -1), w, thresholds,
                       out_base, w_packed)
    return y.reshape(b, oh, ow, n)


def mvau_int_conv(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
                  kernel: int, stride: int, pad: int, out_base: int = 0,
                  w_packed: bool = False, *,
                  splits: Optional[int] = None) -> torch.Tensor:
    """Conv-form integer MVAU: the ``im2col`` node folded into the kernel.

    (B, H, W, C) int8/int32 NHWC codes x (K, N) int8/int16/int32 codes (or
    (K, N/2) packed int4 with ``w_packed``), K = kernel² · C in patch order
    (kh, kw, c), against (N, L) int32 thresholds sorted ascending -> (B,
    OH, OW, N) int32 codes: :func:`mvau_int` on the patch rows, which never
    exist.  The kernel reads the activation itself, zero outside the image.
    ``splits`` overrides the split-K planner (:func:`tc_splits`,
    :func:`core_splits`) for measurement."""
    if not x.is_cuda:
        return mvau_int_conv_plain(x, w, thresholds, kernel, stride, pad,
                                   out_base, w_packed)
    dev = x.device
    kernel, stride, pad = int(kernel), int(stride), int(pad)
    b, h, wd, c, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                        w_packed)
    _check_on(dev, x=x, w=w, thresholds=thresholds)
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
                            out_base: int = 0,
                            w_packed: bool = False) -> torch.Tensor:
    """Plain version of the fused tail: :func:`mvau_int_conv_plain`, plus
    ``skip``, then the spatial sum (``gap_plain``) -> (B, N) int32."""
    y = mvau_int_conv_plain(x, w, thresholds, kernel, stride, pad, out_base,
                            w_packed)
    return kgap.gap_plain(y, skip)


def mvau_int_conv_gap(x: torch.Tensor, w: torch.Tensor,
                      thresholds: torch.Tensor, skip: torch.Tensor,
                      kernel: int, stride: int, pad: int, out_base: int = 0,
                      w_packed: bool = False, *,
                      splits: Optional[int] = None) -> torch.Tensor:
    """The int8 conv-form MVAU with the residual add and GlobalAccPool after
    it folded into its epilogue: ``Σ_{oh, ow} (mvau_int_conv(x, ...) +
    skip)`` -> (B, N) int32, wrapping like the reference's int32 sums.

    Operands as for :func:`mvau_int_conv`, on the tensor cores only (int8
    codes, int8 or packed int4 weights); ``skip`` is an integer tensor of
    the conv output's shape (B, OH, OW, N), added as int32.  OH·OW must
    divide 16: each image's rows then lie inside one warp's 16 accumulator
    rows, summed in registers and by shuffles, and the (B, OH, OW, N) codes
    are never written.  Counts one ``mvau_int`` launch (and one
    ``mvau_int_gap``)."""
    if not x.is_cuda:
        return mvau_int_conv_gap_plain(x, w, thresholds, skip, kernel, stride,
                                       pad, out_base, w_packed)
    dev = x.device
    kernel, stride, pad = int(kernel), int(stride), int(pad)
    b, h, wd, c, oh, ow, n = _conv_dims(x, w, thresholds, kernel, stride, pad,
                                        w_packed)
    _check_on(dev, x=x, w=w, thresholds=thresholds, skip=skip)
    _, w_kind = _w_kind(w, w_packed)
    _require(_on_tensor_cores(x, w_kind), "the fused GAP epilogue runs on the "
             "int8 tensor cores: x must be int8 codes, w int8 or packed int4")
    _require(16 % (oh * ow) == 0, f"the fused GAP epilogue needs OH·OW to "
             f"divide 16, got {oh}x{ow}")
    _require(tuple(skip.shape) == (b, oh, ow, n),
             f"skip {tuple(skip.shape)} != conv output {(b, oh, ow, n)}")
    _require(skip.dtype in (torch.int8, torch.uint8, torch.int16, torch.int32),
             f"skip must be integer codes of at most 32 bits, got {skip.dtype}")
    skip = skip.to(torch.int32)
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
