"""Rank-normalizing wrappers and the graph-node dispatch onto the kernels.

Counterpart of the JAX package's ``kernels/ops.py``.  The wrappers flatten
leading batch dims into M and broadcast per-tensor thresholds to the
per-channel (N, L) form the kernels take.  Where the reference decides by
``jax.default_backend()``, the port decides by the device of the tensor:
a CUDA tensor goes to the hand-written kernels, a CPU tensor to the plain
versions in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import gap as kgap
from repro_torch.kernels import mvau as kmvau
from repro_torch.kernels import qmatmul as kqmm
from repro_torch.kernels import ref

__all__ = ["mvau", "mvau_conv", "mvau_int", "mvau_int_conv", "qmatmul", "gap",
           "conv_pairs", "conv_mvau_node", "conv_mvau_int_node",
           "graph_op_impls", "kernel_dispatch", "mvau_node", "mvau_int_node"]


def _as_2d(x: torch.Tensor):
    lead = tuple(x.shape[:-1])
    return x.reshape(-1, x.shape[-1]), lead


def _thresholds_2d(t: torch.Tensor, n: int) -> torch.Tensor:
    if t.ndim == 1:
        return t[None, :].expand(n, t.shape[0])
    return t


def mvau(x: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
         out_base: float = 0.0, out_scale: float = 1.0,
         out_bias: float = 0.0) -> torch.Tensor:
    """Fused ``multithreshold(x @ w)`` — float/QAT-grid datapath."""
    x2, lead = _as_2d(x)
    t2 = _thresholds_2d(torch.as_tensor(thresholds, dtype=torch.float32,
                                        device=x.device), w.shape[1])
    y = kmvau.mvau(x2.to(torch.float32).contiguous(),
                   w.to(torch.float32).contiguous(), t2.contiguous(),
                   out_base=float(out_base), out_scale=float(out_scale),
                   out_bias=float(out_bias))
    return y.reshape(*lead, w.shape[1])


def mvau_conv(x_nhwc: torch.Tensor, w: torch.Tensor, thresholds: torch.Tensor,
              kernel: int, stride: int, pad: int, out_base: float = 0.0,
              out_scale: float = 1.0, out_bias: float = 0.0) -> torch.Tensor:
    """Conv-form float MVAU: (B, H, W, C) NHWC in, (B, OH, OW, N) float32
    out, the patch rows read by the kernel itself."""
    t2 = _thresholds_2d(torch.as_tensor(thresholds, dtype=torch.float32,
                                        device=x_nhwc.device), w.shape[1])
    return kmvau.mvau_conv(x_nhwc.to(torch.float32).contiguous(),
                           w.to(torch.float32).contiguous(), t2.contiguous(),
                           kernel, stride, pad, out_base=float(out_base),
                           out_scale=float(out_scale),
                           out_bias=float(out_bias))


def mvau_int(x_codes: torch.Tensor, w_codes: torch.Tensor,
             thresholds_int: torch.Tensor, out_base: int = 0,
             w_packed: bool = False) -> torch.Tensor:
    """Integer MVAU: integer codes in, int32 codes out (FINN path).
    ``w_packed`` feeds the (K, N//2) packed-int4 buffer straight to the
    kernel, which unpacks it while loading its weight tile."""
    x2, lead = _as_2d(x_codes)
    n = w_codes.shape[1] * (2 if w_packed else 1)
    t2 = _thresholds_2d(torch.as_tensor(thresholds_int, dtype=torch.int32,
                                        device=x_codes.device), n)
    y = kmvau.mvau_int(x2.contiguous(), w_codes.contiguous(), t2.contiguous(),
                       out_base=int(out_base), w_packed=w_packed)
    return y.reshape(*lead, n)


def mvau_int_conv(x_nhwc: torch.Tensor, w_codes: torch.Tensor,
                  thresholds_int: torch.Tensor, kernel: int, stride: int,
                  pad: int, out_base: int = 0,
                  w_packed: bool = False) -> torch.Tensor:
    """Conv-form integer MVAU: (B, H, W, C) NHWC codes in, (B, OH, OW, N)
    int32 codes out, the patch rows read by the kernel itself."""
    n = w_codes.shape[1] * (2 if w_packed else 1)
    t2 = _thresholds_2d(torch.as_tensor(thresholds_int, dtype=torch.int32,
                                        device=x_nhwc.device), n)
    return kmvau.mvau_int_conv(x_nhwc.contiguous(), w_codes.contiguous(),
                               t2.contiguous(), kernel, stride, pad,
                               out_base=int(out_base), w_packed=w_packed)


def qmatmul(x: torch.Tensor, w_codes: torch.Tensor, scale: torch.Tensor,
            bits: int = 8) -> torch.Tensor:
    """Weight-only quantized matmul (w8a16 / w4a16 serving path)."""
    x2, lead = _as_2d(x)
    n = w_codes.shape[1] * (2 if bits == 4 else 1)
    y = kqmm.qmatmul(x2.contiguous(), w_codes.contiguous(),
                     scale.contiguous(), bits=bits)
    return y.reshape(*lead, n)


def gap(x: torch.Tensor) -> torch.Tensor:
    """GlobalAccPool spatial sum (N, H, W, C) -> (N, C)."""
    return kgap.gap(x.contiguous())


# ---------------------------------------------------------------------------
# Graph-node lowering (core.deploy dispatches HW ops onto these kernels)
# ---------------------------------------------------------------------------
def conv_pairs(nodes, outputs) -> dict:
    """``{im2col output: the MVAU node it feeds}`` for every ``im2col``
    whose output is read by exactly one node, an ``mvau`` or ``mvau_int``
    that takes it as its activation, and is not a graph output.  The
    lowering folds each such pair into one conv-form MVAU call, so the
    patch tensor never exists; other ``im2col`` nodes run as they are."""
    readers: dict = {}
    for n in nodes:
        for name in n.inputs:
            readers.setdefault(name, []).append(n)
    pairs = {}
    for n in nodes:
        if n.op != "im2col" or n.outputs[0] in outputs:
            continue
        users = readers.get(n.outputs[0], [])
        if (len(users) == 1 and users[0].op in ("mvau", "mvau_int")
                and users[0].inputs[0] == n.outputs[0]):
            pairs[n.outputs[0]] = users[0]
    return pairs


def kernel_dispatch(node, emulated: bool, folded=None) -> str:
    """Which datapath a graph node executes on — the single decision point.

    ``emulated`` is True off the card (CPU tensors).  The deploy-time
    executors below and ``DeployedModel.dispatch_table()`` both call this,
    so what the report claims is what runs.  Off the card the labels equal
    the JAX package's own off-TPU labels; on the card the kernel labels
    name the CUDA kernels where the reference names Pallas.  Every
    ``mvau_int`` node runs the fused kernel on the card, whatever its
    table length: the reference's L <= 512 gate is a TPU choice, and the
    CUDA kernels binary-search long tables.  ``folded`` is the MVAU node
    an ``im2col`` node is folded into (see :func:`conv_pairs`), or None;
    on the card a folded ``im2col`` carries its MVAU's label, since that
    kernel's conv-form loader reads the patches.

    * ``fused-cuda`` — the fused integer MVAU on the int8 tensor cores
      (``csrc/mvau.cu`` ``mvau_conv_kernel``);
    * ``fused-cuda-core`` — the fused integer MVAU on the CUDA cores
      (``mvau_core_kernel``), for codes that do not fit int8;
    * ``cuda``       — the float MVAU (``mvau_core_kernel``) and
      GlobalAccPool kernels;
    * ``f32-gemm``   — exact integer compute through the f32 GEMM
      (proof obligation ``acc_f32_exact`` discharged at lowering time);
    * ``ref-oracle`` — the plain exact version;
    * ``fast-count`` / ``int-shift`` — integer threshold count / requantize;
    * ``xla``        — plain tensor ops (data movement, add, ...), named as
      in the reference so the two tables compare.
    """
    op = node.op
    if op == "mvau_int":
        if not emulated:
            return ("fused-cuda" if node.attrs.get("int8_ok")
                    else "fused-cuda-core")
        if node.attrs.get("acc_f32_exact"):
            return "f32-gemm"
        return "ref-oracle"
    if op == "matmul_int":
        # the reference's int8-dot is a library product (XLA dot_general),
        # not one of its kernels; the port runs the unfused form through
        # the exact f32 GEMM or the plain version on every device
        if node.attrs.get("acc_f32_exact"):
            return "f32-gemm"
        return "ref-oracle"
    if op == "multithreshold_int":
        return "fast-count"
    if op == "requantize":
        return "int-shift"
    if op in ("mvau", "global_acc_pool"):
        return "ref-oracle" if emulated else "cuda"
    if op == "im2col" and folded is not None and not emulated:
        return kernel_dispatch(folded, emulated)
    return "xla"


def mvau_node(node, x, w, t):
    """Executor of an ``mvau`` node on (M, K) patch rows."""
    return mvau(x, w, t, out_base=node.attrs.get("out_base", 0),
                out_scale=node.attrs.get("out_scale", 1.0),
                out_bias=node.attrs.get("out_bias", 0.0))


def _kernel_codes(node, x, w):
    """The codes an ``mvau_int`` node hands its kernel on the card: an
    ``int8_ok`` node's narrowed to int8 for the tensor cores, others as
    stored for the CUDA cores."""
    if node.attrs.get("int8_ok"):
        x = x.to(torch.int8)
        if not node.attrs.get("w_packed"):
            w = w.to(torch.int8)
    return x, w


def mvau_int_node(node, x, w, t):
    """Executor of an ``mvau_int`` node on (M, K) patch rows or codes."""
    base = node.attrs.get("out_base", 0)
    disp = kernel_dispatch(node, not x.is_cuda)
    packed = bool(node.attrs.get("w_packed"))
    if disp.startswith("fused-cuda"):
        x, w = _kernel_codes(node, x, w)
        return mvau_int(x, w, t, out_base=base, w_packed=packed)
    if packed:
        w = Q.unpack_int4(w)
    return ref.mvau_int_fast(x, w, t, out_base=base,
                             acc_f32_exact=disp == "f32-gemm")


def conv_mvau_int_node(conv, node, x, w, t):
    """Executor of a folded ``im2col`` -> ``mvau_int`` pair (see
    :func:`conv_pairs`) on the im2col node's input ``x``.  On the card an
    ``int8_ok`` node's activation is narrowed to int8 (one cast, a ninth of
    the patches') for the tensor-core kernel; other codes go to the
    CUDA-core kernel as stored.  Either kernel reads the patch rows
    itself.  Off the card the node takes its own route, as labelled, on
    patches local to this call."""
    k, s, p = conv.attrs["kernel"], conv.attrs["stride"], conv.attrs["pad"]
    if not x.is_cuda:
        return mvau_int_node(node, ref.im2col(x, k, s, p), w, t)
    x, w = _kernel_codes(node, x, w)
    return mvau_int_conv(x, w, t, k, s, p,
                         out_base=node.attrs.get("out_base", 0),
                         w_packed=bool(node.attrs.get("w_packed")))


def conv_mvau_node(conv, node, x, w, t):
    """Executor of a folded ``im2col`` -> ``mvau`` pair on the im2col
    node's input ``x``: on the card the CUDA-core kernel reads the patch
    rows itself; off the card the plain version runs on patches local to
    this call."""
    k, s, p = conv.attrs["kernel"], conv.attrs["stride"], conv.attrs["pad"]
    if not x.is_cuda:
        return mvau_node(node, ref.im2col(x, k, s, p), w, t)
    return mvau_conv(x, w, t, k, s, p, out_base=node.attrs.get("out_base", 0),
                     out_scale=node.attrs.get("out_scale", 1.0),
                     out_bias=node.attrs.get("out_bias", 0.0))


def graph_op_impls():
    """Executors for the HW graph ops, keyed by op name.

    ``core.deploy`` overlays these on the interpreter's executor table.
    The MVAU and GAP nodes call the wrappers, which launch the CUDA
    kernels for tensors on the card and take the plain versions for CPU
    tensors, exactly the reference's off-TPU routes.  The unfused integer
    nodes decide by the device of their input through
    :func:`kernel_dispatch`.  Every route is bit-identical on the
    fixed-point grid.
    """

    def _matmul_int_node(node, x, w):
        disp = kernel_dispatch(node, not x.is_cuda)
        if node.attrs.get("w_packed"):
            w = Q.unpack_int4(w)
        return ref.matmul_int_fast(x, w, acc_f32_exact=disp == "f32-gemm")

    def _multithreshold_int_node(node, x, t):
        base = node.attrs.get("out_base", 0)
        counts = ref.threshold_counts_fast(x.to(torch.int32), t)
        return (base + counts).to(torch.int32)

    def _requantize_node(node, q):
        return ref.requantize(q, node.attrs["shift"], node.attrs["bits"],
                              node.attrs["frac_bits"],
                              node.attrs.get("signed", True))

    def _gap_node(node, x):
        axes = tuple(node.attrs["axes"])
        if x.ndim == 4 and axes == (1, 2):
            return gap(x)
        if not x.dtype.is_floating_point:
            return torch.sum(x.to(torch.int32), dim=axes).to(torch.int32)
        return torch.sum(x, dim=axes)

    return {"mvau": mvau_node, "mvau_int": mvau_int_node,
            "matmul_int": _matmul_int_node,
            "multithreshold_int": _multithreshold_int_node,
            "requantize": _requantize_node,
            "global_acc_pool": _gap_node}
