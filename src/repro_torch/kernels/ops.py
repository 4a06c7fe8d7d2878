"""Rank-normalizing wrappers and the graph-node dispatch onto the kernels.

Counterpart of the JAX package's ``kernels/ops.py``.  The wrappers flatten
leading batch dims into M and broadcast per-tensor thresholds to the
per-channel (N, L) form the kernels take.  Where the reference decides by
``jax.default_backend()``, the port decides by the device of the tensor:
a CUDA tensor goes to the hand-written kernels, a CPU tensor to the plain
versions in :mod:`repro_torch.kernels.ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quant as Q
from repro_torch.kernels import gap as kgap
from repro_torch.kernels import mvau as kmvau
from repro_torch.kernels import qmatmul as kqmm
from repro_torch.kernels import ref

__all__ = ["mvau", "mvau_conv", "mvau_int", "mvau_int_conv",
           "mvau_int_conv_gap", "qmatmul", "gap", "conv_pairs", "gap_tails",
           "residual_gaps", "folded_into", "conv_mvau_node",
           "conv_mvau_int_node", "conv_mvau_int_gap_node", "tail_fits",
           "graph_op_impls", "kernel_dispatch", "mvau_node", "mvau_int_node",
           "prepare_tables", "int_route_of"]


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
             w_packed: bool = False, x_unsigned: bool = False) -> torch.Tensor:
    """Integer MVAU: integer codes in, int32 codes out (FINN path).
    ``w_packed`` feeds the (K, N//2) packed-int4 buffer straight to the
    kernel, which unpacks it while loading its weight tile; int16 codes
    take the weights' byte planes, and so do int32 codes where they are
    given (``x_unsigned``: the codes' top byte unsigned)."""
    x2, lead = _as_2d(x_codes)
    n = w_codes.shape[1] * (2 if w_packed else 1)
    t2 = _thresholds_2d(torch.as_tensor(thresholds_int, dtype=torch.int32,
                                        device=x_codes.device), n)
    y = kmvau.mvau_int(x2.contiguous(), w_codes.contiguous(), t2.contiguous(),
                       out_base=int(out_base), w_packed=w_packed,
                       x_unsigned=x_unsigned)
    return y.reshape(*lead, n)


def mvau_int_conv(x_nhwc: torch.Tensor, w_codes: torch.Tensor,
                  thresholds_int: torch.Tensor, kernel: int, stride: int,
                  pad: int, out_base: int = 0, w_packed: bool = False,
                  x_unsigned: bool = False) -> torch.Tensor:
    """Conv-form integer MVAU: (B, H, W, C) NHWC codes in, (B, OH, OW, N)
    int32 codes out, the patch rows read by the kernel itself."""
    n = w_codes.shape[1] * (2 if w_packed else 1)
    t2 = _thresholds_2d(torch.as_tensor(thresholds_int, dtype=torch.int32,
                                        device=x_nhwc.device), n)
    return kmvau.mvau_int_conv(x_nhwc.contiguous(), w_codes.contiguous(),
                               t2.contiguous(), kernel, stride, pad,
                               out_base=int(out_base), w_packed=w_packed,
                               x_unsigned=x_unsigned)


def mvau_int_conv_gap(x_nhwc: torch.Tensor, w_codes: torch.Tensor,
                      thresholds_int: torch.Tensor, skip: torch.Tensor,
                      kernel: int, stride: int, pad: int, out_base: int = 0,
                      w_packed: bool = False,
                      x_unsigned: bool = False) -> torch.Tensor:
    """Conv-form tensor-core MVAU, plus ``skip``, summed over each image:
    (B, N) int32, the (B, OH, OW, N) codes never written."""
    n = w_codes.shape[1] * (2 if w_packed else 1)
    t2 = _thresholds_2d(torch.as_tensor(thresholds_int, dtype=torch.int32,
                                        device=x_nhwc.device), n)
    return kmvau.mvau_int_conv_gap(x_nhwc.contiguous(), w_codes.contiguous(),
                                   t2.contiguous(), skip.contiguous(), kernel,
                                   stride, pad, out_base=int(out_base),
                                   w_packed=w_packed, x_unsigned=x_unsigned)


def qmatmul(x: torch.Tensor, w_codes: torch.Tensor, scale: torch.Tensor,
            bits: int = 8) -> torch.Tensor:
    """Weight-only quantized matmul (w8a16 / w4a16 serving path)."""
    x2, lead = _as_2d(x)
    n = w_codes.shape[1] * (2 if bits == 4 else 1)
    y = kqmm.qmatmul(x2.contiguous(), w_codes.contiguous(),
                     scale.contiguous(), bits=bits)
    return y.reshape(*lead, n)


def gap(x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GlobalAccPool spatial sum (N, H, W, C) -> (N, C), of ``x + skip``
    where a residual add is folded in."""
    return kgap.gap(x.contiguous(),
                    None if skip is None else skip.contiguous())


# ---------------------------------------------------------------------------
# Graph-node lowering (core.deploy dispatches HW ops onto these kernels)
# ---------------------------------------------------------------------------
def _readers(nodes) -> dict:
    readers: dict = {}
    for n in nodes:
        for name in n.inputs:
            readers.setdefault(name, []).append(n)
    return readers


def conv_pairs(nodes, outputs) -> dict:
    """``{im2col output: the MVAU node it feeds}`` for every ``im2col``
    whose output is read by exactly one node, an ``mvau`` or ``mvau_int``
    that takes it as its activation, and is not a graph output.  The
    lowering folds each such pair into one conv-form MVAU call, so the
    patch tensor never exists; other ``im2col`` nodes run as they are."""
    readers = _readers(nodes)
    pairs = {}
    for n in nodes:
        if n.op != "im2col" or n.outputs[0] in outputs:
            continue
        users = readers.get(n.outputs[0], [])
        if (len(users) == 1 and users[0].op in ("mvau", "mvau_int")
                and users[0].inputs[0] == n.outputs[0]):
            pairs[n.outputs[0]] = users[0]
    return pairs


def _sole_reader(readers, outputs, tensor, op):
    """The one node reading ``tensor`` if it is an ``op`` node and
    ``tensor`` is not a graph output, else None."""
    users = readers.get(tensor, [])
    if tensor in outputs or len(users) != 1 or users[0].op != op:
        return None
    return users[0]


def _pool_reader(readers, outputs, tensor):
    pool = _sole_reader(readers, outputs, tensor, "global_acc_pool")
    if pool is None or tuple(pool.attrs.get("axes", ())) != (1, 2):
        return None
    return pool


def int_route_of(node, graph=None):
    """``(route, x kind, wgmma products)`` of an ``mvau_int`` node on the
    card (:func:`repro_torch.kernels.mvau.int_route`): ``int8``,
    ``planes`` or ``core``.  The lowering's copy of a node carries it
    (:func:`prepare_tables`); for a graph's own node it is read from the
    x and w specs in ``graph.dtypes`` and K from the weights.  A node with
    no specs to read keeps the ``int8_ok`` rule: ``int8`` or ``core``."""
    if "int_route" in node.attrs:
        return (node.attrs["int_route"], node.attrs["x_kind"],
                node.attrs["plane_products"])
    if node.attrs.get("int8_ok"):
        return "int8", "s8", 1
    if graph is not None:
        route = _route_from_specs(node, graph.dtypes, graph.initializers)
        if route is not None:
            return route
    return "core", None, 1


def _route_from_specs(node, dtypes, initializers):
    import numpy as np

    xs = dtypes.get(node.inputs[0])
    ws = dtypes.get(node.inputs[1])
    w = initializers.get(node.inputs[1])
    if xs is None or ws is None or w is None \
            or not hasattr(xs, "qmin") or not hasattr(ws, "qmin"):
        return None
    return kmvau.int_route((xs.qmin, xs.qmax), (ws.qmin, ws.qmax),
                           int(np.shape(w)[0]))


def _on_tensor_cores(node, graph=None) -> bool:
    return int_route_of(node, graph)[0] in ("int8", "planes")


def gap_tails(nodes, outputs, graph=None) -> dict:
    """``{global_acc_pool output: (mvau_int node, add node)}`` for every
    tail ``im2col -> mvau_int -> add -> global_acc_pool`` that the lowering
    runs as one launch of the tensor-core conv kernel with its
    GlobalAccPool epilogue (:func:`conv_mvau_int_gap_node`).  It matches
    where

    * the ``mvau_int`` runs on the tensor cores (the ``int8`` or ``planes``
      route of :func:`int_route_of`, read from ``graph`` for a graph's own
      nodes) and its ``im2col`` is folded into it (:func:`conv_pairs`);
    * its output's only reader is an ``add`` of two tensors, the other of
      which is the skip operand;
    * the ``add`` output's only reader is a ``global_acc_pool`` over axes
      (1, 2) whose ``spatial_size`` (OH·OW) divides 16;
    * neither intermediate is a graph output.

    The graph gives no tensor shapes, so the skip's shape and dtype are
    checked where they exist, on each call of the step
    (:func:`tail_fits`): a skip that broadcasts or is float runs the MVAU,
    the add and the GAP kernel in turn.  The integer lowering and the
    exporters only build adds of codes of one shape, where the dispatch
    table's labels hold.  Every other tail keeps its own steps (see
    :func:`residual_gaps`)."""
    readers = _readers(nodes)
    pairs = conv_pairs(nodes, outputs)
    tails = {}
    for n in nodes:
        if (n.op != "mvau_int" or n.inputs[0] not in pairs
                or not _on_tensor_cores(n, graph)):
            continue
        y = n.outputs[0]
        add = _sole_reader(readers, outputs, y, "add")
        if add is None or len(add.inputs) != 2 or add.inputs.count(y) != 1:
            continue
        pool = _pool_reader(readers, outputs, add.outputs[0])
        size = int(pool.attrs.get("spatial_size", 0)) if pool else 0
        if size >= 1 and 16 % size == 0:
            tails[pool.outputs[0]] = (n, add)
    return tails


def residual_gaps(nodes, outputs, tails=None, graph=None) -> dict:
    """``{global_acc_pool output: add node}`` for every ``add`` of two
    tensors whose output's only reader is a ``global_acc_pool`` over axes
    (1, 2) and is not a graph output, outside the fused ``tails``
    (:func:`gap_tails`): the lowering hands both operands to the GAP
    kernel, which adds them as it sums."""
    readers = _readers(nodes)
    tails = gap_tails(nodes, outputs, graph) if tails is None else tails
    out = {}
    for n in nodes:
        if n.op != "add" or len(n.inputs) != 2:
            continue
        pool = _pool_reader(readers, outputs, n.outputs[0])
        if pool is not None and pool.outputs[0] not in tails:
            out[pool.outputs[0]] = n
    return out


def folded_into(nodes, outputs, graph=None) -> dict:
    """``{tensor: the node whose step computes it}`` for every node the
    lowering folds into another's step: an ``im2col`` into its MVAU; a fused
    tail's ``add`` and ``global_acc_pool`` into its ``mvau_int``; a residual
    ``add`` into its ``global_acc_pool``.  ``graph`` as for
    :func:`gap_tails`."""
    into = dict(conv_pairs(nodes, outputs))
    tails = gap_tails(nodes, outputs, graph)
    for pooled, (mv, add) in tails.items():
        into[add.outputs[0]] = into[pooled] = mv
    by_output = {n.outputs[0]: n for n in nodes}
    for pooled, add in residual_gaps(nodes, outputs, tails).items():
        into[add.outputs[0]] = by_output[pooled]
    return into


_INT_LABELS = {"int8": "fused-cuda", "planes": "fused-cuda-planes",
               "core": "fused-cuda-core"}


def kernel_dispatch(node, emulated: bool, folded=None, graph=None) -> str:
    """Which datapath a graph node executes on — the single decision point.

    ``emulated`` is True off the card (CPU tensors).  The deploy-time
    executors below and ``DeployedModel.dispatch_table()`` both call this,
    so what the report claims is what runs.  Off the card the labels equal
    the JAX package's own off-TPU labels; on the card the kernel labels
    name the CUDA kernels where the reference names Pallas.  Every
    ``mvau_int`` node runs the fused kernel on the card, whatever its
    table length: the reference's L <= 512 gate is a TPU choice, and the
    CUDA kernels binary-search long tables.  ``folded`` is the node this
    one is folded into (see :func:`folded_into`), or None; on the card a
    folded node carries that node's label, since its kernel does the
    work: a folded ``im2col`` its MVAU's (the
    conv-form loader reads the patches), a fused tail's ``add`` and
    ``global_acc_pool`` their ``mvau_int``'s (the GAP epilogue), a residual
    ``add`` its GAP's.  An ``mvau_int`` node's route comes from
    :func:`int_route_of` (``graph`` supplies the specs of a graph's own
    nodes).

    * ``fused-cuda`` — the fused integer MVAU on the int8 tensor cores
      (``csrc/mvau.cu`` ``mvau_conv_kernel``), int8 codes;
    * ``fused-cuda-planes`` — the same kernel on activation codes of up to
      24 bits: uint8 codes (one ``wgmma`` u8.s8) or byte planes (2 to 6
      products);
    * ``fused-cuda-core`` — the fused integer MVAU on the CUDA cores
      (``mvau_core_kernel``), for codes wider than that;
    * ``cuda``       — the float MVAU (``mvau_core_kernel``) and
      GlobalAccPool (``gap_kernel``, with a residual add folded in or not)
      kernels;
    * ``f32-gemm``   — exact integer compute through the f32 GEMM
      (proof obligation ``acc_f32_exact`` discharged at lowering time);
    * ``ref-oracle`` — the plain exact version;
    * ``fast-count`` / ``int-shift`` — integer threshold count / requantize;
    * ``xla``        — plain tensor ops (data movement, add, ...), named as
      in the reference so the two tables compare.
    """
    op = node.op
    if folded is not None and not emulated:
        return kernel_dispatch(folded, emulated, graph=graph)
    if op == "mvau_int":
        if not emulated:
            return _INT_LABELS[int_route_of(node, graph)[0]]
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
    return "xla"


def prepare_tables(nodes, initializers, consts, dtypes=None) -> None:
    """Prepare the threshold tables and routes of ``nodes`` (copies the
    lowering owns) once, when a graph is lowered, instead of on every call:

    * each ``mvau_int`` node records its card route (:func:`int_route_of`
      from the x and w specs in ``dtypes``: ``int_route``, ``x_kind``,
      ``plane_products``); on the plane route its weights are prepared once
      as a constant of their own named in ``w_kernel``: the byte planes
      (:func:`repro_torch.kernels.mvau.weight_planes`) against activation
      codes of 9 to 24 bits, two of 16-bit weights (``<w>@planes``) or one
      of int8 weights (``<w>@planes1``), unpacked int8 codes
      (``<w>@int8``) for packed int4 weights against uint8 codes.  The
      node's own operands stay as they are (the CPU runs them);
    * an ``mvau_int`` node's per-tensor (L,) table becomes a contiguous
      (N, L) int32 constant of its own (``<table>@<N>``), the form the
      kernels read, so no replay broadcasts and copies it;
    * a ``multithreshold`` or ``multithreshold_int`` node with a table of
      64 levels or more records in ``sorted_levels`` whether the table is
      sorted, which decides binary search against the dense compare.
      Checked at run time it would wait for the device, which a CUDA graph
      capture forbids.

    ``initializers`` are the graph's numpy arrays, ``consts`` the same
    tensors on the lowering's device; the node's operands and results do
    not change."""
    import numpy as np

    for node in nodes:
        if node.op == "mvau_int":
            _prepare_route(node, initializers, consts, dtypes or {})
        t_name = node.inputs[-1]
        if t_name not in initializers:
            continue
        t = np.asarray(initializers[t_name])
        if node.op == "mvau_int" and t.ndim == 1 \
                and node.inputs[1] in initializers:
            n = np.asarray(initializers[node.inputs[1]]).shape[1] \
                * (2 if node.attrs.get("w_packed") else 1)
            name = f"{t_name}@{n}"
            if name not in consts:
                consts[name] = _thresholds_2d(
                    consts[t_name].to(torch.int32), n).contiguous()
            node.inputs[-1] = name
        elif node.op in ("multithreshold", "multithreshold_int") \
                and t.shape[-1] >= 64:
            node.attrs["sorted_levels"] = bool(np.all(np.diff(t, axis=-1)
                                                      >= 0))


def _prepare_route(node, initializers, consts, dtypes) -> None:
    route = None
    if not node.attrs.get("int8_ok"):
        route = _route_from_specs(node, dtypes, initializers)
    if route is None:
        route = int_route_of(node)
    node.attrs["int_route"], node.attrs["x_kind"], \
        node.attrs["plane_products"] = route
    w_name = node.inputs[1]
    packed = bool(node.attrs.get("w_packed"))
    if route[0] != "planes" or w_name not in consts:
        return
    if route[1] == "u8":
        if not packed:
            return
        name = f"{w_name}@int8"
        if name not in consts:
            consts[name] = Q.unpack_int4(consts[w_name]).to(torch.int8
                                                            ).contiguous()
    else:
        pw = route[2] // kmvau.x_planes(route[1])
        name = f"{w_name}@planes" + ("1" if pw == 1 else "")
        if name not in consts:
            consts[name] = kmvau.weight_planes(consts[w_name], packed, pw)
    node.attrs["w_kernel"] = name


def mvau_node(node, x, w, t):
    """Executor of an ``mvau`` node on (M, K) patch rows."""
    return mvau(x, w, t, out_base=node.attrs.get("out_base", 0),
                out_scale=node.attrs.get("out_scale", 1.0),
                out_bias=node.attrs.get("out_bias", 0.0))


def _kernel_codes(node, x, w, wk=None):
    """The operands an ``mvau_int`` node hands its kernel on the card:
    ``(x, w, w_packed, x_unsigned)``.  On the ``int8`` route the codes are
    narrowed to int8; on the ``planes`` route the activation codes to
    uint8 (0..255), to int16 (their low 16 bits: a wrapping cast, the high
    byte read as unsigned for codes up to 65535) or to int32 (codes of 17
    to 24 bits, as the graph holds them; the third byte unsigned for codes
    past 2^23 - 1), against the weights the lowering prepared (``wk``: the
    byte planes, or unpacked int8 codes; int8 codes as stored otherwise);
    on the ``core`` route as stored."""
    route, kind, _ = int_route_of(node)
    packed = bool(node.attrs.get("w_packed"))
    if route == "int8":
        x = x.to(torch.int8)
        if not packed:
            w = w.to(torch.int8)
    elif route == "planes":
        if kind != "u8" or packed:
            if wk is None:
                raise ValueError(
                    f"mvau_int '{node.outputs[0]}' on the plane route needs "
                    "the weights its lowering prepares (prepare_tables)")
            w, packed = wk, False
        x = x.to(kmvau.x_dtype(kind))
    return x, w, packed, kind in ("u16", "u24")


def mvau_int_node(node, x, w, t, wk=None):
    """Executor of an ``mvau_int`` node on (M, K) patch rows or codes;
    ``wk`` the weights the lowering prepared for the plane route."""
    base = node.attrs.get("out_base", 0)
    disp = kernel_dispatch(node, not x.is_cuda)
    packed = bool(node.attrs.get("w_packed"))
    if disp.startswith("fused-cuda"):
        x, w, packed, xu = _kernel_codes(node, x, w, wk)
        return mvau_int(x, w, t, out_base=base, w_packed=packed,
                        x_unsigned=xu)
    if packed:
        w = Q.unpack_int4(w)
    return ref.mvau_int_fast(x, w, t, out_base=base,
                             acc_f32_exact=disp == "f32-gemm")


def conv_mvau_int_node(conv, node, x, w, t, wk=None):
    """Executor of a folded ``im2col`` -> ``mvau_int`` pair (see
    :func:`conv_pairs`) on the im2col node's input ``x``.  On the card the
    activation is narrowed once a call for the node's route
    (:func:`_kernel_codes`: int8, uint8 or int16 codes for the tensor
    cores, a ninth of the patches' bytes or less; int32 codes as stored for
    the plane route's 24-bit codes and for the CUDA cores).  Either kernel reads the patch rows itself.  Off the card
    the node takes its own route, as labelled, on patches local to this
    call."""
    k, s, p = conv.attrs["kernel"], conv.attrs["stride"], conv.attrs["pad"]
    if not x.is_cuda:
        return mvau_int_node(node, ref.im2col(x, k, s, p), w, t)
    x, w, packed, xu = _kernel_codes(node, x, w, wk)
    return mvau_int_conv(x, w, t, k, s, p,
                         out_base=node.attrs.get("out_base", 0),
                         w_packed=packed, x_unsigned=xu)


def tail_fits(conv, node, x, w, skip) -> bool:
    """Whether a matched tail's operands take the GAP epilogue: ``skip``
    holds integer codes of at most 32 bits in the MVAU output's own shape
    (B, OH, OW, N), and OH·OW divides 16.  The graph leaves shapes to run
    time, so the tail's step asks this on every call."""
    k, s, p = conv.attrs["kernel"], conv.attrs["stride"], conv.attrs["pad"]
    b, h, wd = x.shape[:3]
    oh, ow = (h + 2 * p - k) // s + 1, (wd + 2 * p - k) // s + 1
    n = w.shape[1] * (2 if node.attrs.get("w_packed") else 1)
    return (tuple(skip.shape) == (b, oh, ow, n) and 16 % (oh * ow) == 0
            and skip.dtype in (torch.int8, torch.uint8, torch.int16,
                               torch.int32))


def conv_mvau_int_gap_node(conv, node, pool, x, w, t, skip, wk=None):
    """Executor of a fused tail ``im2col -> mvau_int -> add ->
    global_acc_pool`` (see :func:`gap_tails`) on the im2col node's input
    ``x``, the MVAU's weights and thresholds, the add's other operand
    ``skip`` and the weights prepared for the plane route (``wk``).  On the
    card, where the operands fit (:func:`tail_fits`), one launch of the
    tensor-core conv kernel with its GAP epilogue.  Off the card, or for a
    skip that broadcasts or is float, the MVAU takes its own route, as
    labelled, and the sum of its output and ``skip`` is pooled as
    :func:`_gap_node` pools it (on the card, the GAP kernel)."""
    if not x.is_cuda or not tail_fits(conv, node, x, w, skip):
        y = conv_mvau_int_node(conv, node, x, w, t, wk)
        return _gap_node(pool, y, skip)
    k, s, p = conv.attrs["kernel"], conv.attrs["stride"], conv.attrs["pad"]
    x, w, packed, xu = _kernel_codes(node, x, w, wk)
    return mvau_int_conv_gap(x, w, t, skip, k, s, p,
                             out_base=node.attrs.get("out_base", 0),
                             w_packed=packed, x_unsigned=xu)


def _gap_node(node, x, skip=None):
    """Executor of a ``global_acc_pool`` node, with the residual ``add``
    before it folded in where ``skip`` is given (see
    :func:`residual_gaps`).  An operand that broadcasts is added first, as
    the ``add`` node would; then the GAP kernel pools axes (1, 2) of a 4-D
    tensor (with ``skip`` folded in where it still stands), and a plain sum
    any other axes."""
    axes = tuple(node.attrs["axes"])
    if skip is not None and skip.shape != x.shape:
        x, skip = x + skip, None
    if x.ndim == 4 and axes == (1, 2):
        return gap(x, skip)
    if skip is not None:
        x = x + skip
    if not x.dtype.is_floating_point:
        return torch.sum(x.to(torch.int32), dim=axes).to(torch.int32)
    return torch.sum(x, dim=axes)


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
        counts = ref.threshold_counts_fast(x.to(torch.int32), t,
                                           node.attrs.get("sorted_levels"))
        return (base + counts).to(torch.int32)

    def _requantize_node(node, q):
        return ref.requantize(q, node.attrs["shift"], node.attrs["bits"],
                              node.attrs["frac_bits"],
                              node.attrs.get("signed", True))

    return {"mvau": mvau_node, "mvau_int": mvau_int_node,
            "matmul_int": _matmul_int_node,
            "multithreshold_int": _multithreshold_int_node,
            "requantize": _requantize_node,
            "global_acc_pool": _gap_node}
