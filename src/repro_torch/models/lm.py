"""Decoder LM of the dense family: the PyTorch port of the JAX package's
``models/lm.py`` (its dense path).

Entry points (functions of (params, batch), as in the reference):

* ``init_params(gen, cfg, device)`` — parameter tree with stacked
  ``(n_layers, ...)`` block leaves, the reference's layout, so a JAX tree
  carried across with :func:`repro_torch.convert.params_from_numpy` runs
  unchanged.  The reference scans over the stacked leaves; the port loops
  over layers in Python.
* ``forward(params, batch, cfg)`` — full-sequence logits (and a zero aux
  loss, the reference's MoE slot).  With ``cfg.remat`` and gradients
  enabled every block is recomputed in the backward
  (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
* ``loss_fn(params, batch, cfg)`` — token cross-entropy in float32 over
  all ``vocab_padded`` logits (+ 0.01 x the aux loss): what
  ``launch.steps.make_train_step`` differentiates.
* ``prefill(params, batch, cfg)`` — last-position logits only.
* ``init_cache(cfg, B, max_len, dtype, device)`` — the KV cache.
* ``decode_step(params, tokens, cache, cfg)`` — one new token for every
  sequence; the cache's k/v are written in place.
* ``export_decode_graph`` / ``export_prefill_graph`` — the dense decode
  step and the whole-prompt forward as core Graphs for
  ``repro_torch.compile(..., recipe="lm-decode")``, ``decode_step_ref``
  their eager mirror, bit for bit with the compiled artifact.

MoE, MLA, SSM, hybrid, VLM and audio families wait for later slices of the
port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.quant import fake_quant
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.common import ArchConfig
from repro_torch.tree import tree_flatten

Params = Dict[str, Any]


def _wspec(cfg: ArchConfig):
    return cfg.quant.weight if cfg.quant else None


def _aspec(cfg: ArchConfig):
    return cfg.quant.act if cfg.quant else None


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise L.not_ported(f"the {cfg.family} family", cfg.family)
    if cfg.attention == "mla":
        raise L.not_ported("MLA attention", "MLA (minicpm3)")
    if cfg.moe_experts:
        raise L.not_ported("MoE layers", "moe")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ArchConfig,
                device: DeviceLike = None) -> Params:
    """Embedding N(0, 0.02), RMSNorm gains 1, dense weights uniform in
    ±1/sqrt(d_in), zero biases: the reference's distributions.  The draws
    come from ``gen`` on its own device (a CUDA generator draws the full
    model on the card), then move to ``device`` (default: the card)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    n, d = cfg.n_layers, cfg.d_model
    embed = torch.randn((cfg.vocab_padded, d), generator=gen,
                        dtype=torch.float32, device=gen.device)
    p: Params = {"embed": embed.mul_(0.02).to(dev),
                 "final_norm": L.rmsnorm_init(d, device=dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = L.dense_init(gen, d, cfg.vocab_padded, device=dev)
    stack = (n,)
    p["blocks"] = {
        "ln1": L.rmsnorm_init(d, stack, dev),
        "ln2": L.rmsnorm_init(d, stack, dev),
        "attn": L.attn_init(gen, cfg, stack, dev),
        "mlp": L.mlp_init(gen, d, cfg.d_ff, cfg.act, stack, dev),
    }
    return p


def _layers(params: Params, cfg: ArchConfig) -> List[Params]:
    """Each layer's tree of views into the stacked leaves.  ``unbind``
    makes them: its backward stacks the layers' gradients into one leaf
    gradient, where one select per layer would add n_layers full-size
    leaves."""
    leaves, unflatten = tree_flatten(params["blocks"])
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [unflatten([views[i] for views in per_leaf])
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# Blocks, embedding, head
# ---------------------------------------------------------------------------
def _attn_half(p: Params, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, cache=None):
    """The block's attention branch: (its output, the new cache); the
    reference names the output ``attn_out``."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    return L.attention(p["attn"], h, cfg, positions, cache=cache,
                       wspec=_wspec(cfg))


def _mlp_half(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The block's MLP branch, its output on the activation grid; the
    reference names it ``mlp_out``."""
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    m = L.mlp(p["mlp"], h, cfg.act, _wspec(cfg), _aspec(cfg))
    return fake_quant(m, _aspec(cfg))


def _attn_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor, cache=None):
    a, new_cache = _attn_half(p, x, cfg, positions, cache)
    x = x + a
    return x + _mlp_half(p, x, cfg), new_cache


def _checkpoint(fn, *args):
    from torch.utils.checkpoint import checkpoint

    # the forward draws no random numbers: no RNG state to stash
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _remat_block(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """One block with activation checkpointing, the reference's ``_remat``:
    the whole block recomputed in the backward, or with ``remat_policy ==
    "tp_outputs"`` the attention and MLP branches recomputed separately,
    so their outputs (``attn_out``, ``mlp_out``) are the saved tensors.
    The ops are ``_attn_block``'s, so the values and gradients are the
    same bits as without remat."""
    if cfg.remat_policy == "tp_outputs":
        x = x + _checkpoint(lambda t: _attn_half(p, t, cfg, positions)[0], x)
        return x + _checkpoint(lambda t: _mlp_half(p, t, cfg), x)
    return _checkpoint(lambda t: _attn_block(p, t, cfg, positions)[0], x)


def _embed_tokens(p: Params, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    return p["embed"][tokens].to(compute_dtype(cfg))


def _positions_for(batch, S: int, B: int, device) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def with_head_copy(params: Params, cfg: ArchConfig) -> Params:
    """``params`` plus one copy of the tied embedding in the compute dtype,
    made once at load time: the head reads it instead of casting the
    float32 table on every step.  The cast is deterministic, so the logits
    are the same."""
    dt = compute_dtype(cfg)
    if (not cfg.tie_embeddings or params["embed"].dtype == dt
            or "embed_head" in params):
        return params
    return dict(params, embed_head=params["embed"].to(dt))


def _head(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        w = p.get("embed_head")
        if w is None or w.dtype != x.dtype:
            w = p["embed"].to(x.dtype)
        return torch.matmul(x, w.T)
    return L.dense(p["lm_head"], x, _wspec(cfg), dtype=x.dtype)


# ---------------------------------------------------------------------------
# Forward, prefill
# ---------------------------------------------------------------------------
def _trunk(params: Params, batch: Dict[str, torch.Tensor],
           cfg: ArchConfig) -> torch.Tensor:
    _require_dense(cfg)
    x = _embed_tokens(params, batch["tokens"], cfg)
    B, S, _ = x.shape
    positions = _positions_for(batch, S, B, x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for bp in _layers(params, cfg):
        if remat:
            x = _remat_block(bp, x, cfg, positions)
        else:
            x, _ = _attn_block(bp, x, cfg, positions)
    return x


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits, aux loss); aux is the reference's MoE slot, zero for
    the dense family."""
    x = L.rmsnorm(params["final_norm"], _trunk(params, batch, cfg),
                  cfg.norm_eps)
    return _head(params, x, cfg), torch.zeros((), dtype=torch.float32,
                                              device=x.device)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> torch.Tensor:
    """Mean token cross-entropy, float32, plus 0.01 x the aux loss: the
    reference's ``loss_fn`` op for op.  The log-sum-exp runs over all
    ``vocab_padded`` logits, padding columns included, minus the gold
    logit (a gather), as the reference computes it.

    A tied head reads ``embed`` itself: a serving copy added by
    :func:`with_head_copy` (``embed_head``) is ignored here, as it would
    be stale after an update and would cut the head's gradient to the
    table."""
    params = {k: v for k, v in params.items() if k != "embed_head"}
    logits, aux = forward(params, batch, cfg)
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, batch["labels"].long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    return ce + 0.01 * aux


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> torch.Tensor:
    """Full-sequence forward; emits ONLY last-position logits (B, V)."""
    x = _trunk(params, batch, cfg)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return _head(params, x, cfg)[:, 0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, B: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> Params:
    """KV cache with a leading layer axis: k, v (n_layers, B, max_len, KV,
    hd) and per-layer int32 lengths."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.hd)
    return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev),
                     "len": torch.zeros((cfg.n_layers,), dtype=torch.int32,
                                        device=dev)}}


def decode_step(params: Params, tokens: torch.Tensor, cache: Params,
                cfg: ArchConfig, positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One new token for every sequence: tokens (B, 1) -> logits (B, V).

    Positions come from the first layer's cache length, kept on the device
    (no host sync per step).  The cache's k/v are updated in place and the
    returned cache holds them with every length advanced by the new
    tokens.
    """
    _require_dense(cfg)
    B = tokens.shape[0]
    x = _embed_tokens(params, tokens, cfg)
    c = cache["attn"]
    if positions is None:
        positions = c["len"][0].expand(B, 1)
    for i, bp in enumerate(_layers(params, cfg)):
        lc = {"k": c["k"][i], "v": c["v"][i], "len": c["len"][i]}
        x, _ = _attn_block(bp, x, cfg, positions, cache=lc)
    new_cache = dict(cache)
    new_cache["attn"] = {"k": c["k"], "v": c["v"],
                         "len": c["len"] + tokens.shape[1]}
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _head(params, x, cfg)[:, 0], new_cache


# ---------------------------------------------------------------------------
# Decode serving through the repro_torch.compile datatype IR
# ---------------------------------------------------------------------------
# The exporters put the dense decode/prefill step onto the core Graph, so
# the compiler that builds resnet9 builds the LM: weights land as
# fake-quantized initializers (annotated with their FixedPointSpec), every
# matmul input passes through a FINN activation quantizer (multithreshold
# over the canonical grid table, which lower_to_integer_datapath
# streamlines to one ``quantize``), and the real-valued ops (rmsnorm, gelu,
# silu, softmax attention) stay float between quantizers.  The graphs are
# built from the same numpy values as the reference's: the same node names,
# ops, attrs and initializers.  ``decode_step_ref`` is the eager mirror of
# the decode graph, bit for bit with the compiled artifact.

def _decode_exportable(cfg: ArchConfig) -> None:
    """The exporter covers the plain dense family; fail loudly otherwise."""
    problems = []
    if cfg.family != "dense":
        problems.append(f"family={cfg.family!r} (need 'dense')")
    if cfg.attention != "gqa" or cfg.n_kv_heads != cfg.n_heads:
        problems.append("grouped/latent attention (need n_kv_heads==n_heads)")
    if cfg.pos != "none":
        problems.append(f"pos={cfg.pos!r} (rotary ids are not graph ops yet)")
    if cfg.qkv_bias or cfg.qk_norm:
        problems.append("qkv_bias/qk_norm")
    if cfg.moe_experts:
        problems.append("moe")
    if cfg.tie_embeddings:
        problems.append("tie_embeddings")
    if cfg.act not in ("gelu", "swiglu"):
        problems.append(f"act={cfg.act!r}")
    if problems:
        raise ValueError(
            f"config '{cfg.name}' is not decode-exportable: "
            + "; ".join(problems))


def _np(a):
    import numpy as np

    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _block_params(params: Params, i: int):
    """Layer ``i``'s view of the stacked ``blocks`` tree, as numpy."""
    from repro_torch.tree import tree_map

    return tree_map(lambda a: _np(a[i]), params["blocks"])


def _export_graph(params: Params, cfg: ArchConfig, *, decode: bool,
                  name: Optional[str] = None):
    import numpy as np

    from repro_torch.core import quant
    from repro_torch.core.graph import Graph, Node

    _decode_exportable(cfg)
    wspec, aspec = _wspec(cfg), _aspec(cfg)
    H = cfg.n_heads
    nodes = []
    inits: Dict[str, Any] = {}
    dtypes: Dict[str, Any] = {}

    def w_init(nm, arr):
        w = np.asarray(_np(arr), np.float32)
        if wspec is not None:
            w = fake_quant(torch.from_numpy(np.ascontiguousarray(w)),
                           wspec).numpy()
        inits[nm] = w
        dtypes[nm] = wspec
        return nm

    def f_init(nm, arr):                 # float param (norm gains): no grid
        inits[nm] = np.asarray(_np(arr), np.float32)
        return nm

    def act_quant(x_t, out):
        """FINN activation quantizer: multithreshold over the canonical grid
        (exactly ``fake_quant(x, aspec)``).  Each node owns its table: the
        integer lowering rewrites int-fed tables in place."""
        if aspec is None:
            return x_t
        t_nm = f_init(out + "_t", quant.thresholds_for(aspec))
        nodes.append(Node("multithreshold", [x_t, t_nm], [out],
                          {"channel_axis": -1, "out_base": aspec.qmin,
                           "out_scale": aspec.scale}))
        return out

    def matmul(x_t, w_nm, out):
        nodes.append(Node("matmul", [x_t, w_nm], [out]))
        return out

    x = "x0"
    nodes.append(Node("embed", [w_init("embed_w", params["embed"]), "tokens"],
                      [x]))
    cache_in, cache_out = [], []
    for i in range(cfg.n_layers):
        bp = _block_params(params, i)
        p = f"l{i}"
        nodes.append(Node("rmsnorm", [x, f_init(f"{p}.ln1_g", bp["ln1"]["g"])],
                          [f"{p}.n1"], {"eps": cfg.norm_eps}))
        hq = act_quant(f"{p}.n1", f"{p}.aq1")
        q = matmul(hq, w_init(f"{p}.wq", bp["attn"]["wq"]["w"]), f"{p}.q")
        k = matmul(hq, w_init(f"{p}.wk", bp["attn"]["wk"]["w"]), f"{p}.k")
        v = matmul(hq, w_init(f"{p}.wv", bp["attn"]["wv"]["w"]), f"{p}.v")
        if decode:
            cache_in += [f"k{i}", f"v{i}"]
            cache_out += [f"k{i}_out", f"v{i}_out"]
            nodes.append(Node("attn_decode",
                              [q, k, v, f"k{i}", f"v{i}", "pos"],
                              [f"{p}.ao", f"k{i}_out", f"v{i}_out"],
                              {"heads": H}))
        else:
            cache_out += [k, v]          # prefill: the projections ARE the cache
            nodes.append(Node("attn_prefill", [q, k, v], [f"{p}.ao"],
                              {"heads": H}))
        aoq = act_quant(f"{p}.ao", f"{p}.aq2")
        matmul(aoq, w_init(f"{p}.wo", bp["attn"]["wo"]["w"]), f"{p}.o")
        nodes.append(Node("add", [x, f"{p}.o"], [f"{p}.r1"]))
        nodes.append(Node("rmsnorm",
                          [f"{p}.r1", f_init(f"{p}.ln2_g", bp["ln2"]["g"])],
                          [f"{p}.n2"], {"eps": cfg.norm_eps}))
        h2q = act_quant(f"{p}.n2", f"{p}.aq3")
        if cfg.act == "gelu":
            matmul(h2q, w_init(f"{p}.w_up", bp["mlp"]["w_up"]["w"]),
                   f"{p}.up")
            nodes.append(Node("gelu", [f"{p}.up"], [f"{p}.h"]))
        else:                            # swiglu
            matmul(h2q, w_init(f"{p}.w_gate", bp["mlp"]["w_gate"]["w"]),
                   f"{p}.gate")
            nodes.append(Node("silu", [f"{p}.gate"], [f"{p}.sg"]))
            matmul(h2q, w_init(f"{p}.w_up", bp["mlp"]["w_up"]["w"]),
                   f"{p}.up")
            nodes.append(Node("mul", [f"{p}.sg", f"{p}.up"], [f"{p}.h"]))
        hq2 = act_quant(f"{p}.h", f"{p}.aq4")   # mirrors L.mlp's mid-MLP QAT
        matmul(hq2, w_init(f"{p}.w_down", bp["mlp"]["w_down"]["w"]),
               f"{p}.dn")
        mq = act_quant(f"{p}.dn", f"{p}.aq5")   # mirrors _attn_block's output
        nodes.append(Node("add", [f"{p}.r1", mq], [f"{p}.r2"]))
        x = f"{p}.r2"
    nodes.append(Node("rmsnorm",
                      [x, f_init("final_g", params["final_norm"]["g"])],
                      ["nf"], {"eps": cfg.norm_eps}))
    fq = act_quant("nf", "head_aq")
    matmul(fq, w_init("lm_head_w", params["lm_head"]["w"]), "logits")
    inputs = ["tokens"] + (["pos"] + cache_in if decode else [])
    gname = name or (f"{cfg.name or 'lm'}-" + ("decode" if decode else
                                               "prefill"))
    g = Graph(nodes=nodes, inputs=inputs, outputs=["logits"] + cache_out,
              initializers=inits, name=gname)
    g.dtypes.update(dtypes)
    g.toposort()
    return g


def export_decode_graph(params: Params, cfg: ArchConfig, *,
                        name: Optional[str] = None):
    """One-token decode step as a core Graph.

    Inputs: ``tokens (B,) int32``, ``pos (B,) int32``, then per layer
    ``k{i}/v{i} (B, C, d_model) f32``: the capacity ``C`` is free, so one
    graph serves every KV bucket and the deploy layer captures one CUDA
    graph per (batch bucket x capacity).  Outputs: ``logits (B,
    vocab_padded)`` then the updated ``k{i}_out/v{i}_out`` caches.
    """
    return _export_graph(params, cfg, decode=True, name=name)


def export_prefill_graph(params: Params, cfg: ArchConfig, *,
                         name: Optional[str] = None):
    """Whole-prompt forward as a core Graph: ``tokens (B, S)`` ->
    ``logits (B, S, V)`` plus per-layer K/V projections ``(B, S, d_model)``
    (they ARE the prefill cache)."""
    return _export_graph(params, cfg, decode=False, name=name)


def decode_step_ref(params: Params, tokens, pos, caches, cfg: ArchConfig):
    """Eager float32 mirror of :func:`export_decode_graph`, bit for bit with
    the compiled artifact: the same helpers in the same order
    (``fake_quant`` == the graph's grid multithreshold == the int
    datapath's ``quantize``; ``rmsnorm``, ``gelu_tanh``, ``silu`` and
    ``ref.attn_decode`` are the graph executors' own functions).

    tokens/pos: (B,) int32; caches: [k0, v0, k1, v1, ...] each (B, C, D).
    Runs on the device of ``params``.  Returns ``(logits (B, V),
    new_caches)``.
    """
    from repro_torch.kernels import ref

    wspec, aspec = _wspec(cfg), _aspec(cfg)
    dev = params["embed"].device

    def fq_w(w):
        return fake_quant(w, wspec) if wspec is not None else w

    def aq(t):
        return fake_quant(t, aspec) if aspec is not None else t

    def mm(a, w):
        return ref._f32_matmul(a, fq_w(w))

    with torch.no_grad():
        tokens = torch.as_tensor(tokens, device=dev).long()
        pos = torch.as_tensor(pos, device=dev).to(torch.int32)
        caches = [torch.as_tensor(c, device=dev) for c in caches]
        x = fq_w(params["embed"]).to(torch.float32)[tokens]
        new_caches = []
        for i, bp in enumerate(_layers(params, cfg)):
            hq = aq(L.rmsnorm(bp["ln1"], x, cfg.norm_eps))
            q = mm(hq, bp["attn"]["wq"]["w"])
            k = mm(hq, bp["attn"]["wk"]["w"])
            v = mm(hq, bp["attn"]["wv"]["w"])
            o, kc, vc = ref.attn_decode(q, k, v, caches[2 * i],
                                        caches[2 * i + 1], pos, cfg.n_heads)
            new_caches += [kc, vc]
            x = x + mm(aq(o), bp["attn"]["wo"]["w"])
            h2q = aq(L.rmsnorm(bp["ln2"], x, cfg.norm_eps))
            if cfg.act == "gelu":
                h = L.gelu_tanh(mm(h2q, bp["mlp"]["w_up"]["w"]))
            else:
                h = (L.silu(mm(h2q, bp["mlp"]["w_gate"]["w"]))
                     * mm(h2q, bp["mlp"]["w_up"]["w"]))
            dn = mm(aq(h), bp["mlp"]["w_down"]["w"])
            x = x + aq(dn)
        fq = aq(L.rmsnorm(params["final_norm"], x, cfg.norm_eps))
        logits = mm(fq, params["lm_head"]["w"])
    return logits, new_caches


def example_decode_feeds(cfg: ArchConfig, *, batch: int = 2,
                         capacity: int = 8, seed: int = 0):
    """Named numpy feeds for :func:`export_decode_graph` golden-IO checks,
    drawn as the reference draws them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    feeds = {
        "tokens": rng.randint(0, cfg.vocab, size=(batch,)).astype(np.int32),
        "pos": rng.randint(0, capacity, size=(batch,)).astype(np.int32),
    }
    for i in range(cfg.n_layers):
        feeds[f"k{i}"] = rng.randn(batch, capacity,
                                   cfg.d_model).astype(np.float32)
        feeds[f"v{i}"] = rng.randn(batch, capacity,
                                   cfg.d_model).astype(np.float32)
    return feeds


def example_prefill_feeds(cfg: ArchConfig, *, batch: int = 2, seq: int = 4,
                          seed: int = 0):
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab,
                                  size=(batch, seq)).astype(np.int32)}


@dataclasses.dataclass(frozen=True)
class DecodeHooks:
    """The decode workload's hook bundle (the recipe's
    ``workload_hooks("decode")``; FSL's is the other)."""

    export_decode: Any
    export_prefill: Any
    step_ref: Any
    example_feeds: Any


def _export_for_compile(model, qcfg):
    """``repro_torch.compile`` exporter: model = {"params", "cfg"}."""
    params, cfg = model["params"], model["cfg"]
    if qcfg is not None and qcfg is not cfg.quant:
        cfg = dataclasses.replace(cfg, quant=qcfg)
    return export_decode_graph(params, cfg)


def _register_recipe():
    from repro_torch.core.recipes import register_recipe

    register_recipe(
        "lm-decode",
        [],   # datatype passes ride in via compile(datapath="int"); no CNN
              # streamlining, and float attention is not HW-mappable
        description=("dense decoder-LM decode/prefill: datatype inference + "
                     "integer lowering only"),
        exporter=_export_for_compile,
        hooks={"decode": DecodeHooks(export_decode_graph,
                                     export_prefill_graph,
                                     decode_step_ref,
                                     example_decode_feeds)})


_register_recipe()
