"""End-to-end few-shot pipeline (paper Fig. 1): (1) backbone pretraining on
base classes, (2) frozen-backbone feature extraction over support sets,
(3) NCM inference over queries.

Counterpart of the JAX package's ``fsl/pipeline.py``.  The backbone runs at
an arbitrary fixed-point bit-width (QuantConfig), and the SAME QuantConfig
drives training, the QAT forward and the deployed graph, so the accuracy
measured through ``deploy`` is the deployed accuracy.
"""

from __future__ import annotations

import dataclasses
import sys
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import as_tensor
from repro_torch.core.quant import QuantConfig
from repro_torch.core.recipes import recipe
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fsl import ncm
from repro_torch.optim.adamw import adamw_init, adamw_update, cosine_warmup
from repro_torch.tree import tree_flatten


def _flip_w(x: torch.Tensor) -> torch.Tensor:
    """Mirror NHWC frames along W (the reference's ``x[:, :, ::-1]``;
    PyTorch has no negative strides)."""
    return torch.flip(x, dims=[2])


@dataclasses.dataclass
class FSLPipeline:
    width: int = 16
    qcfg: Optional[QuantConfig] = None
    # Backbone architecture, resolved through the BuildRecipe registry.
    arch: str = "resnet9"
    n_way: int = 5
    k_shot: int = 5
    n_query: int = 15
    easy_augment: bool = True   # EASY-style augmented shots (flip ensembling)
    device: DeviceLike = None   # None: the card
    # deploy() memo: (id(params), datapath) -> feats fn, LRU-bounded; the
    # params ref is kept inside the value so the id can never be recycled
    # while cached.
    deploy_cache_size: int = 4
    _deploy_cache: "OrderedDict" = dataclasses.field(
        default_factory=lambda: OrderedDict(), repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def for_point(cls, w_bits: int, a_bits: int, *, width: int = 8,
                  **kwargs) -> "FSLPipeline":
        """Pipeline at a DSE grid point (``QuantConfig.grid_point``)."""
        return cls(width=width, qcfg=QuantConfig.grid_point(w_bits, a_bits),
                   **kwargs)

    def _hooks(self):
        return recipe(self.arch).workload_hooks("fsl")

    def features(self, params, x) -> torch.Tensor:
        """QAT-forward features (with the flip ensemble when enabled)."""
        fwd = self._hooks().forward
        x = as_tensor(x, self.device)
        with torch.no_grad():
            f = fwd(params, x, self.qcfg, self.width)
            if self.easy_augment:
                f = f + fwd(params, _flip_w(x), self.qcfg, self.width)
        return f

    def deploy(self, params, datapath: str = "f32"):
        """Compile the backbone into a :class:`DeployedModel` on the
        pipeline's device and return a feature function numerically
        identical to :meth:`features`.

        ``datapath="int"`` deploys the integer datapath (integer weight
        codes + ``mvau_int`` on the CUDA kernel).  The int graph opens with
        its own ``quantize`` node and ``quantize(fake_quant(x)) ==
        quantize(x)`` on any grid, so only the f32 emulation keeps the input
        ``fake_quant``.  The whole flip ensemble (the input ``fake_quant``,
        the flip, both forwards and the sum) is one function, which
        ``warmup`` captures as ONE CUDA graph per bucket on the card, as the
        reference traces it into one program per bucket.  Repeated calls
        with the SAME params object and datapath return the SAME function.

        The returned function carries ``.deployed_model``, ``.params``,
        ``.device``, ``.trace_count()`` (captures plus distinct shapes run
        eagerly: flat after warmup), ``._exec`` (its executable table) and
        ``.warmup(buckets, img=..., cache=None, metrics=None, label=None)``.
        """
        from repro_torch.core.cudagraph import GraphTable
        from repro_torch.core.deploy import compile as compile_graph
        from repro_torch.core.deploy import normalize_buckets
        from repro_torch.core.quant import fake_quant

        if self.qcfg is None:
            raise ValueError("deploy() needs a QuantConfig: the compiled "
                             "graph bakes thresholds for a specific grid")
        key = (id(params), datapath)
        cached = self._deploy_cache.get(key)
        if cached is not None and cached.params is params:
            self._deploy_cache.move_to_end(key)
            return cached
        dm = compile_graph(params, self.qcfg, recipe=self.arch,
                           datapath=datapath, device=self.device)
        act = self.qcfg.act
        flip = self.easy_augment
        quant_in = datapath != "int"

        def ensemble(x: torch.Tensor) -> torch.Tensor:
            f = dm.apply(fake_quant(x, act) if quant_in else x)[0]
            if flip:
                xf = _flip_w(x)
                f = f + dm.apply(fake_quant(xf, act) if quant_in else xf)[0]
            return f

        table = GraphTable(ensemble, dm.device)

        def feats(x) -> torch.Tensor:
            return table(as_tensor(x, dm.device))[0]

        def warmup(buckets, img: int = 32, cache=None, metrics=None,
                   label: Optional[str] = None) -> tuple:
            """Warm one zero batch of (b, img, img, 3) frames per bucket: a
            CUDA graph of the whole ensemble on the card, one eager run on
            the CPU.  With ``cache`` (a ``CompileCache``) each bucket's key
            is the reference's: the deployed graph's fingerprint AND the
            ensemble's config (flip, activation grid, frame size), as the
            fused program is not the bare DeployedModel."""
            name = label or f"fused-{dm.graph.name}"
            bs = normalize_buckets(buckets)
            for b in bs:
                shape = (b, img, img, 3)
                key = None
                if cache is not None:
                    key = cache.key(kind="fused-feats",
                                    graph=dm.fingerprint(), flip=flip,
                                    act=repr(act), shape=list(shape),
                                    dtype="float32", device=dm.device)
                table.warm((torch.zeros(shape, dtype=torch.float32,
                                        device=dm.device),),
                           name=name, metrics=metrics, cache=cache, key=key)
            return bs

        feats.deployed_model = dm
        feats.params = params
        feats.device = dm.device
        feats.trace_count = lambda: table.trace_count
        feats.warmup = warmup
        feats._exec = table
        self._deploy_cache[key] = feats
        while len(self._deploy_cache) > max(self.deploy_cache_size, 1):
            self._deploy_cache.popitem(last=False)
        return feats


def pretrain_init(data: SyntheticImages, pipe: FSLPipeline,
                  seed: int = 0) -> Dict:
    """The pretraining tree ``{"backbone", "head": {"w"}}`` on the
    pipeline's device, drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (the same weights on any device)."""
    hooks = pipe._hooks()
    gen = torch.Generator().manual_seed(seed)
    head = torch.randn((hooks.feature_dim(pipe.width), data.n_base),
                       generator=gen, dtype=torch.float32) * 0.02
    return {"backbone": hooks.init_params(gen, pipe.width, pipe.device),
            "head": {"w": head.to(pipe.device)}}


def pretrain_step(pipe: FSLPipeline, params: Dict, opt, sched, x, y):
    """One eager step: the reference's ``logsumexp − gold`` loss through
    ``hooks.forward`` itself (not :meth:`FSLPipeline.features`, which
    records no graph), its gradient with respect to every leaf, and an
    AdamW update with the reference's weight decay of 1e-4.  ``x`` (B, H,
    W, 3) float32 and ``y`` (B,) int on the pipeline's device.  Returns
    ``(params, opt, loss)``."""
    hooks = pipe._hooks()
    leaves, unflatten = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    p = unflatten(leaves)
    f = hooks.forward(p["backbone"], x, pipe.qcfg, pipe.width)
    logits = f @ p["head"]["w"]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, y[:, None])[:, 0]
    loss = (lse - gold).mean()
    grads = torch.autograd.grad(loss, leaves)
    params, opt = adamw_update(unflatten([q.detach() for q in leaves]),
                               unflatten(list(grads)), opt, sched,
                               weight_decay=1e-4)
    return params, opt, loss.detach()


def pretrain_backbone(data: SyntheticImages, pipe: FSLPipeline,
                      steps: int = 150, batch: int = 64, lr: float = 2e-3,
                      seed: int = 0, log_every: int = 0) -> Dict:
    """Base-class pretraining: backbone + linear head, CE loss, AdamW,
    eagerly on the pipeline's device.

    Weights from :func:`pretrain_init`, batches from
    ``np.random.default_rng(seed)`` (the reference's batches, image for
    image), one :func:`pretrain_step` each.  Returns ``{"params": backbone
    tree, "losses": [float, ...]}``.
    """
    dev = pipe.device
    params = pretrain_init(data, pipe, seed)
    opt = adamw_init(params)
    sched = cosine_warmup(lr, warmup=max(steps // 20, 1), total=steps)
    rng = np.random.default_rng(seed)
    losses = []
    for i in range(steps):
        x, y = data.base_batch(rng, batch)
        params, opt, loss = pretrain_step(
            pipe, params, opt, sched, torch.from_numpy(x).to(dev),
            torch.from_numpy(y).to(dev, torch.int64))
        losses.append(loss)
        if log_every and i % log_every == 0:
            sys.stdout.write(f"  pretrain step {i:4d} loss "
                             f"{float(loss):.4f}\n")
    losses = torch.stack(losses).cpu().tolist() if losses else []
    return {"params": params["backbone"], "losses": losses}


def evaluate_episodes(backbone_params, data: SyntheticImages,
                      pipe: FSLPipeline, n_episodes: int = 20,
                      seed: int = 100, feats_fn=None) -> Tuple[float, float]:
    """Mean ± 95% CI accuracy over novel-class episodes (paper Table II).

    ``feats_fn`` overrides the feature extractor — pass
    ``pipe.deploy(params)`` to score episodes through the compiled
    DeployedModel instead of the QAT forward.  The NCM head runs on the
    device of the features, as the store's does.
    """
    feats = feats_fn or (lambda x: pipe.features(backbone_params, x))
    rng = np.random.default_rng(seed)
    accs = []
    for _ in range(n_episodes):
        ep = data.episode(rng, pipe.n_way, pipe.k_shot, pipe.n_query)
        sf = feats(ep["support_x"])
        qf = feats(ep["query_x"])
        acc = ncm.ncm_accuracy(qf, torch.as_tensor(ep["query_y"]), sf,
                               torch.as_tensor(ep["support_y"]), pipe.n_way)
        accs.append(float(acc))
    accs = np.asarray(accs)
    ci = 1.96 * accs.std() / np.sqrt(len(accs))
    return float(accs.mean()), float(ci)
