"""Per-tenant namespaces over the artifact registry.

Counterpart of the JAX package's ``serve/cluster/tenancy.py``.
Multi-tenant serving is an *isolation* problem stacked on the existing A/B
machinery: every tenant needs its own prototype state (tenant A's "pelican"
class must be invisible to tenant B), its own default artifact, and a
bounded share of the engine's admission queue — while the expensive part,
the compiled backbone and its warmed CUDA graphs, is shared by everyone
(features are tenant-independent; only the NCM state is tenanted).

:class:`TenantRegistry` realises that split as a plain
:class:`~repro_torch.serve.registry.ArtifactRegistry` whose entries are
namespaced ``tenant/backbone`` views: one :class:`ServedArtifact` per
(tenant, backbone) pair, all sharing the backbone's feats callable (one
compile, one table of warmed graphs, one warmup) but each owning a private
:class:`PrototypeStore`.  The
:class:`~repro_torch.serve.engine.ServeEngine` needs no tenant knowledge
beyond the quota counter — it just serves namespaced artifact names, and
batches freely coalesce requests from different tenants over the same
backbone graphs.

The store's bit-for-bit contract survives tenancy untouched: each tenant's
store folds its own shots through the same canonical left fold, so every
tenant's served prototypes equal an offline NCM recompute over that
tenant's shots alone.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.device import DeviceLike
from repro_torch.serve.registry import ArtifactRegistry, ServedArtifact
from repro_torch.serve.store import PrototypeStore

__all__ = ["TenantRegistry"]

SEP = "/"


def _check_component(kind: str, name: str) -> str:
    if not name or SEP in name:
        raise ValueError(f"{kind} name must be non-empty and contain no "
                         f"{SEP!r}, got {name!r}")
    return name


class TenantRegistry(ArtifactRegistry):
    """Artifact registry with per-tenant namespaces over shared backbones.

    Usage::

        reg = TenantRegistry()
        reg.register_backbone("w6a4-int", pipe.deploy(params, "int"),
                              default=True)
        reg.add_tenant("acme")
        name = reg.resolve("acme")            # -> "acme/w6a4-int"
        engine.submit_classify(x, artifact=name, tenant="acme")

    ``store_factory(device)`` builds each tenant view's store on a device:
    the registry's ``device`` when given, else the backbone feats'
    ``device`` (a ``DeployedModel``'s or an ``FSLPipeline.deploy``
    function's), else the card.  The cluster layer passes a
    sharded-classify store; the default is the plain
    :class:`PrototypeStore`.
    """

    def __init__(self, store_factory: Optional[
            Callable[[DeviceLike], PrototypeStore]] = None,
                 device: DeviceLike = None):
        super().__init__()
        self._store_factory = store_factory or PrototypeStore
        self._device = device
        self._backbones: Dict[str, ServedArtifact] = {}
        self._backbone_default: Optional[str] = None
        self._tenant_names: Dict[str, str] = {}   # tenant -> default backbone

    # -- shared backbones ---------------------------------------------------
    def register_backbone(self, name: str, feats: Callable, *,
                          default: bool = False,
                          meta: Optional[Dict[str, Any]] = None
                          ) -> ServedArtifact:
        """Register a compiled backbone shared by every tenant.  Existing
        tenants immediately gain a namespaced view of it (with a fresh
        store); the first backbone (or ``default=True``) becomes the
        default artifact behind ``resolve(tenant)``.

        The backbone itself also registers under its bare name (with its
        own store) so untenanted traffic and the engine's warmup sweep can
        address it directly."""
        _check_component("backbone", name)
        art = super().register(name, feats, store=self._store(feats),
                               default=default, meta=meta)
        with self._lock:
            self._backbones[name] = art
            if default or self._backbone_default is None:
                self._backbone_default = name
            tenants = list(self._tenant_names)
        for tenant in tenants:
            self._register_view(tenant, name, art, meta)
        return art

    def _store(self, feats: Callable) -> PrototypeStore:
        dev = self._device if self._device is not None else getattr(
            feats, "device", None)
        return self._store_factory(dev)

    def _register_view(self, tenant: str, backbone: str,
                       art: ServedArtifact,
                       meta: Optional[Dict[str, Any]]) -> ServedArtifact:
        view_meta = dict(meta or art.meta)
        view_meta.update({"tenant": tenant, "backbone": backbone})
        return super().register(f"{tenant}{SEP}{backbone}", art.feats,
                                store=self._store(art.feats), meta=view_meta,
                                adapter=art.adapter)

    # -- tenants ------------------------------------------------------------
    def add_tenant(self, tenant: str,
                   default_backbone: Optional[str] = None) -> str:
        """Create (idempotently) a tenant namespace: one ServedArtifact view
        per registered backbone, each with a private store.  Views share
        the backbone feats object, so a tenant added AFTER warmup serves
        from the already-warmed graphs — tenant onboarding never
        recompiles anything."""
        _check_component("tenant", tenant)
        with self._lock:
            known = tenant in self._tenant_names
            backbones = dict(self._backbones)
            default = default_backbone or self._backbone_default
        if default is None:
            raise ValueError("register_backbone() before add_tenant(): a "
                             "tenant needs at least one servable backbone")
        if default not in backbones:
            raise KeyError(f"unknown backbone {default!r}; have "
                           f"{sorted(backbones)}")
        if not known:
            for name, art in backbones.items():
                self._register_view(tenant, name, art, None)
        with self._lock:
            self._tenant_names[tenant] = default
        return tenant

    def resolve(self, tenant: str, artifact: Optional[str] = None) -> str:
        """Map (tenant, optional backbone name) to the namespaced artifact
        name the engine serves.  Unknown tenants raise — admission control
        must never silently create namespaces."""
        with self._lock:
            default = self._tenant_names.get(tenant)
        if default is None:
            raise KeyError(f"unknown tenant {tenant!r}; add_tenant() first "
                           f"(have {sorted(self._tenant_names)})")
        backbone = artifact or default
        name = f"{tenant}{SEP}{backbone}"
        with self._lock:
            known = name in self._artifacts
            have = tuple(sorted(self._backbones))
        if not known:
            raise KeyError(f"tenant {tenant!r} has no artifact "
                           f"{backbone!r}; have {have}")
        return name

    def set_tenant_default(self, tenant: str, backbone: str) -> None:
        """Hot-swap which backbone a tenant's anonymous requests hit —
        per-tenant bit-width A/B on top of the shared registry."""
        self.resolve(tenant, backbone)          # validates both halves
        with self._lock:
            self._tenant_names[tenant] = backbone

    def tenants(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._tenant_names))

    def backbone_names(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._backbones))

    def tenant_store(self, tenant: str,
                     artifact: Optional[str] = None) -> PrototypeStore:
        """The private store behind a tenant view (test/introspection hook
        for the bit-for-bit contract)."""
        return self.get(self.resolve(tenant, artifact)).store
