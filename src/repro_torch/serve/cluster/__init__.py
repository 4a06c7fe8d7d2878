"""repro_torch.serve.cluster — multi-tenant serving on the card, warmed
through a persistent compile cache.

Counterpart of the JAX package's ``repro.serve.cluster``::

    from repro_torch.ckpt import CompileCache
    from repro_torch.serve.cluster import (ServeCluster, TenantRegistry,
                                           sharded_tenant_registry)

    reg = sharded_tenant_registry()          # one card: the serial head
    reg.register_backbone("w6a4-int", pipe.deploy(params, datapath="int"),
                          default=True)
    cluster = ServeCluster(reg, replicas=2, tenant_quota=0.25,
                           compile_cache=CompileCache("/var/cache/repro"))
    cluster.add_tenant("acme")
    cluster.warmup(img=32)       # capture; checked against the cache's records
    cluster.submit_register("acme", "pelican", shots).result()
    cluster.submit_classify("acme", frame).result()

* **Tenancy** (`tenancy.py`): per-tenant namespaces + private prototype
  stores over shared compiled backbones; per-tenant admission quotas
  surface as :class:`~repro_torch.serve.engine.TenantOverQuota`.
* **Sharding** (`sharded.py`): the NCM head that would split prototype
  rows across devices; on one device (the only case ported) it is the
  serial head, bit for bit.
* **Cold start** (`cluster.py` + `repro_torch/ckpt/compile_cache.py`):
  replica warmup publishes, or on a restart checks, one warm record per
  bucket, keyed by content hash of (graph, datapath, bucket shape, device,
  torch/CUDA version, kernel sources).  A CUDA graph cannot be serialized,
  so a restarted replica captures again; its first replay must match the
  record.
"""

from repro_torch.serve.cluster.cluster import (ServeCluster,
                                               sharded_tenant_registry)
from repro_torch.serve.cluster.sharded import ShardedNCMHead, ShardedStore
from repro_torch.serve.cluster.tenancy import TenantRegistry
from repro_torch.serve.engine import TenantOverQuota

__all__ = ["ServeCluster", "ShardedNCMHead", "ShardedStore",
           "TenantOverQuota", "TenantRegistry", "sharded_tenant_registry"]
