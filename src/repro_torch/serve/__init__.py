"""repro_torch.serve — real-time few-shot serving on the card.

The port's counterpart of the JAX package's ``repro.serve``::

    from repro_torch.serve import ArtifactRegistry, ServeEngine

    reg = ArtifactRegistry()
    reg.register("w6a4-int", pipe.deploy(params, datapath="int"),
                 default=True)
    with ServeEngine(reg, max_batch=64) as eng:
        eng.warmup(img=32)                        # one CUDA graph per bucket
        eng.submit_register("pelican", shots).result()   # novel class, live
        print(eng.submit_classify(frame).result().class_ids)
        print(eng.metrics.report())

``ServeEngine`` coalesces register/classify traffic into bucket-padded
batches (after warmup every batch replays a captured graph: no capture and
no eager run under load), ``PrototypeStore`` keeps online class means
bit-for-bit equal to offline NCM, and ``ArtifactRegistry`` serves several
bit-width artifacts side by side with atomic default hot-swap.  On the CPU
(``FSLPipeline(..., device="cpu")``) the same engine runs the plain
versions eagerly.

The engine's second workload is greedy LM decode: ``build_decode_artifact``
compiles a decoder through the ``lm-decode`` recipe into a
``DecodeArtifact`` (one CUDA graph per batch x KV-capacity bucket), served
through ``DecodeAdapter``::

    art = build_decode_artifact(params, get_config("lm-tiny"))
    reg.register("lm-int", art, adapter=DecodeAdapter(), default=True)
    print(greedy_generate(eng, [[5, 11, 2]], 8))
"""

from repro_torch.serve.bucketing import bucket_for, pad_to_bucket, pow2_buckets
from repro_torch.serve.decode import (
    DecodeAdapter,
    DecodeArtifact,
    DecodeResult,
    PrefillResult,
    build_decode_artifact,
    greedy_generate,
)
from repro_torch.serve.engine import (
    ClassifyResult,
    ServeEngine,
    ServeOverload,
    TenantOverQuota,
)
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import ArtifactRegistry, ServedArtifact
from repro_torch.serve.store import PrototypeStore
from repro_torch.serve.workload import ArtifactAdapter, FSLAdapter, RequestKind

__all__ = ["ArtifactAdapter", "ArtifactRegistry", "ClassifyResult",
           "DecodeAdapter", "DecodeArtifact", "DecodeResult", "FSLAdapter",
           "PrefillResult", "PrototypeStore", "RequestKind", "ServeEngine",
           "ServeMetrics", "ServeOverload", "ServedArtifact",
           "TenantOverQuota", "bucket_for", "build_decode_artifact",
           "greedy_generate", "pad_to_bucket", "pow2_buckets"]
