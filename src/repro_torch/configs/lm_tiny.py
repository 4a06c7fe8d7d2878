"""lm-tiny [dense]: 2L, d=64, 4H, d_ff=96, vocab=97 (padded to 256), w8a8.

The compiled decode workload: a small dense decoder whose decode step fits
the integer datapath's f32-exact window at w8a8 (every matmul's reachable
accumulator stays far inside ±2^24), so the compiled int artifact is bit
for bit the interpreter's.  ``pos="none"`` because rotary position ids are
not graph ops; ``compute_dtype="float32"`` so the eager stack compares to
the f32 graph at a tight tolerance.  The JAX package's ``configs/lm_tiny.py``
at the same size.
"""

from repro_torch.core.quant import FixedPointSpec, QuantConfig
from repro_torch.models.common import ArchConfig, register

CONFIG = register(ArchConfig(
    name="lm-tiny",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab=97,                    # vocab_padded -> 256
    tie_embeddings=False,
    act="gelu",
    pos="none",
    max_seq=64,
    norm_eps=1e-6,
    quant=QuantConfig(weight=FixedPointSpec(8, 6, signed=True),
                      act=FixedPointSpec(8, 4, signed=True)),
    compute_dtype="float32",
    remat=False,
    prefill_chunk=8))
