"""The dry run's per-device numbers against the reference's, on the mini
cell both packages' tests run (``tests/test_multidevice.py``'s
``test_mini_dryrun_8dev`` and ``tests/test_torch_dryrun.py``'s): reduced
``grok-1-314b`` (2 layers, d 64, 4 heads over 2 KV heads of 16, d_ff 96,
4 experts top-2, vocab 97 padded to 128), train step at grad_accum 2,
capacity factor 1.25, on a 4x2 ``("data", "model")`` mesh, batch
(2, 4, 16).  The reference compiles the step for 8 host devices and reads
the partitioned HLO; the port traces it over meta shards of 8 fake ranks.
Both run in subprocesses, side by side.

Per device, dot FLOPs:

* the reference's equal the hand count of the step (every product split
  evenly over the 8 devices, but the head, which both packages replicate
  over ``model``);
* the port's are the reference's plus two weight gradients DTensor
  computes whole on both ``model`` ranks, where the reference splits
  them: the MoE gate and up banks' (their incoming gradient is
  replicated over ``model``) and the attention output projection's
  (likewise) -- exactly, by hand;
* the causal scan's count (the reference counts every kv block, the port
  the blocks up to each group's last diagonal) is 0 here: S 16 is 2
  chunks, so both take plain attention.

Collective bytes, kind by kind: both pinned.  The port gathers every
dense weight along its input dim before its product (FSDP; no contraction
split over ranks), which the hand count sizes exactly; on this CPU mesh
DTensor turns each shard-to-shard redistribution into an all-gather and a
chunk (gloo has no all-to-all), sized from the calls; the reference splits
contractions and all-reduces partial sums instead.  The ratio of the
totals is held in a band.

``python tests/test_torch_dryrun_parity.py`` prints the table.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

REF = """
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.dist.sharding import (tree_batch_shardings, tree_opt_shardings,
                                 tree_param_shardings)
from repro.launch import hlo_analysis
from repro.launch.steps import make_train_step
from repro.models import lm
from repro.models.common import get_config
from repro.models.testing import reduce_config
from repro.optim import adamw_init

cfg = reduce_config(get_config("grok-1-314b"), grad_accum=2,
                    moe_capacity_factor=1.25)
mesh = jax.make_mesh((4, 2), ("data", "model"))
params_sds = jax.eval_shape(lambda: lm.init_params(jax.random.PRNGKey(0),
                                                   cfg))
psh = tree_param_shardings(params_sds, mesh)
opt_sds = jax.eval_shape(lambda: adamw_init(params_sds))
osh = type(opt_sds)(step=NamedSharding(mesh, P()),
                    m=tree_opt_shardings(params_sds, mesh),
                    v=tree_opt_shardings(params_sds, mesh))
batch_sds = {"tokens": jax.ShapeDtypeStruct((2, 4, 16), jnp.int32),
             "labels": jax.ShapeDtypeStruct((2, 4, 16), jnp.int32)}
bsh = tree_batch_shardings(batch_sds, mesh)
compiled = jax.jit(make_train_step(cfg), in_shardings=(psh, osh, bsh),
                   out_shardings=(psh, osh, NamedSharding(mesh, P()))
                   ).lower(params_sds, opt_sds, batch_sds).compile()
res = hlo_analysis.analyze(compiled.as_text())
print("RESULT", json.dumps({"dot_flops": res["dot_flops"],
                            "collective_bytes": res["collective_bytes"]}))
"""

PORT = """
import json
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import placement_types as PT
from repro_torch.dist import dtensor as D
from repro_torch.dist.sharding import (tree_batch_shardings,
    tree_opt_shardings, tree_param_shardings)
from repro_torch.launch import dryrun as DR, specs as S
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import get_config
from repro_torch.models.testing import reduce_config
from repro_torch.obs import hlo
from repro_torch.optim import adamw_init

tally = {"weight_gathers": 0, "a2a_gathered": 0, "a2a_moved": 0}

def nbytes(t):
    t = t.to_local() if D.is_dtensor(t) else t
    return t.numel() * t.element_size()

unshard = D.unshard
def counted_unshard(x, dims):
    out = unshard(x, dims)
    if dims == (-2,) and out is not x:     # layers.dense's FSDP gather
        tally["weight_gathers"] += nbytes(out)
    return out
D.unshard = counted_unshard

alltoall = PT.shard_dim_alltoall
def counted_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    tally["a2a_gathered"] += nbytes(input) * mesh.size(mesh_dim)
    tally["a2a_moved"] += nbytes(input)
    return alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
PT.shard_dim_alltoall = counted_alltoall

DR.fake_group(8)
cfg = reduce_config(get_config("grok-1-314b"), grad_accum=2,
                    moe_capacity_factor=1.25)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
psds = S.param_specs(cfg)
params = DR.place(psds, tree_param_shardings(psds, mesh))
opt = adamw_init(params)
meta = lambda: torch.empty((2, 4, 16), dtype=torch.int32, device="meta")
bsds = {"tokens": meta(), "labels": meta()}
batch = DR.place(bsds, tree_batch_shardings(bsds, mesh))
step = make_train_step(cfg, acc_shardings=tree_opt_shardings(psds, mesh))
_, log = DR.trace_step(step, params, opt, batch)
res = hlo.analyze(log)
print("RESULT", json.dumps({"dot_flops": res["dot_flops"],
                            "collective_bytes": res["collective_bytes"],
                            "tally": tally}))
"""

# -- the cell, by hand -------------------------------------------------------
DATA, MODEL = 4, 2
L_, A = 2, 2                     # layers, microbatches
SEQS, S = 4, 16                  # a microbatch's sequences and their length
d, H, KV, hd, f, E, TOP_K, VP = 64, 4, 2, 16, 96, 4, 2, 128
T = SEQS * S // DATA             # tokens on a device
C = int(1.25 * TOP_K * SEQS * S / E)          # expert capacity, 40
ATTN_PROJ = 2 * T * d * (H + KV + KV + H) * hd // MODEL
SCORES = 2 * 2 * (SEQS // DATA) * (H // MODEL) * S * S * hd
ROUTER = 2 * T * d * E // MODEL
EXPERTS = 3 * 2 * E * C * d * f // (DATA * MODEL)
LAYER_FWD = ATTN_PROJ + SCORES + ROUTER + EXPERTS       # 970,752
HEAD_FWD = 2 * T * d * VP                                # whole on each rank
REF_FLOPS = A * (L_ * 3 * LAYER_FWD + 3 * HEAD_FWD)      # fwd + 2x in bwd
# the port's two weight gradients whole on both "model" ranks
GAP_MOE_DW = A * L_ * 2 * (2 * (E // DATA) * C * d * f
                           - 2 * E * C * d * f // (DATA * MODEL))
GAP_WO_DW = A * L_ * (2 * T * H * hd * d - 2 * T * H * hd * d // MODEL)
GAP_CAUSAL_SCAN = 0              # S = 2 chunks: no chunked attention
PORT_FLOPS = REF_FLOPS + GAP_MOE_DW + GAP_WO_DW + GAP_CAUSAL_SCAN
# FSDP: each dense weight gathered along its input dim, once a microbatch
# (the attention projections' and the router's a layer, the head's once)
GAP_WEIGHT_GATHERS = 4 * (A * L_ * (d * H * hd // MODEL * 2
                                    + d * KV * hd // MODEL * 2
                                    + d * E // MODEL)
                          + A * d * VP)

REF_BYTES = {"all-reduce": 948532.0, "all-gather": 681600.0,
             "reduce-scatter": 0.0, "all-to-all": 32768.0,
             "collective-permute": 267392.0}
PORT_BYTES = {"all-reduce": 43796.0, "all-gather": 3746560.0,
              "reduce-scatter": 509440.0, "all-to-all": 0.0,
              "collective-permute": 0.0}
A2A_GATHERED = 1662976           # the CPU fallback's all-gathers ...
A2A_MOVED = 450560               # ... for all-to-alls of this many bytes
RATIO_BAND = (2.0, 2.5)          # port / reference, all collective bytes


def _start(code: str, xla_devices: int = 0) -> subprocess.Popen:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "2"
    if xla_devices:
        env["XLA_FLAGS"] = \
            f"--xla_force_host_platform_device_count={xla_devices}"
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=ROOT)


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"stderr:\n{err[-3000:]}"
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def cells():
    ref, port = _start(REF, xla_devices=8), _start(PORT)
    return _result(ref), _result(port)


def test_reference_numbers_pinned_and_hand_counted(cells):
    ref, _ = cells
    assert LAYER_FWD == 970752 and C == 40
    assert ref["dot_flops"] == REF_FLOPS == 13221888
    assert ref["collective_bytes"] == REF_BYTES


def test_port_numbers_pinned(cells):
    _, port = cells
    assert port["dot_flops"] == PORT_FLOPS == 15450112
    assert port["collective_bytes"] == PORT_BYTES


def test_dot_flops_gap_is_the_named_weight_gradients(cells):
    ref, port = cells
    assert (GAP_MOE_DW, GAP_WO_DW) == (1966080, 262144)
    assert port["dot_flops"] - ref["dot_flops"] == GAP_MOE_DW + GAP_WO_DW
    assert port["dot_flops"] / ref["dot_flops"] == pytest.approx(
        1 + (GAP_MOE_DW + GAP_WO_DW) / REF_FLOPS, rel=1e-12)


def test_collective_gaps_sized(cells):
    ref, port = cells
    tally = port["tally"]
    assert tally["weight_gathers"] == GAP_WEIGHT_GATHERS == 165888
    assert (tally["a2a_gathered"], tally["a2a_moved"]) == (A2A_GATHERED,
                                                           A2A_MOVED)
    # over "data" (4 ranks) and "model" (2): between 2 and 4 times the bytes
    assert 2 * A2A_MOVED < A2A_GATHERED < DATA * A2A_MOVED
    # the gathers are a part of the port's all-gather bytes
    assert GAP_WEIGHT_GATHERS + A2A_GATHERED < PORT_BYTES["all-gather"]
    ratio = (sum(port["collective_bytes"].values())
             / sum(ref["collective_bytes"].values()))
    assert RATIO_BAND[0] <= ratio <= RATIO_BAND[1], ratio


if __name__ == "__main__":
    ref, port = (_result(p) for p in (_start(REF, xla_devices=8),
                                      _start(PORT)))
    print(f"dot FLOPs per device: reference {ref['dot_flops']:.0f}, port "
          f"{port['dot_flops']:.0f} (x{port['dot_flops'] / ref['dot_flops']:.4f})")
    print(f"  MoE gate/up weight gradients whole on both model ranks "
          f"+{GAP_MOE_DW}; wo's +{GAP_WO_DW}; causal scan "
          f"+{GAP_CAUSAL_SCAN}")
    for k in KINDS:
        print(f"{k:>19}: reference {ref['collective_bytes'][k]:.0f} B, port "
              f"{port['collective_bytes'][k]:.0f} B")
    print(f"port: FSDP weight gathers {port['tally']['weight_gathers']} B, "
          f"all-to-all fallback gathers {port['tally']['a2a_gathered']} B "
          f"for {port['tally']['a2a_moved']} B of all-to-all")
    tot = [sum(r["collective_bytes"].values()) for r in (ref, port)]
    print(f"all kinds: reference {tot[0]:.0f} B, port {tot[1]:.0f} B "
          f"(x{tot[1] / tot[0]:.4f})")
