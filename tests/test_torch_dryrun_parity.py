"""The dry run's per-device numbers against the reference's, on the mini
cell both packages' tests run (``tests/test_multidevice.py``'s
``test_mini_dryrun_8dev`` and ``tests/test_torch_dryrun.py``'s): reduced
``grok-1-314b`` (2 layers, d 64, 4 heads over 2 KV heads of 16, d_ff 96,
4 experts top-2, vocab 97 padded to 128), train step at grad_accum 2,
capacity factor 1.25, on a 4x2 ``("data", "model")`` mesh, batch
(2, 4, 16).  The reference compiles the step for 8 host devices and reads
the partitioned HLO; the port traces it over meta shards of 8 fake ranks.
Both run in subprocesses, side by side.

Per device, dot FLOPs: both equal the hand count of the step (every
product split evenly over the 8 devices, but the head, which both
packages replicate over ``model``).  The port's MoE runs expert-parallel
(each data rank holds one expert's slots and bank) and puts a product's
output gradient back in the output's layout, so no weight gradient is
computed whole on both ``model`` ranks; the causal scan's count (the
reference counts every kv block, the port the blocks up to each group's
last diagonal) is 0 here: S 16 is 2 chunks, so both take plain attention.

Collective bytes, kind by kind: both pinned.  The reference splits
contractions over ``data`` (the experts' d, the FSDP weights' input dim)
and all-reduces partial sums; its one all-to-all brings the backward's
tokens to the experts.  The port splits no contraction: it gathers every
dense weight along its input dim (FSDP) and each product's input along K,
moves the MoE buffer by all-to-all over ``data`` (dispatch, combine, and
each expert bank into the buffer's layout), and reduce-scatters gradients
back to their shards.  Every byte of the port's is tallied from its calls
by cause (each collective's innermost port frame: of the forward call, or
of the forward call that made the backward node) and each cause is pinned;
the MoE ones, the FSDP gathers and the activations made whole along K are
sized by hand.  DTensor's shard-to-shard redistribution is recorded as one
all-to-all of its input's bytes (on this CPU mesh DTensor runs an
all-gather and a chunk there, which is not recorded), and those bytes
equal the ``shard_dim_alltoall`` calls' tally.  The ratio of the totals is
held in a band.

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
import json, re, traceback
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

tally = {"a2a_calls": 0, "a2a_bytes": 0}

alltoall = PT.shard_dim_alltoall
def counted_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    tally["a2a_calls"] += 1
    tally["a2a_bytes"] += input.numel() * input.element_size()
    return alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
PT.shard_dim_alltoall = counted_alltoall

FRAME = re.compile(r'File "([^"]+)", line (\\d+), in (\\w+)')

# the port's frames (file, function), innermost first: of this call, or,
# in a backward, of the forward call that made the node
def frames():
    node = torch._C._current_autograd_node()
    if node is None:
        fs = [(f.filename, f.name) for f in traceback.extract_stack()]
    else:
        tb = node.metadata.get("traceback_", [])
        fs = [(f, n) for f, _, n in FRAME.findall("".join(tb))]
    return [(f.rsplit("/", 1)[-1], n) for f, n in fs[::-1]
            if "/repro_torch/" in f and not f.endswith("obs/hlo.py")
            and n not in ("_replicate_where", "reduce_partial", "<genexpr>")]

CAUSES = {
    "experts_on": "moe banks to the experts' layout",
    "grad_as_value": "product output gradients to their layout",
    "combine": {"all-to-all": "moe combine",
                "all-gather": "moe output gradient to its d shards"},
    "__init__": {"all-to-all": "moe dispatch",
                 "all-gather": "moe slot counts",
                 "all-reduce": "moe buffer gradient"},
    "moe_route": "router softmax and top-k",
    "rmsnorm": "rmsnorm over sharded d",
    "_lookup": "embedding rows",
    "_gold": "gold logits",
    "like": "accumulation reshards",
    "clip_by_global_norm": "gradient norm",
    "loss_fn": "log-sum-exp over vocab-sharded logits",
    "_step": "loss mean",
    "moe": "moe aux loss",
}

def cause(e):
    fs = frames()
    for i, (f, n) in enumerate(fs):
        if n == "unshard":
            two_d = e.sig.count("x") == 1
            caller = fs[i + 1][1]
            if caller == "dense":
                return ("FSDP weight gathers" if two_d
                        else "activations along K")
            if caller == "moe":
                return "moe tokens along d" if two_d else "moe h along f"
            return CAUSES[caller]
        if n in CAUSES and (n != "__init__" or f == "dtensor.py"):
            what = CAUSES[n]
            return what[e.kind] if isinstance(what, dict) else what
    return "other"

class Events(list):
    def append(self, e):
        super().append(e)
        if e.kind != "dot":
            key = f"{e.kind}: {cause(e)}"
            causes[key] = causes.get(key, 0) + e.value

class Record(hlo.DispatchRecord):
    def __init__(self):
        super().__init__()
        self.events = Events()

causes = {}
hlo.DispatchRecord = Record
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
# anomaly mode keeps each backward node's forward traceback
with torch.autograd.set_detect_anomaly(True, check_nan=False):
    _, log = DR.trace_step(step, params, opt, batch)
res = hlo.analyze(log)
print("RESULT", json.dumps({"dot_flops": res["dot_flops"],
                            "collective_bytes": res["collective_bytes"],
                            "tally": tally, "causes": causes}))
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
# no weight gradient is computed whole on both "model" ranks any more:
# the MoE banks' (their buffer sharded by expert) and wo's (its output
# gradient back in its output's layout)
GAP_MOE_DW = 0
GAP_WO_DW = 0
GAP_CAUSAL_SCAN = 0              # S = 2 chunks: no chunked attention
PORT_FLOPS = REF_FLOPS + GAP_MOE_DW + GAP_WO_DW + GAP_CAUSAL_SCAN
# FSDP: each dense weight gathered along its input dim, once a microbatch
# (the attention projections' and the router's a layer, the head's once);
# their gradients reduce-scattered back to a quarter of it
GAP_WEIGHT_GATHERS = 4 * (A * L_ * (d * H * hd // MODEL * 2
                                    + d * KV * hd // MODEL * 2
                                    + d * E // MODEL)
                          + A * d * VP)
F32, BF16 = 4, 2
# each product's input made whole along K over "model": the three
# projections' float32 h and the head's x, and wo's bf16 attention output
GAP_ACT_GATHERS = (A * (3 * L_ + 1) * T * d * F32
                   + A * L_ * T * H * hd * BF16)
# the MoE layer, A * L_ times a step, forward and backward
MB = A * L_
MOE_BYTES = {
    # each rank's (E, C, d) buffer, forward and backward
    "all-to-all: moe dispatch": 2 * MB * E * C * d * F32,
    # the inverse, on d's halves over "model"
    "all-to-all: moe combine": 2 * MB * E * C * d // MODEL * F32,
    # w_gate, w_up, w_down: d_in over "data" -> experts over "data", and
    # their gradients back
    "all-to-all: moe banks to the experts' layout":
        2 * MB * 3 * E * d * f // (DATA * MODEL) * F32,
    "all-gather: moe slot counts": MB * DATA * E * 4,
    "all-gather: moe tokens along d": MB * T * d * F32,
    "reduce-scatter: moe tokens along d": MB * T * d // MODEL * F32,
    "all-gather: moe h along f": MB * E // DATA * C * f * F32,
    "reduce-scatter: moe h along f": MB * E // DATA * C * f // MODEL * F32,
    # the buffer's gradient, partial over "model" (the f-split products)
    "all-reduce: moe buffer gradient": MB * E // DATA * C * d * F32,
    "all-gather: moe output gradient to its d shards": MB * T * d * F32,
}

REF_BYTES = {"all-reduce": 948532.0, "all-gather": 681600.0,
             "reduce-scatter": 0.0, "all-to-all": 32768.0,
             "collective-permute": 267392.0}
PORT_BYTES = {"all-reduce": 42772.0, "all-gather": 427008.0,
              "reduce-scatter": 164352.0, "all-to-all": 852480.0,
              "collective-permute": 0.0}
# every byte of the port's, by kind and cause (tallied from the calls)
PORT_CAUSES = {
    **MOE_BYTES,
    "all-gather: FSDP weight gathers": GAP_WEIGHT_GATHERS,
    "reduce-scatter: FSDP weight gathers": GAP_WEIGHT_GATHERS // DATA,
    "all-gather: activations along K": GAP_ACT_GATHERS,
    "reduce-scatter: activations along K": GAP_ACT_GATHERS // MODEL,
    # DTensor's placements of the rest, pinned as tallied
    "all-to-all: rmsnorm over sharded d": 61440,
    "all-to-all: product output gradients to their layout": 4608,
    "all-gather: embedding rows": 65536,
    "reduce-scatter: embedding rows": 49152,
    "all-gather: log-sum-exp over vocab-sharded logits": 32768,
    "all-gather: rmsnorm over sharded d": 1280,
    "reduce-scatter: rmsnorm over sharded d": 640,
    "all-gather: router softmax and top-k": 1024,
    "reduce-scatter: router softmax and top-k": 1408,
    "all-gather: accumulation reshards": 512,
    "all-reduce: accumulation reshards": 1536,
    "all-reduce: gold logits": 128,
    "all-reduce: moe aux loss": 128,
    "all-reduce: gradient norm": 16,
    "all-reduce: loss mean": 4,
}
A2A_CALLS = 78                   # shard_dim_alltoall calls in the step
RATIO_BAND = (0.6, 0.9)          # port / reference, all collective bytes


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
    assert port["dot_flops"] == PORT_FLOPS == 13221888
    assert port["collective_bytes"] == PORT_BYTES


def test_dot_flops_gap_is_the_named_weight_gradients(cells):
    """The port's dot FLOPs are the reference's: neither weight gradient
    that was computed whole on both ``model`` ranks is any more."""
    ref, port = cells
    assert (GAP_MOE_DW, GAP_WO_DW) == (0, 0)
    assert port["dot_flops"] - ref["dot_flops"] == GAP_MOE_DW + GAP_WO_DW
    assert port["dot_flops"] == ref["dot_flops"] == REF_FLOPS


def test_collective_gaps_sized(cells):
    ref, port = cells
    causes = port["causes"]
    assert causes == {k: float(v) for k, v in PORT_CAUSES.items()}
    assert "other" not in {k.split(": ", 1)[1] for k in causes}
    # every recorded byte has its cause, kind by kind
    for kind in KINDS:
        assert sum(v for k, v in causes.items()
                   if k.startswith(kind + ": ")) == PORT_BYTES[kind], kind
    assert GAP_WEIGHT_GATHERS == 165888 and GAP_ACT_GATHERS == 65536
    ratio = (sum(port["collective_bytes"].values())
             / sum(ref["collective_bytes"].values()))
    assert RATIO_BAND[0] <= ratio <= RATIO_BAND[1], ratio
    assert RATIO_BAND[1] - RATIO_BAND[0] <= 0.5 and RATIO_BAND[1] < 2.2275


def test_moe_collectives_hand_counted(cells):
    _, port = cells
    assert MOE_BYTES == {
        "all-to-all: moe dispatch": 327680,
        "all-to-all: moe combine": 163840,
        "all-to-all: moe banks to the experts' layout": 294912,
        "all-gather: moe slot counts": 256,
        "all-gather: moe tokens along d": 16384,
        "reduce-scatter: moe tokens along d": 8192,
        "all-gather: moe h along f": 61440,
        "reduce-scatter: moe h along f": 30720,
        "all-reduce: moe buffer gradient": 40960,
        "all-gather: moe output gradient to its d shards": 16384}
    for k, v in MOE_BYTES.items():
        assert port["causes"][k] == v, k


def test_alltoall_is_the_shard_dim_alltoall_calls(cells):
    """Each ``shard_dim_alltoall`` is one all-to-all of its input's bytes,
    and nothing of DTensor's CPU fallback (an all-gather and a chunk) is
    recorded: every all-gather byte has a cause of the port's own."""
    _, port = cells
    tally = port["tally"]
    assert tally["a2a_calls"] == A2A_CALLS
    assert tally["a2a_bytes"] == port["collective_bytes"]["all-to-all"] > 0
    gathered = sum(v for k, v in PORT_CAUSES.items()
                   if k.startswith("all-gather: "))
    assert gathered == port["collective_bytes"]["all-gather"]


if __name__ == "__main__":
    ref, port = (_result(p) for p in (_start(REF, xla_devices=8),
                                      _start(PORT)))
    print(f"dot FLOPs per device: reference {ref['dot_flops']:.0f}, port "
          f"{port['dot_flops']:.0f} (x{port['dot_flops'] / ref['dot_flops']:.4f})")
    for k in KINDS:
        print(f"{k:>19}: reference {ref['collective_bytes'][k]:.0f} B, port "
              f"{port['collective_bytes'][k]:.0f} B")
        for c, v in sorted(port["causes"].items(), key=lambda kv: -kv[1]):
            if c.startswith(k + ": "):
                print(f"{'':>21}{c[len(k) + 2:]}: {v:.0f}")
    print(f"port: {port['tally']['a2a_calls']} shard_dim_alltoall calls, "
          f"{port['tally']['a2a_bytes']} B")
    tot = [sum(r["collective_bytes"].values()) for r in (ref, port)]
    print(f"all kinds: reference {tot[0]:.0f} B, port {tot[1]:.0f} B "
          f"(x{tot[1] / tot[0]:.4f})")
