"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``, and importing
the port builds nothing."""

import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
assert not [m for m in sys.modules if m.startswith("repro_torch.")], \
    "import repro_torch must be lazy"
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"repro_torch.kernels.qmatmul", "repro_torch.models.lm",
        "repro_torch.launch.serve", "repro_torch.configs.qwen2_5_3b",
        "repro_torch.configs.lm_tiny", "repro_torch.serve.decode",
        "repro_torch.serve.cluster.cluster",
        "repro_torch.serve.cluster.sharded",
        "repro_torch.serve.cluster.tenancy", "repro_torch.dist.sharding",
        "repro_torch.dist.act_sharding", "repro_torch.obs.summarize",
        "repro_torch.configs.resnet9_paper", "repro_torch.dist.dtensor",
        "repro_torch.dist.pipeline", "repro_torch.launch.mesh",
        "repro_torch.launch.specs", "repro_torch.launch.dryrun",
        "repro_torch.launch.hlo_analysis", "repro_torch.launch.diagnose",
        "repro_torch.obs.hlo", "repro_torch.obs.diagnose"} <= set(mods)
import torch.distributed as dist
assert not dist.is_initialized(), "importing the port started a group"
from repro_torch.models.common import get_config
get_config("qwen2.5-3b"), get_config("lm-tiny"), get_config("resnet9-paper")
from repro_torch.fsl import FSLPipeline
from repro_torch.core import compile_graph, PassManager
from repro_torch.core.recipes import recipe
recipe("lm-decode").workload_hooks("decode")
repro_torch.compile, repro_torch.QuantConfig, repro_torch.FixedPointSpec
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(mods), bad)
"""


def test_import_pulls_in_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 35 and bad == "[]", out.stdout


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                        r"|import\s+repro\.|from\s+repro\.|from\s+repro\s)",
                        re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "tools/dist_smoke.py", "tools/time_head.py"]))
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), f"{path} imports jax or repro"


def test_kernel_build_is_lazy():
    """Importing the kernel modules neither calls nvcc nor loads a library
    (the CPU tests import every module on machines without CUDA)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import repro_torch.kernels.ops, repro_torch.kernels.build as B; "
         "print(B._LIBRARY is None)"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "True", out.stderr


def test_dryrun_import_starts_no_process_group():
    """The fake group of the dry run is started by ``main()`` alone:
    importing the dry run, its analysis and the meshes starts no group
    and builds no mesh."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import repro_torch.launch.dryrun, repro_torch.obs.diagnose, "
         "repro_torch.launch.mesh, repro_torch.launch.diagnose; "
         "import torch.distributed as d; print(d.is_initialized())"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0 and out.stdout.strip() == "False", out.stderr
