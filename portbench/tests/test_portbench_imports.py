"""What the benchmark loads: never JAX, never the JAX package ``repro``.

A fresh interpreter runs a tiny cell of the harness on the CPU stub, then
lists the top-level names (the part before the first dot, compared whole)
of every module it has loaded: ``repro_torch`` is there, ``repro``,
``jax``, ``jaxlib`` and ``flax`` are not. The benchmark's files name
nothing under the repository's older harness folder.
"""

import json
import re
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from pathlib import Path
from portbench import harness
t0 = time.perf_counter()
rc = harness.main(["--workload", {cell!r}, "--seed", "2147483659",
                   "--seconds", "1", "--trace", {trace!r}],
                  lambda: time.perf_counter() - t0, stub=True,
                  root=Path({root!r}))
print(json.dumps({{"rc": rc, "top": sorted({{m.split(".")[0]
                                             for m in sys.modules}})}}))
"""


def _probe(root, cell, trace="0"):
    code = PROBE.format(src=str(ROOT / "src"), root=str(root), cell=cell,
                        trace=trace)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1])


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    for cell, trace in (("tiny-offline", "1"), ("tiny16-offline", "0")):
        result, probe = _probe(tiny_root, cell, trace)
        assert probe["rc"] == 0 and result["correct"] is True
        assert "repro_torch" in probe["top"]
        assert not {"jax", "jaxlib", "flax", "repro"} & set(probe["top"])


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_nothing_under_portbench_names_the_older_harness():
    older = "bench" + "marks"
    pat = re.compile(rf"(?<![\w/]){older}\b")
    hits = [str(p.relative_to(ROOT)) for p in (ROOT / "portbench").rglob("*")
            if p.is_file() and p.suffix in (".py", ".json", ".txt", ".md")
            and "out" not in p.relative_to(ROOT / "portbench").parts
            and pat.search(p.read_text())]
    assert hits == []
