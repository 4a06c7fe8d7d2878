"""Shared set-up of the benchmark's own CPU tests.

    PYTHONPATH=src python -m pytest -q portbench/tests

``tiny_root`` is a copy of ``BENCHMARK.json`` and ``portbench/`` in a
temporary directory with cells small enough for the CPU: width 8 (the
frames stay 32x32, the size the ``"resnet9"`` recipe compiles for),
batches of 4.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_CELLS = {
    "tiny-offline": ("resnet9-w6a4", "offline-b64"),
    "tiny16-offline": ("resnet9-w16a16", "offline-b64"),
}
TINY_TRAFFIC = {
    "offline-b64": dict(batch=4, resident_batches=2, ahead=2,
                        checked_calls=4, trace_calls=8),
}


def _dump(obj, path: Path) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_tiny(dst: Path) -> Path:
    """The copy, with one tiny configuration, mix and cell per entry of
    ``TINY_CELLS``; every metric listed for the model cell is listed for
    its tiny cell too."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    pb = dst / "portbench"
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    model_cell = {(w["config"], w["traffic"]): w["name"]
                  for w in bench["workloads"]}
    for name, (conf, mix) in TINY_CELLS.items():
        cfg = json.loads((pb / "configs" / f"{conf}.json").read_text())
        cfg.update(name=f"{name}-cfg", width=8)
        cfg["data"]["classes"] = 4
        _dump(cfg, pb / "configs" / f"{name}-cfg.json")
        tr = json.loads((pb / "traffic" / f"{mix}.json").read_text())
        tr.update(TINY_TRAFFIC[mix])
        _dump(tr, pb / "traffic" / f"{name}-mix.json")
        bench["configs"].append({
            "name": f"{name}-cfg", "source": "test",
            "file": f"portbench/configs/{name}-cfg.json",
            "reduced": ["width"], "why": "CPU test"})
        bench["workloads"].append({
            "name": name, "config": f"{name}-cfg", "traffic": f"{name}-mix",
            "chips": 1, "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if model_cell[(conf, mix)] in m.get("workloads", ()):
                m["workloads"].append(name)
    _dump(bench, dst / "BENCHMARK.json")
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("portbench"))
