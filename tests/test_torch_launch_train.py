"""``python -m repro_torch.launch.train`` on the CPU, and checkpoints across
the two packages' launchers.

* the reference's smoke shape (``--arch qwen2.5-3b --reduced --steps 3
  --batch 2 --seq 16``) runs with ``--device cpu``, as a function and as a
  module, printing the reference's lines and returning the final loss;
* without ``--device`` and without a card it raises;
* a checkpoint written by ``repro.launch.train.main`` resumes in the
  port, whose next loss is within rtol 1e-5 of the JAX launcher resumed
  from the same directory (the same parameters and batch: the loss is a
  forward), and one written by the port resumes in the JAX launcher;
* the straggler monitor's evict verdict saves a checkpoint.

The reference's launcher builds its mesh with ``jax.make_mesh``, whose
axes default to explicit sharding in jax 0.9, where its embedding gather
raises ``ShardingTypeError`` on one device.  The JAX runs here pass
``axis_types=Auto`` through a patched ``jax.make_mesh``, the launcher's
own code unchanged.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.launch import train as JT  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
SMOKE = ["--arch", "qwen2.5-3b", "--reduced", "--batch", "2", "--seq", "16"]


@pytest.fixture
def auto_mesh(monkeypatch):
    make_mesh = jax.make_mesh
    monkeypatch.setattr(jax, "make_mesh", lambda shape, names, **kw: make_mesh(
        shape, names, axis_types=(AxisType.Auto,) * len(shape)))


def test_cli_runs_on_the_cpu(capsys, tmp_path):
    loss = TT.main(SMOKE + ["--steps", "3", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out.splitlines()
    assert isinstance(loss, float) and np.isfinite(loss)
    assert [ln.split(" loss ")[0] for ln in out] == ["step    0",
                                                     "step    2"]
    assert out[-1].startswith(f"step    2 loss {loss:.4f} (")
    meta = json.loads((tmp_path / "step_0000000002" / "meta.json").read_text())
    assert meta == {"step": 2, "mesh": [1, 1], "arch": "qwen2.5-3b"}
    # the same run again: the same loss (a pure function of the seed)
    again = TT.main(SMOKE + ["--steps", "3", "--device", "cpu"])
    assert again == loss


def test_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *SMOKE, "--steps",
         "2", "--device", "cpu"], capture_output=True, text=True, timeout=300,
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("step    1 loss ")


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.main(SMOKE + ["--steps", "1"])


def _last_loss(out: str) -> float:
    return float(out.strip().splitlines()[-1].split(" loss ")[1].split()[0])


def test_jax_checkpoint_resumes_in_the_port(auto_mesh, capsys, tmp_path):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    JT.main(SMOKE + ["--steps", "2"] + ck)
    capsys.readouterr()
    meta = json.loads((tmp_path / "step_0000000002" / "meta.json").read_text())
    assert meta == {"step": 2, "mesh": [1, 1], "arch": "qwen2.5-3b"}
    port = TT.main(SMOKE + ["--steps", "1", "--resume", "--device", "cpu"]
                   + ck)
    out = capsys.readouterr().out
    assert out.startswith("resumed from step 2\n") and "step    2 loss" in out
    ref = JT.main(SMOKE + ["--steps", "1", "--resume"] + ck)
    out = capsys.readouterr().out
    assert out.startswith("resumed from step 2\n")
    np.testing.assert_allclose(port, ref, rtol=1e-5)
    np.testing.assert_allclose(_last_loss(out), ref, atol=5e-5)


def test_port_checkpoint_resumes_in_jax(auto_mesh, capsys, tmp_path):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    TT.main(SMOKE + ["--steps", "2", "--device", "cpu"] + ck)
    port = TT.main(SMOKE + ["--steps", "1", "--resume", "--device", "cpu"]
                   + ck)
    ref = JT.main(SMOKE + ["--steps", "1", "--resume"] + ck)
    assert "resumed from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(port, ref, rtol=1e-5)


def test_resume_continues_the_run(tmp_path):
    """2 steps, a checkpoint, a resume, 1 step == 3 steps straight."""
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    straight = TT.main(SMOKE + ["--steps", "3", "--device", "cpu"])
    TT.main(SMOKE + ["--steps", "2", "--device", "cpu"] + ck)
    resumed = TT.main(SMOKE + ["--steps", "1", "--resume", "--device",
                               "cpu"] + ck)
    assert resumed == straight


def test_straggler_evict_saves_a_checkpoint(monkeypatch, capsys, tmp_path):
    class Evicting(TT.StragglerMonitor):
        def observe(self, step, duration_s):
            super().observe(step, duration_s)
            return "evict" if step == 1 else None

    monkeypatch.setattr(TT, "StragglerMonitor", Evicting)
    TT.main(SMOKE + ["--steps", "2", "--device", "cpu", "--ckpt-dir",
                     str(tmp_path), "--ckpt-every", "100"])
    assert "step 1: straggler evict policy fired" in capsys.readouterr().out
    meta = json.loads((tmp_path / "step_0000000001" / "meta.json").read_text())
    assert meta == {"step": 1, "reason": "straggler-evict"}
