"""The port's dry run (``launch/dryrun.py``, ``obs/hlo.py``) on the CPU.

Every case runs in a subprocess, so a ``"fake"`` process group (and the
reference's ``XLA_FLAGS`` of ``repro.launch.dryrun``) never leaks into the
test process:

* the reference's ``test_mini_dryrun_8dev`` on the port: reduced
  ``grok-1-314b`` train step on a 4x2 mesh of 8 fake ranks, dot FLOPs,
  collective bytes and argument bytes all > 0;
* at world 1 the per-device dot FLOPs of a reduced dense forward equal a
  hand count of 2·ΣM·K·N;
* ``apply_variant`` gives the reference's notes, serving bits, config
  overrides and rule specs for every lever;
* a CLI run writes an artifact with the reference's keys.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_py(args, timeout: int = 300) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "2"
    if isinstance(args, str):
        args = ["-c", textwrap.dedent(args)]
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, f"stderr:\n{r.stderr[-3000:]}"
    return r.stdout


def test_mini_dryrun_8dev():
    out = run_py("""
        import torch
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.dist.sharding import (tree_batch_shardings,
            tree_opt_shardings, tree_param_shardings)
        from repro_torch.launch import dryrun as DR, specs as S
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models.common import get_config
        from repro_torch.models.testing import reduce_config
        from repro_torch.obs import hlo
        from repro_torch.optim import adamw_init

        DR.fake_group(8)
        cfg = reduce_config(get_config("grok-1-314b"), grad_accum=2,
                            moe_capacity_factor=1.25)
        mesh = init_device_mesh("cpu", (4, 2),
                                mesh_dim_names=("data", "model"))
        psds = S.param_specs(cfg)
        params = DR.place(psds, tree_param_shardings(psds, mesh))
        opt = adamw_init(params)
        meta = lambda: torch.empty((2, 4, 16), dtype=torch.int32,
                                   device="meta")
        bsds = {"tokens": meta(), "labels": meta()}
        batch = DR.place(bsds, tree_batch_shardings(bsds, mesh))
        arg_bytes = DR.local_bytes(params, opt, batch)
        step = make_train_step(
            cfg, acc_shardings=tree_opt_shardings(psds, mesh))
        _, log = DR.trace_step(step, params, opt, batch)
        res = hlo.analyze(log)
        assert arg_bytes > 0
        assert res["dot_flops"] > 0, "no dots recorded"
        total = sum(res["collective_bytes"].values())
        assert total > 0, "sharded MoE train must communicate"
        assert hlo.top_dots(log, 3) and hlo.top_collectives(log, 3)
        print("MINI_DRYRUN_OK", res["dot_flops"], total, arg_bytes)
    """)
    assert "MINI_DRYRUN_OK" in out


def test_world1_dot_flops_equal_hand_count():
    out = run_py("""
        import torch
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.dist.sharding import (tree_batch_shardings,
            tree_param_shardings)
        from repro_torch.launch import dryrun as DR
        from repro_torch.models import lm
        from repro_torch.models.common import get_config
        from repro_torch.models.testing import reduce_config
        from repro_torch.obs import hlo

        DR.fake_group(1)
        cfg = reduce_config(get_config("qwen2.5-3b"))
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        params = lm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        B, S = 2, 16
        batch = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
        dp = DR.place(params, tree_param_shardings(params, mesh))
        db = DR.place(batch, tree_batch_shardings(batch, mesh))
        _, log = DR.trace_step(lambda p, b: lm.forward(p, b, cfg), dp, db)
        d, H, KV, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.hd, cfg.d_ff)
        T = B * S
        layer = (2 * T * d * H * hd + 2 * 2 * T * d * KV * hd
                 + 2 * T * H * hd * d            # q, k, v, o
                 + 2 * 2 * B * H * S * S * hd    # scores, mix
                 + 3 * 2 * T * d * f)            # gate, up, down
        want = cfg.n_layers * layer + 2 * T * d * cfg.vocab_padded
        got = hlo.analyze(log)["dot_flops"]
        assert got == want, (got, want)
        print("HAND_COUNT_OK", got)
    """)
    assert "HAND_COUNT_OK" in out


def test_apply_variant_notes_equal_reference():
    out = run_py("""
        import dataclasses, types
        import jax
        from repro.launch import dryrun as JD
        from repro.models.common import get_config as jget
        from repro_torch.launch import dryrun as TD
        from repro_torch.models.common import get_config

        levers = ["", "base", "w8", "w4", "sp", "seqsp", "nologitsp",
                  "noremat", "accum4", "chunk512", "mesh32x8", "epmodel",
                  "epdispatch", "epdispatchdata", "rematsave", "gradbf16",
                  "cachequant", "nofsdp", "attnsp", "headshard",
                  "w8+sp+noremat+nofsdp"]
        n = 0
        for axes in (("data", "model"), ("pod", "data", "model")):
            jmesh = jax.make_mesh((1,) * len(axes), axes)
            tmesh = types.SimpleNamespace(mesh_dim_names=axes)
            for arch in ("qwen2.5-3b", "grok-1-314b"):
                for v in levers:
                    jc, jb, jr, jn = JD.apply_variant(jget(arch), v, jmesh)
                    tc, tb, tr, tn = TD.apply_variant(get_config(arch), v,
                                                      tmesh)
                    assert tn == jn, (v, tn, jn)
                    assert tb == jb, v
                    for f in ("remat", "grad_accum", "prefill_chunk",
                              "remat_policy"):
                        assert getattr(tc, f) == getattr(jc, f), (v, f)
                    assert {k: r.spec for k, r in tr.items()} == \\
                        {k: tuple(r.spec) for k, r in jr.items()}, v
                    n += 1
            for mod, mesh in ((JD, jmesh), (TD, tmesh)):
                try:
                    mod.apply_variant(get_config("qwen2.5-3b"), "bogus",
                                      mesh)
                    raise SystemExit("no error for an unknown lever")
                except ValueError as e:
                    assert "unknown variant component 'bogus'" in str(e)
        print("VARIANTS_OK", n)
    """)
    assert "VARIANTS_OK 84" in out


def test_cli_writes_artifact_with_reference_keys(tmp_path):
    out = run_py(["-m", "repro_torch.launch.dryrun", "--arch", "lm-tiny",
                  "--shape", "decode_32k", "--out", str(tmp_path)])
    assert "1 ok, 0 skipped, 0 FAILED" in out
    with open(tmp_path / "lm-tiny__decode_32k__16x16__base.json") as f:
        art = json.load(f)
    # the reference's artifact keys (src/repro/launch/dryrun.py lower_cell);
    # flops_once_through, bytes_total and collectives_once_through come
    # from XLA's compiled module and have no counterpart in a dispatch log
    ref_keys = {"arch", "shape", "variant", "multi_pod", "mesh", "status",
                "kind", "n_devices", "flops_once_through", "bytes_total",
                "dot_flops_per_device", "collective_bytes_per_device",
                "collective_counts", "memory_analysis",
                "collectives_once_through", "n_params", "n_active_params",
                "lower_s", "compile_s", "notes"}
    assert set(art) <= ref_keys
    assert ref_keys - set(art) == {"flops_once_through", "bytes_total",
                                   "collectives_once_through"}
    assert art["status"] == "ok" and art["n_devices"] == 256
    assert art["mesh"] == {"data": 16, "model": 16}
    assert art["dot_flops_per_device"] > 0
    assert art["memory_analysis"]["argument_size_in_bytes"] > 0
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"]
    assert sorted(art["collective_bytes_per_device"]) == sorted(kinds)
    assert sorted(art["collective_counts"]) == sorted(kinds)
    assert sum(art["collective_bytes_per_device"].values()) > 0
