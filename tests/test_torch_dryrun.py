"""Port parity, the dry run: repro_torch.launch.{op_analysis,dryrun}
against ``tests/test_dryrun.py``.

Each dry run is a process of its own (the fake process group is global to
a process), run by subprocess as the reference's tests run theirs:

  * ``op_analysis`` on the sample of ``test_hlo_analysis_on_sample``: a
    matmul in a 5-trip loop and an all-gather over a group of 4 on a
    2 x 4 fake mesh, with the same arithmetic;
  * the skip policy (deepseek-67b ``long_500k`` skipped, h2o-danube runs);
  * one fast cell through the CLI (mamba2-370m ``decode_32k`` on 8 ranks,
    batch 16): the reference's record keys, ``status == "ok"``;
  * the slow tier: the cells of ``tests/test_dryrun.py``, and the port's
    per-device flops within 10 % of the reference's ``analyze_hlo`` for
    the same cell (the reference's dry run in its own subprocess).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": f"{REPO}/src", "PATH": "/usr/bin:/bin:/usr/local/bin",
       "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def _python(code, timeout=300):
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                       text=True, timeout=timeout, cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def run_cell(arch, shape, mesh, tmp, extra=()):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--mesh", mesh, "--devices", "8", "--batch", "16", "--out", str(tmp), *extra]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=1500, cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    with open(f"{tmp}/{arch}_{shape}_{mesh}.json") as f:
        return json.load(f), r.stdout


#: the record keys the reference writes for an ``ok`` cell, less those that
#: have no meaning without XLA (``lower_s``, ``compile_s``)
RECORD_KEYS = {"arch", "shape", "mesh", "mesh_shape", "remat", "lean", "tag", "baseline",
               "status", "memory", "cost", "collectives", "collective_moved_bytes",
               "top_flops", "top_traffic", "n_chips", "model_params", "active_params",
               "wall_s"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "peak_bytes"}


def test_op_analysis_on_sample():
    """``test_hlo_analysis_on_sample`` eagerly: x (8, 16) @ w (16, 16) in a
    5-trip loop, and an all-gather of 2 rows over the 4-rank model group of
    a (data=2, model=4) fake mesh into (8, 16) f32 -- 512 bytes."""
    out = _python("""
        import json, torch, torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.launch.op_analysis import analyze_ops

        dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
        x, w = torch.randn(8, 16), torch.randn(16, 16)

        def step(x):
            for _ in range(5):
                d = x @ w
                x = funcol.all_gather_tensor(d[:2], 0, (mesh, 1)).wait()
            return x

        print(json.dumps(analyze_ops(step, x)[1]))
    """)
    r = json.loads(out.strip().splitlines()[-1])
    # dot: 2*8*16*16 = 4096 flops, x5 trips
    assert r["flops"] == 5 * 4096, r["flops"]
    ag = r["collectives"]["all-gather"]
    assert ag["count"] == 5
    # ring model: result 8*16*4 bytes * (4-1)/4 per execution
    assert abs(ag["moved_bytes"] - 5 * 512 * 0.75) < 1e-6
    assert r["collective_moved_bytes"] == ag["moved_bytes"]
    assert r["traffic_bytes"] > 0 and r["top_flops"][0][0] == "aten.mm"


def test_dryrun_skip_policy(tmp_path):
    out = _python(f"""
        import json
        from repro_torch.launch.dryrun import run_cell
        recs = [run_cell(a, "long_500k", "pod", devices=8, batch_override=16,
                         out_dir={str(tmp_path)!r})
                for a in ("deepseek-67b", "h2o-danube-3-4b")]
        print(json.dumps([r["status"] for r in recs]))
    """)
    # deepseek is quadratic at 500k; SWA is sub-quadratic
    assert json.loads(out.strip().splitlines()[-1]) == ["skipped", "ok"]


def test_dryrun_decode_cell_cli(tmp_path):
    rec, stdout = run_cell("mamba2-370m", "decode_32k", "pod", tmp_path)
    assert rec["status"] == "ok", rec.get("trace")
    assert set(rec) == RECORD_KEYS and set(rec["memory"]) == MEMORY_KEYS
    assert set(rec["cost"]) == {"flops", "bytes_accessed"}
    assert rec["mesh_shape"] == {"data": 4, "model": 2} and rec["n_chips"] == 8
    assert rec["cost"]["flops"] > 0 and rec["memory"]["peak_bytes"] > 0
    assert rec["collective_moved_bytes"] > 0 and "all-gather" in rec["collectives"]
    assert "80 GB" in stdout and "[dryrun] mamba2-370m" in stdout


def _reference_flops(arch, shape, mesh, tmp):
    """The reference's ``analyze_hlo`` flops for the cell, from its own dry
    run in a subprocess.  The reference's meshes are made with Auto axis
    types, as the jax it was written for made them."""
    env = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = textwrap.dedent(f"""
        import runpy, sys
        import jax
        from jax.sharding import AxisType
        make = jax.make_mesh
        jax.make_mesh = lambda s, a, **k: make(s, a, axis_types=(AxisType.Auto,) * len(a), **k)
        sys.argv = ["dryrun", "--arch", {arch!r}, "--shape", {shape!r}, "--mesh", {mesh!r},
                    "--devices", "8", "--batch", "16", "--out", {str(tmp)!r}]
        runpy.run_module("repro.launch.dryrun", run_name="__main__")
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=1500, cwd=REPO, env=env)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    with open(f"{tmp}/{arch}_{shape}_{mesh}.json") as f:
        return json.load(f)["cost"]["flops"]


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape,mesh", [("tinyllama-1.1b", "train_4k", "pod"),
                                             ("mamba2-370m", "decode_32k", "multipod")])
def test_dryrun_cells_match_reference_flops(tmp_path, arch, shape, mesh):
    rec, _ = run_cell(arch, shape, mesh, tmp_path / "port")
    assert rec["status"] == "ok", rec.get("trace")
    assert rec["memory"]["peak_bytes"] > 0 and rec["collective_moved_bytes"] > 0
    if mesh == "multipod":
        assert rec["mesh_shape"]["pod"] == 2
    else:
        assert rec["cost"]["flops"] > 1e13
        assert "all-gather" in rec["collectives"] or "all-reduce" in rec["collectives"]
    want = _reference_flops(arch, shape, mesh, tmp_path / "ref")
    assert abs(rec["cost"]["flops"] / want - 1) <= 0.10, (rec["cost"]["flops"], want)
