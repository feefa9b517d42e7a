"""Port parity, the launchers: repro_torch.launch.{mesh,serve} against
repro.launch.{mesh,serve}.

  * the test mesh's arithmetic (``_largest_factor_leq``, the shapes and
    axis names of ``make_test_mesh``) for every device count, and the
    ``DeviceMesh``es ``make_test_mesh(8)`` and ``make_test_mesh(8,
    multi_pod=True)`` build on a fake process group (a subprocess: the
    group is global to a process);
  * ``make_device_hierarchy(capacity=64, devices=["cpu"])`` drained as in
    ``tests/test_device.py``; without ``devices`` and a card it raises;
  * ``python -m repro_torch.launch.serve --device cpu``: both lines, and
    the makespans equal to the reference CLI's for the same seed (the
    batcher's lines are host arithmetic).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch import dls
from repro_torch.core.rma import HierarchicalWindow
from repro_torch.launch import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": f"{REPO}/src", "PATH": "/usr/bin:/bin:/usr/local/bin",
       "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


def test_largest_factor_matches_reference():
    from repro.launch.mesh import _largest_factor_leq

    for n in range(1, 70):
        for k in range(0, 12):
            assert tmesh._largest_factor_leq(n, k) == _largest_factor_leq(n, k), (n, k)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_test_mesh_dims_match_reference(multi_pod, monkeypatch):
    import jax
    from repro.launch import mesh as jmesh

    made = []
    monkeypatch.setattr(jax, "make_mesh", lambda shape, axes: made.append((shape, axes)))
    for n in (4, 6, 8, 12, 16, 32, 64, 256, 512):
        jmesh.make_test_mesh(n, multi_pod=multi_pod)
        assert tmesh.scaled_mesh_dims(n, multi_pod=multi_pod) == made[-1], n
    with pytest.raises(ValueError):
        tmesh.scaled_mesh_dims(3, multi_pod=True)


def test_test_meshes_on_a_fake_group():
    code = textwrap.dedent("""
        import json, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_test_mesh

        dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
        out = []
        for multi in (False, True):
            m = make_test_mesh(8, multi_pod=multi, device_type="cpu")
            out.append([list(m.shape), list(m.mesh_dim_names)])
        print(json.dumps(out))
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == [
        [[4, 2], ["data", "model"]], [[2, 2, 2], ["pod", "data", "model"]]]


def test_device_hierarchy_composes():
    hw = tmesh.make_device_hierarchy(capacity=64, devices=["cpu"])
    assert isinstance(hw, HierarchicalWindow)
    s = dls.loop(90, "fac2", P=2, runtime="hierarchical", nodes=1, window=hw)
    rep = dls.execute(s, None, executor="serial")
    assert int(rep.per_pe_iters.sum()) == 90


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_device_hierarchy_needs_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_device_hierarchy()


def _serve(module, extra=()):
    r = subprocess.run([sys.executable, "-m", module, "--arch", "tinyllama-1.1b",
                        "--requests", "64", "--batch", "8", *extra],
                       capture_output=True, text=True, timeout=300, cwd=REPO, env=ENV)
    assert r.returncode == 0, r.stdout[-1500:] + r.stderr[-1500:]
    return [line for line in r.stdout.splitlines() if line.startswith("[serve]")]


def test_serve_cli_matches_reference():
    got = _serve("repro_torch.launch.serve", ("--reduced", "--device", "cpu"))
    want = _serve("repro.launch.serve", ("--reduced",))
    assert len(got) == len(want) == 2
    assert got[0].startswith("[serve] generated (8, 16) in ")
    assert got[1] == want[1]  # the makespans and p99s, same seed


def test_serve_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=ENV)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
