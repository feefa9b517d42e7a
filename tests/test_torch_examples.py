"""The host-plane examples' ports (``examples/*_torch.py``), each run in a
subprocess beside its reference with the same arguments: the DES's and
the seeded serving scenario's lines byte for byte, the thread and process
runs' counts where the protocol fixes them, and the Mandelbrot image and
its DES comparison (``--device cpu``: the kernel's plain version)."""
import math
import re

import numpy as np
import pytest

from _torch_support import run_examples
from repro_torch.core import LoopSpec, plan

def _counts(line):
    return {k: int(v) for k, v in re.findall(r"(steps|rmw_g|rmw_l)=(\d+)", line)}


def test_serve_open_loop_stdout_is_the_references():
    port, ref = run_examples(("serve_open_loop_torch.py", ()), ("serve_open_loop.py", ()))
    assert port == ref
    # the scenario's reports carry each replay sweep's wall time (sweep_s),
    # so two runs' bytes differ in both packages; the line is still printed
    assert port.splitlines()[-1].startswith("[open_loop] auto p99 TTFT ")


def test_dls_hierarchical_matches_reference():
    args = ("--n", 2000, "--workers", 8, "--nodes", 2)
    port, ref = run_examples(("dls_hierarchical_torch.py", args),
                             ("dls_hierarchical.py", args))
    p_lines, r_lines = port.splitlines(), ref.splitlines()
    des = p_lines.index("DES at the paper's 288-core 2:1 KNL/Xeon mix:")
    assert p_lines[des:] == r_lines[des:]  # the DES: byte for byte
    N, P = 2000, 8
    for i, (p, r) in enumerate(zip(p_lines[1:3], r_lines[1:3])):
        pc, rc = _counts(p), _counts(r)
        assert pc["steps"] == rc["steps"] == N
        if i == 0:  # flat ss: 2 RMWs a claim, plus at most one failed claim a PE
            for c in (pc, rc):
                assert 2 * N <= c["rmw_g"] <= 2 * N + 2 * P and c["rmw_l"] == 0
        else:  # hierarchical: the super-chunk claims are the outer plan's
            assert pc["rmw_g"] == rc["rmw_g"]
            assert pc["rmw_l"] >= 2 * N and rc["rmw_l"] >= 2 * N
    assert "global RMWs cut" in p_lines[3]


PROCESSES_TITLES = ("one-sided P=8", "hierarchical 2 nodes", "PE 2 dies mid-chunk")


def _processes_runs(out):
    return [ln for ln in out.splitlines() if not ln.startswith(" ")]


def _reference_fault(rc, out, err, N):
    """One of the reference's two documented faults at its run 3
    (ROADMAP.md §3), which the port repairs: PE 2 got no chunk, so
    nobody died and the example raised ``StopIteration``; or PE 2 died
    but a chunk record died with it, so ``iters`` < N."""
    runs = _processes_runs(out)
    if [r[:24].rstrip() for r in runs] != list(PROCESSES_TITLES):
        return False
    if rc != 0:  # run 3 printed its line, then found no dead PE
        return "deaths" not in runs[2] and err.rstrip().endswith("StopIteration")
    return ("deaths=1" in runs[2]
            and int(re.search(r"iters=(\d+)", runs[2])[1]) < N)


def test_dls_processes_matches_reference():
    # one example after the other, at the example's own size.  The port
    # is held exactly: its PE 2 dies in its batch-0 chunk (workloads.die_at
    # holds the other PEs' first sub-block until PE 2 has claimed) and every
    # record it sent reaches the parent.  The reference keeps both faults
    # (ROADMAP.md §3): a run of it showing one is run again, three in all
    N, P, nodes = 2000, 8, 2
    (port,) = run_examples(("dls_processes_torch.py", ()))
    tries = []
    for _ in range(3):
        ((rc, ref, err),) = run_examples(("dls_processes.py", ()), check=False)
        tries.append((rc, ref, err))
        if not _reference_fault(rc, ref, err, N):
            break
    else:
        pytest.fail("the reference's example showed a documented fault in all "
                    "three runs:\n" + "\n".join(f"exit {rc}\n{o}\n{e[-1500:]}"
                                                 for rc, o, e in tries))
    assert rc == 0, f"dls_processes.py exited {rc}:\n{ref}\n{err[-3000:]}"
    got = {}
    for name, out in (("port", port), ("ref", ref)):
        runs = _processes_runs(out)
        assert [r[:24].rstrip() for r in runs] == list(PROCESSES_TITLES), out
        for r in runs:
            assert f"iters={N}" in r, r
        assert "deaths=1" in runs[2] and "deaths" not in runs[0] + runs[1]
        rmw = re.search(r"rmw_global=(\d+) rmw_local=(\d+)", out)
        dead = re.search(r"salvaged=(\d+) orphaned=(\d+)", out)
        assert f"all {N} iterations still exactly once" in out
        got[name] = (int(rmw[1]), int(rmw[2]), int(dead[1]), int(dead[2]))
    # a node's refiller may pay one failed super-chunk claim (2 RMWs) past
    # the drain, in either package: equal up to that race
    assert abs(got["port"][0] - got["ref"][0]) <= 2 * nodes
    assert got["port"][1] > got["port"][0] > 0
    # PE 2 dies on its second sub-block of 16 (progress=16): mid-chunk, its
    # prefix salvaged and the rest of the fac2 chunk it held orphaned.  The
    # port's is its batch-0 chunk, 16 + 109; the reference's is that chunk
    # unless PE 2 started late
    sizes = plan(LoopSpec("fac2", N=N, P=P))[0]
    assert got["port"][2:] == (16, int(sizes[0]) - 16) == (16, 109), got["port"]
    salvaged, orphaned = got["ref"][2:]
    assert salvaged in (0, 16) and salvaged + orphaned in set(sizes.tolist()), got["ref"]


def _pgm(path):
    data = path.read_bytes()
    header, pixels = data.split(b"\n", 1)
    _, w, h, _ = header.split()
    return np.frombuffer(pixels, np.uint8).reshape(int(h), int(w))


def test_dls_mandelbrot_matches_reference(tmp_path):
    args = ("--width", 64, "--ct", 50, "--workers", 4)
    port, ref = run_examples(
        ("dls_mandelbrot_torch.py", (*args, "--out", tmp_path / "port.pgm", "--device", "cpu")),
        ("dls_mandelbrot.py", (*args, "--out", tmp_path / "ref.pgm")))
    a, b = _pgm(tmp_path / "port.pgm"), _pgm(tmp_path / "ref.pgm")
    assert a.shape == b.shape == (64, 64)
    # ct 50 <= 255: the image's levels are one to one with the counts
    assert (a != b).mean() < 0.005
    pat = re.compile(r"^(\w+)\s*: T_loop=\s*([\d.]+)s cov=\s*([\d.]+) chunks=\s*(\d+)$", re.M)
    p_rows, r_rows = pat.findall(port), pat.findall(ref)
    assert [r[0] for r in p_rows] == ["static", "ss", "fac2", "gss", "wf"]
    for p, r in zip(p_rows, r_rows):
        assert p[0] == r[0] and p[3] == r[3]  # the technique's chunk count
        # each package's costs come from its own image: T_loop within 2 %
        assert math.isclose(float(p[1]), float(r[1]), rel_tol=0.02), (p, r)
    assert re.search(r"rendered 64x64 via \d+ one-sided claims", port)

