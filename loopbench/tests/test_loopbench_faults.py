"""A run drives the program and its check as on the card, on the CPU at tiny
sizes (the program's plain versions), with the timed path broken underneath:
each fault a cell can have must turn ``correct`` false, the sound program
must keep it true, and the control (the reference one precision lower)
must fail the cell's limits."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from loopbench import control, harness  # noqa: E402

from importlib import import_module  # noqa: E402

dev_persistent = import_module("repro_torch.device.persistent")
fa_persistent = import_module("repro_torch.kernels.flash_attention.persistent")
mandel_ops = import_module("repro_torch.kernels.mandelbrot.ops")
mandel_persistent = import_module("repro_torch.kernels.mandelbrot.persistent")
chunk_calculus = import_module("repro_torch.core.chunk_calculus")

TINY = {
    "mandelbrot-z4.tiles64-fac2": {"width": 64, "height": 64, "ct": 50, "block_h": 8,
                                   "block_w": 8, "workers": 4},
    "mandelbrot-z4.pixel-ss": {"width": 40, "height": 40, "ct": 60, "workers": 4},
    "mandelbrot-z4.threads-bands-ss": {"width": 64, "height": 64, "ct": 50, "threads": 3},
    "internvl2-26b-attn.varlen-gss": {"batch": 2, "seq_len": 256, "tile_tokens": 8,
                                      "tiles_max": 4, "text_min": 16, "workers": 4},
}
SEED = 2 ** 31 + 12345


def _run(cell):
    r = harness.run(cell, SEED, 0.2, False, device="cpu", overrides=TINY[cell],
                    log=lambda s: None)
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    return r


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_program_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert {"setup_s"} <= set(r["metrics"]) and len(r["metrics"]) >= 2


def test_setup_leaves_out_the_reference(monkeypatch):
    from loopbench.drivers import persistent_mandelbrot

    image = persistent_mandelbrot.ref.image

    def slow_image(*a, **kw):
        time.sleep(2.0)
        return image(*a, **kw)

    monkeypatch.setattr(persistent_mandelbrot.ref, "image", slow_image)
    r = _run("mandelbrot-z4.tiles64-fac2")
    assert r["correct"] and r["setup_parts"]["reference"] >= 2.0
    assert r["metrics"]["setup_s"]["value"] < 2.0


# --- faults planted in the program, under the timed path ------------------

def _mandel_answer_altered(run):
    def broken(*a, **kw):
        out = run(*a, **kw)
        out[out.shape[0] // 2, out.shape[1] // 3] += 1
        return out
    return broken


def _mandel_half_left_out(run):
    def broken(nclaims, *a, **kw):
        nclaims = nclaims.copy()
        nclaims[len(nclaims) // 2:] = 0           # half the workers' tiles skipped
        return run(nclaims, *a, **kw)
    return broken


def _mandel_nothing_done(run):
    def broken(*a, width, height, device, **kw):
        return torch.zeros((height, width), dtype=torch.int32, device=device)
    return broken


def _attn_answer_altered(run):
    def broken(*a, **kw):
        out = run(*a, **kw)
        out[0, 0, 5, 0] += 0.5
        return out
    return broken


def _attn_half_left_out(run):
    def broken(*a, **kw):
        out = run(*a, **kw)
        out[out.shape[0] // 2:] = out[: out.shape[0] - out.shape[0] // 2].mean(0)
        return out
    return broken


def _attn_nothing_done(run):
    def broken(*a, **kw):
        return torch.zeros_like(run(*a, **kw))
    return broken


def _band_altered(fn):
    def broken(*a, **kw):
        out = fn(*a, **kw)
        out[3, 7] += 1
        return out
    return broken


def _band_half_left_out(fn):
    calls = [0]

    def broken(*a, **kw):
        calls[0] += 1
        out = fn(*a, **kw)
        return out if calls[0] % 2 else torch.full_like(out, -1)
    return broken


def _closed_form_broken(fn):
    def broken(spec, i, *a, **kw):
        k = fn(spec, i, *a, **kw)
        return k + 1 if i == 2 else k
    return broken


def _device_closed_form_broken(fn):
    def broken(technique, i, **kw):
        k = fn(technique, i, **kw).clone()
        k[2] += 1
        return k
    return broken


PERSISTENT = [("answer_altered", _mandel_answer_altered),
              ("half_left_out", _mandel_half_left_out),
              ("nothing_done", _mandel_nothing_done)]


@pytest.mark.parametrize("cell", ["mandelbrot-z4.tiles64-fac2", "mandelbrot-z4.pixel-ss"])
@pytest.mark.parametrize("fault,wrap", PERSISTENT, ids=[f for f, _ in PERSISTENT])
def test_persistent_mandelbrot_faults_fail(cell, fault, wrap, monkeypatch):
    monkeypatch.setattr(mandel_persistent, "_persistent_plain",
                        wrap(mandel_persistent._persistent_plain))
    r = _run(cell)
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["count_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", ["mandelbrot-z4.tiles64-fac2", "mandelbrot-z4.pixel-ss",
                                  "internvl2-26b-attn.varlen-gss"])
def test_device_claim_loop_fault_fails(cell, monkeypatch):
    monkeypatch.setattr(dev_persistent, "chunk_size_device",
                        _device_closed_form_broken(dev_persistent.chunk_size_device))
    r = _run(cell)
    assert not r["correct"] and r["checks"]["chunk_errors"]["value"] > 0


ATTENTION = [("answer_altered", _attn_answer_altered),
             ("half_left_out", _attn_half_left_out),
             ("nothing_done", _attn_nothing_done)]


@pytest.mark.parametrize("fault,wrap", ATTENTION, ids=[f for f, _ in ATTENTION])
def test_persistent_attention_faults_fail(fault, wrap, monkeypatch):
    monkeypatch.setattr(fa_persistent, "_persistent_plain",
                        wrap(fa_persistent._persistent_plain))
    r = _run("internvl2-26b-attn.varlen-gss")
    assert not r["correct"] and r["failed"] >= 1


BANDS = [("answer_altered", _band_altered), ("half_left_out", _band_half_left_out)]


@pytest.mark.parametrize("fault,wrap", BANDS, ids=[f for f, _ in BANDS])
def test_threads_bands_faults_fail(fault, wrap, monkeypatch):
    monkeypatch.setattr(mandel_ops, "mandelbrot_counts_ref",
                        wrap(mandel_ops.mandelbrot_counts_ref))
    r = _run("mandelbrot-z4.threads-bands-ss")
    assert not r["correct"] and r["checks"]["count_mismatches"]["value"] > 0


def test_threads_bands_claim_fault_fails(monkeypatch):
    monkeypatch.setattr(chunk_calculus, "chunk_size_closed",
                        _closed_form_broken(chunk_calculus.chunk_size_closed))
    r = _run("mandelbrot-z4.threads-bands-ss")
    assert not r["correct"] and r["checks"]["chunk_errors"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_fails_the_limits(cell):
    """The reference in the program's place, one precision lower, reads
    above at least one of the cell's limits; the program reads within."""
    out = control.readings(cell, [SEED], [SEED + 1], 2, device="cpu",
                           overrides=TINY[cell], log=lambda s: None)
    limits = harness.workload(cell)["limits"]
    assert all(out["program"][n][0] <= limits[n] for n in limits)
    assert any(out["control"][n][0] > limits[n] for n in limits)
