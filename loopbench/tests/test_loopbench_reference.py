"""The benchmark's plain references at tiny sizes, on the CPU."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from loopbench.reference import attention, closed_forms, mandelbrot, work  # noqa: E402


def _scalar_count(cr, ci, ct):
    """Algorithm 2 for one pixel, in numpy f32 scalars."""
    f = np.float32
    zr = zi = f(0.0)
    for it in range(1, ct + 1):
        zr2 = zr * zr - zi * zi
        zi2 = (f(2.0) * zr) * zi
        zr4 = zr2 * zr2 - zi2 * zi2
        zi4 = (f(2.0) * zr2) * zi2
        zr, zi = zr4 + cr, zi4 + ci
        if not (zr * zr + zi * zi < f(4.0)):
            return it
    return ct


@pytest.mark.parametrize("width,height,ct", [(12, 9, 40), (7, 7, 17)])
def test_escape_counts_equal_a_scalar_loop(width, height, ct):
    with np.errstate(over="ignore", invalid="ignore"):
        got = mandelbrot.image(width, height, ct, (-2.0, 1.0), (-1.5, 1.5), "cpu")
        xmin, dx, ymin, dy = mandelbrot.geometry(width, height, (-2.0, 1.0), (-1.5, 1.5))
        f = np.float32
        want = np.array([[_scalar_count(f(xmin) + f(c) * f(dx), f(ymin) + f(r) * f(dy), ct)
                          for c in range(width)] for r in range(height)])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.max() == ct and got.min() >= 1


def test_escape_counts_do_not_depend_on_the_block():
    a = mandelbrot.image(16, 16, 60, (-2.0, 1.0), (-1.5, 1.5), "cpu")
    cr = mandelbrot.axis(*mandelbrot.geometry(16, 16, (-2.0, 1.0), (-1.5, 1.5))[:2], 16, "cpu")
    ci = mandelbrot.axis(*mandelbrot.geometry(16, 16, (-2.0, 1.0), (-1.5, 1.5))[2:], 16, "cpu")
    b = mandelbrot.escape_counts(cr, ci, 60, block=1)
    assert torch.equal(a, b)


def test_band_image_rows_follow_each_bands_grid():
    rows = mandelbrot.band_rows(32, 16, 8, (-2.0, 1.0), (-1.5, 1.5), "cpu")
    dy = 3.0 / 15
    _, _, ymin, bdy = mandelbrot.geometry(32, 8, (-2.0, 1.0), (-1.5 + dy * 8, -1.5 + dy * 15))
    assert rows.shape == (16,)
    assert float(rows[8]) == float(np.float32(ymin))
    assert float(rows[9]) == float(np.float32(np.float32(ymin) + np.float32(1) * np.float32(bdy)))


def test_control_precision_changes_counts():
    f32 = mandelbrot.image(48, 48, 80, (-2.0, 1.0), (-1.5, 1.5), "cpu")
    bf16 = mandelbrot.image(48, 48, 80, (-2.0, 1.0), (-1.5, 1.5), "cpu", dtype=torch.bfloat16)
    assert int((f32 != bf16).sum()) > 0


def test_tile_sums():
    img = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    np.testing.assert_array_equal(mandelbrot.tile_sums(img, 2, 2),
                                  [0 + 1 + 4 + 5, 2 + 3 + 6 + 7, 8 + 9, 10 + 11])


@pytest.mark.parametrize("technique,N,P,want", [
    ("gss", 100, 4, [25, 19, 15, 11, 8, 6, 5, 4, 3, 2, 2, 2, 1]),
    ("fac2", 100, 4, [13] * 4 + [7] * 4 + [4] * 4 + [2] * 4 + [1] * 4),
    ("ss", 10, 3, [1] * 5),
    ("static", 10, 3, [4] * 3),
])
def test_closed_forms_known_sequences(technique, N, P, want):
    got = closed_forms.chunk_sizes(technique, np.arange(len(want)), N, P)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("technique", closed_forms.TECHNIQUES)
def test_plan_partitions_and_checks_clean(technique):
    steps, starts, sizes = closed_forms.plan(technique, 1000, 7)
    assert sizes.sum() == 1000 and (sizes > 0).all()
    assert closed_forms.check_schedule(steps, starts, sizes, technique, 1000, 7) == {
        "partition_errors": 0, "chunk_errors": 0}
    # the grants' order does not matter, only their content
    r = np.random.default_rng(0).permutation(len(steps))
    assert closed_forms.check_schedule(steps[r], starts[r], sizes[r], technique, 1000, 7) == {
        "partition_errors": 0, "chunk_errors": 0}


def test_check_schedule_counts_faults():
    steps, starts, sizes = closed_forms.plan("gss", 500, 5)
    # a grant dropped: one gap
    c = closed_forms.check_schedule(steps[1:], starts[1:], sizes[1:], "gss", 500, 5)
    assert c["partition_errors"] == 1
    # a grant twice: an overlap and a step granted twice
    c = closed_forms.check_schedule(np.r_[steps, steps[3]], np.r_[starts, starts[3]],
                                    np.r_[sizes, sizes[3]], "gss", 500, 5)
    assert c["partition_errors"] >= 1 and c["chunk_errors"] == 1
    # a size that is not the closed form (the loop still covered)
    s2 = sizes.copy()
    s2[0] += 1
    st2 = np.r_[0, np.cumsum(s2)[:-1]]
    c = closed_forms.check_schedule(steps, st2, s2, "gss", 500, 5)
    assert c["chunk_errors"] >= 1
    assert closed_forms.check_schedule([], [], [], "gss", 500, 5)["partition_errors"] == 1


def _naive(q, k, v, lengths):
    B, H, _, D = q.shape
    g = H // k.shape[1]
    out = {}
    for b in range(B):
        L = int(lengths[b])
        o = torch.zeros(H, L, D, dtype=torch.float64)
        for h in range(H):
            for r in range(L):
                s = (q[b, h, r].double() @ k[b, h // g, :r + 1].double().T) * D ** -0.5
                p = torch.exp(s - s.max())
                o[h, r] = (p / p.sum()) @ v[b, h // g, :r + 1].double()
        out[b] = o
    return out


def test_blocked_attention_equals_unblocked():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 12, 8, generator=g)
    k = torch.randn(2, 2, 12, 8, generator=g)
    v = torch.randn(2, 2, 12, 8, generator=g)
    lengths = [5, 12]
    want = _naive(q, k, v, lengths)
    for rows in (1, 3, 100):
        for b, L, o in attention.varlen_causal(q, k, v, lengths, rows=rows):
            assert o.shape == (4, L, 8)
            torch.testing.assert_close(o.double(), want[b], rtol=1e-5, atol=1e-6)


def test_attention_control_is_coarser():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 64, 16, generator=g) for _ in range(3))
    (_, _, f32), = attention.varlen_causal(q, k, v, [64])
    (_, _, fp8), = attention.varlen_causal(q, k, v, [64], dtype=torch.float8_e4m3fn)
    (_, _, bf16), = attention.varlen_causal(q, k, v, [64], dtype=torch.bfloat16)
    e8 = float((fp8 - f32).norm() / f32.norm())
    e16 = float((bf16 - f32).norm() / f32.norm())
    assert e8 > 4 * e16 > 0


def test_work_hand_counts():
    m = work.mandelbrot(counts_sum=10, pixels=4)
    assert (m["ops"], m["bytes"]) == (140.0, 16.0)
    a = work.attention([2, 3], H=2, Hkv=1, D=4)
    assert a["ops"] == 4 * 4 * 2 * (3 + 6)
    assert a["bytes"] == 2 * 4 * (2 + 3) * (2 * 2 + 2 * 1)
    assert work.least_seconds(33.5e12, 0.0, "f32_nofma_ops_per_s") == pytest.approx(1.0)
    assert work.least_seconds(0.0, 3.35e12, "bf16_flops_per_s") == pytest.approx(1.0)
