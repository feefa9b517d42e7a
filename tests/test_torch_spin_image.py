"""The spin-image kernel's gate, on the CPU.

``csrc/spin_image.cu`` runs the exact sequence (square root, two IEEE
divisions, two ceilings, the angle and the range tests) only for pairs that
pass a cheap gate: beta in [beta_lo, beta_hi], then s = r2 - beta^2 <=
s_max, on the very floats the exact sequence computes, with the bounds of
``kernel.gate_bounds``.  ``_gated`` below is a torch model of that body.
It must equal the plain version (already held against the JAX kernel)
exactly, and the gate must keep every pair the exact tests keep -- also
for points placed a few ulps either side of every bin edge, and for NaN
and infinite coordinates.  With the margin removed, or the window cut by
one bin, the gate drops such pairs: these tests can fail.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.spin_image import kernel
from repro_torch.kernels.spin_image.kernel import gate_bounds
from repro_torch.kernels.spin_image.ref import (
    _dot3, f32, spin_images_ref, spin_pair_counts)

from _torch_support import cloud
from _torch_support import one_torch_thread  # noqa: F401 (an autouse fixture)

SPIN_GRID = [  # tests/test_kernels.py: (n_points, n_images, W, bin_size, angle)
    (256, 16, 5, 0.5, 2.0),
    (300, 20, 5, 0.25, 1.0),
    (128, 8, 7, 0.4, 2.0),
    (512, 50, 5, 0.6, 3.2),
]
#: (W, bin_size) of the edge tests: SPIN_GRID's, chip_smoke.py's and a few
#: where the bin is small against W/2
EDGE_GEOMETRIES = [(5, 0.5), (5, 0.25), (7, 0.4), (5, 0.6), (5, 0.05),
                   (32, 0.01), (16, 1e-3), (2, 1.3)]


def _gated(points, normals, n_images, *, img_width, bin_size, support_angle,
           bounds=None):
    """The kernel's body: (histograms, gate mask, exact mask).

    The gate on every pair, the exact sequence only on the pairs that pass
    it; ``exact`` is the exact tests on every pair, for comparison.
    """
    W = img_width
    lo, hi, s_max = bounds or gate_bounds(W, bin_size)
    bin_f, cos_s = f32(bin_size), f32(math.cos(support_angle))
    c, cn = points[:n_images, None, :], normals[:n_images, None, :]
    d = points[None] - c
    beta = _dot3(cn, d)
    s = _dot3(d, d) - beta * beta
    gate = (beta >= lo) & (beta <= hi) & (s <= s_max)

    def exact(beta, s, cos_ang):
        alpha = torch.sqrt(torch.clamp(s, min=0.0))
        k = torch.ceil((W / 2.0 - beta) / bin_f)
        l = torch.ceil(alpha / bin_f)
        ok = (cos_ang >= cos_s) & (k >= 0) & (k < W) & (l >= 0) & (l < W)
        return ok, k, l

    m, p = gate.nonzero(as_tuple=True)
    ok, k, l = exact(beta[m, p], s[m, p], _dot3(normals[m], normals[p]))
    bins = (m * W * W + k * W + l)[ok].long()
    hist = torch.zeros(n_images * W * W, dtype=torch.int64)
    hist.index_add_(0, bins, torch.ones_like(bins))
    exact_all = exact(beta, s, _dot3(cn, normals[None]))[0]
    return hist.reshape(n_images, W, W).to(torch.int32), gate, exact_all


def _nan_cloud(n):
    """``cloud(n)`` with NaN and infinite coordinates, centers among them."""
    pts, nrm = cloud(n)
    pts[::7, 1] = np.nan
    pts[3::11, 0] = np.inf
    pts[5::13, 2] = -np.inf
    nrm[2::9, 2] = np.nan
    return pts, nrm


@pytest.mark.parametrize("n_points,n_images,W,bin_size,angle",
                         [(20_000, 64, 5, 0.05, 2.0), *SPIN_GRID])
@pytest.mark.parametrize("bad_values", [False, True])
def test_gated_body_equals_plain(n_points, n_images, W, bin_size, angle, bad_values):
    """(a) On chip_smoke.py's cloud (shrunk to 20,000 points x 64 images)
    and SPIN_GRID, with and without NaN and infinite coordinates."""
    pts, nrm = (_nan_cloud if bad_values else cloud)(n_points)
    pts, nrm = torch.from_numpy(pts), torch.from_numpy(nrm)
    kw = dict(img_width=W, bin_size=bin_size, support_angle=angle)
    hist, gate, exact = _gated(pts, nrm, n_images, **kw)
    assert torch.equal(hist, spin_images_ref(pts, nrm, n_images, **kw))
    assert not (exact & ~gate).any()
    counts = spin_pair_counts(pts, nrm, n_images, point_chunk=4096, **kw)
    assert counts["land"] == int(hist.sum()) == int(exact.sum())
    assert counts["pairs"] >= counts["k"] >= counts["kl"] >= counts["land"] > 0
    assert int(gate.sum()) >= counts["kl"]


def _ulps(v, n):
    """The f32 nearest ``v`` and its ``n`` neighbours on either side."""
    x = np.float32(v)
    out = [x]
    up = down = x
    for _ in range(n):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        out += [up, down]
    return out


def _edge_cloud(W, bin_size, n=3):
    """Image 0 at the origin with normal +z, and points on the bin edges.

    A point (a, 0, b) has beta = b and s = (a*a + b*b) - b*b exactly as the
    kernel computes them.  Points at b within ``n`` ulps of every edge
    W/2 - k bin (k = -1..W) test the beta window; points at b = W/2 + bin/2
    (bin row 0) with a*a within a few ulps of every edge (j bin)^2 test the
    s window.  Then NaN and infinite coordinates, and a NaN normal.
    """
    b = float(np.float32(bin_size))
    pts = [(0.0, 0.0, 0.0)]
    pts += [(0.0, 0.0, v) for k in range(-1, W + 1) for v in _ulps(W / 2 - k * b, n)]
    mid = float(np.float32(W / 2 + b / 2))
    pts += [(a, 0.0, mid) for j in range(W + 1)
            for a in _ulps(math.sqrt((j * b) ** 2), 4 * n)]
    bad = (np.nan, np.inf, -np.inf)
    pts += [(v, 0.0, mid) for v in bad] + [(0.0, v, mid) for v in bad]
    pts += [(0.0, 0.0, v) for v in bad] + [(0.5 * b, 0.0, mid)]
    pts = np.array(pts, np.float32)
    nrm = np.zeros_like(pts)
    nrm[:, 2] = 1.0
    nrm[-1] = np.nan
    return torch.from_numpy(pts), torch.from_numpy(nrm)


@pytest.mark.parametrize("W,bin_size", EDGE_GEOMETRIES)
def test_gate_keeps_every_edge_pair(W, bin_size):
    """(b) The gate passes every edge pair the exact tests accept."""
    pts, nrm = _edge_cloud(W, bin_size)
    kw = dict(img_width=W, bin_size=bin_size, support_angle=2.0)
    hist, gate, exact = _gated(pts, nrm, 1, **kw)
    assert int(exact.sum()) > 4 * W  # the edges are populated
    assert not (exact & ~gate).any()
    assert torch.equal(hist, spin_images_ref(pts, nrm, 1, **kw))


def _drops(W, bin_size, bounds):
    pts, nrm = _edge_cloud(W, bin_size)
    kw = dict(img_width=W, bin_size=bin_size, support_angle=2.0)
    hist, gate, exact = _gated(pts, nrm, 1, bounds=bounds, **kw)
    dropped = int((exact & ~gate).sum())
    assert (dropped > 0) == (not torch.equal(hist, spin_images_ref(pts, nrm, 1, **kw)))
    return dropped


def test_gate_without_margin_drops_edge_pairs(monkeypatch):
    """(c) Without its margin the gate loses edge pairs: the division and the
    square root move an edge by an ulp or two.  At W = 5 the bins of 0.5
    and 0.6 lose some at the beta edges."""
    monkeypatch.setattr(kernel, "GATE_MARGIN", 0.0)
    drops = {g: _drops(*g, gate_bounds(*g)) for g in EDGE_GEOMETRIES}
    assert drops[(5, 0.5)] > 0 and drops[(5, 0.6)] > 0
    assert sum(drops.values()) >= 5, drops


@pytest.mark.parametrize("W,bin_size", EDGE_GEOMETRIES)
@pytest.mark.parametrize("cut", ["beta_lo", "beta_hi", "s_max"])
def test_gate_cut_by_one_bin_drops_edge_pairs(W, bin_size, cut):
    """(c) A window one bin too narrow at any of its three edges loses the
    pairs of a whole bin row or column."""
    lo, hi, s_max = gate_bounds(W, bin_size)
    b = f32(bin_size)
    bounds = {"beta_lo": (lo + b, hi, s_max), "beta_hi": (lo, hi - b, s_max),
              "s_max": (lo, hi, ((W - 2) * b) ** 2 if W > 1 else -1.0)}[cut]
    assert _drops(W, bin_size, bounds) > 0
