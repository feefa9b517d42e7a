"""Port parity, applications: repro_torch.kernels vs repro.kernels.

Plain versions (``device="cpu"``) against the JAX kernels in interpret mode,
at the reference's own bars: Mandelbrot within 0.5 % of pixels (the f32
iteration is chaotic at the set boundary and XLA contracts some products
into FMAs), persistent == static exactly, spin images exactly equal.  The
``cuda`` tests hold the CUDA kernels against the plain versions and skip
without a card.  The JAX package is imported only by the parity tests
(``jk`` fixture), so the ``cuda`` tests also run where jax is absent.
"""
import numpy as np
import pytest
import torch

import repro_torch.kernels as tk
from repro_torch.kernels.mandelbrot.persistent import mandelbrot_tile_costs

from _torch_support import cloud, require_card


@pytest.fixture(scope="module")
def jk():
    import repro.kernels

    return repro.kernels

MANDEL_GRID = [  # tests/test_kernels.py: (width, height, ct, block_h, block_w)
    (64, 64, 100, 128, 128),
    (200, 120, 150, 128, 128),
    (256, 256, 80, 128, 128),
    (96, 96, 120, 32, 128),
]

SPIN_GRID = [  # tests/test_kernels.py: (n_points, n_images, W, bin_size, angle)
    (256, 16, 5, 0.5, 2.0),
    (300, 20, 5, 0.25, 1.0),
    (128, 8, 7, 0.4, 2.0),
    (512, 50, 5, 0.6, 3.2),
]


@pytest.mark.parametrize("width,height,ct,bh,bw", MANDEL_GRID)
def test_mandelbrot_plain_matches_reference(jk, width, height, ct, bh, bw):
    got = tk.mandelbrot(width, height, ct=ct, device="cpu").numpy()
    ref = np.asarray(jk.mandelbrot(width, height, ct=ct, block_h=bh, block_w=bw))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert (got != ref).mean() < 0.005, f"{(got != ref).sum()} mismatched pixels"


def test_mandelbrot_plain_interior_hits_ct():
    k = tk.mandelbrot(128, ct=60, device="cpu")
    assert int(k.max()) == 60 and int(k.min()) >= 1
    assert float(k.double().std()) > 5


@pytest.mark.parametrize("technique", ["gss", "fac2", "tss", "ss"])
def test_mandelbrot_persistent_plain_equals_static(technique):
    ref = tk.mandelbrot(64, 48, ct=30, device="cpu")
    costs = mandelbrot_tile_costs(ref, 16, 16)
    out, sched = tk.mandelbrot_persistent(
        64, 48, ct=30, block_h=16, block_w=16, technique=technique, workers=3,
        costs=costs, device="cpu")
    assert torch.equal(out, ref)
    assert int(sched.sizes.sum()) == sched.N == 12
    out2, sched2 = tk.mandelbrot_persistent(
        64, 48, ct=30, block_h=16, block_w=16, workers=3, schedule=sched,
        device="cpu")
    assert sched2 is sched and torch.equal(out2, ref)


def test_mandelbrot_persistent_rejects_foreign_schedule():
    _, sched = tk.mandelbrot_persistent(32, ct=5, block_h=16, block_w=16,
                                        workers=2, device="cpu")
    with pytest.raises(ValueError, match="schedule is for"):
        tk.mandelbrot_persistent(64, ct=5, block_h=16, block_w=16, workers=2,
                                 schedule=sched, device="cpu")


def test_mandelbrot_tile_costs_match_reference(jk):
    from repro.kernels.mandelbrot.persistent import mandelbrot_tile_costs as j_costs

    img = np.asarray(jk.mandelbrot(96, 80, ct=40, block_h=32, block_w=32))
    got = mandelbrot_tile_costs(torch.tensor(img), 32, 32)
    assert np.array_equal(got, j_costs(img, 32, 32))


@pytest.mark.parametrize("n_points,n_images,W,bin_size,angle", SPIN_GRID)
def test_spin_images_plain_match_reference(jk, n_points, n_images, W, bin_size, angle):
    import jax.numpy as jnp

    pts, nrm = cloud(n_points)
    got = tk.spin_images(torch.from_numpy(pts), torch.from_numpy(nrm), n_images,
                         img_width=W, bin_size=bin_size, support_angle=angle)
    ref = jk.spin_images(jnp.asarray(pts), jnp.asarray(nrm), n_images,
                         img_width=W, bin_size=bin_size, support_angle=angle)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    chunked = tk.spin_images_oracle(torch.from_numpy(pts), torch.from_numpy(nrm),
                                    n_images, img_width=W, bin_size=bin_size,
                                    support_angle=angle, point_chunk=97)
    assert torch.equal(chunked, got)


@pytest.mark.parametrize("kind", ["numpy", "list"])
def test_spin_images_host_input_on_cpu_when_asked(kind):
    """Input with no device of its own runs where ``device=`` says."""
    pts, nrm = cloud(64)
    if kind == "list":
        pts, nrm = pts.tolist(), nrm.tolist()
    got = tk.spin_images(pts, nrm, 8, bin_size=0.5, device="cpu")
    want = tk.spin_images(torch.tensor(pts), torch.tensor(nrm), 8, bin_size=0.5)
    assert got.device.type == "cpu" and torch.equal(got, want)
    assert torch.equal(tk.spin_images_oracle(pts, nrm, 8, bin_size=0.5,
                                             device="cpu"), want)


@pytest.mark.parametrize("entry", ["spin_images", "spin_images_oracle",
                                   "mandelbrot", "mandelbrot_persistent",
                                   "flash_attention", "attention_oracle",
                                   "flash_attention_persistent",
                                   "ssd_scan", "ssd_scan_oracle",
                                   "models.api.forward",
                                   "models.api.init_cache",
                                   "models.params.params_from_numpy"])
def test_kernel_entry_points_default_to_the_card(monkeypatch, entry):
    """Without a card the default raises instead of running the plain
    version: numpy input has no device, so it goes to "cuda"; the model's
    params are made on (or carried to) "cuda" unless told otherwise."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.params import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, nrm = cloud(32)
    q = np.zeros((1, 2, 16, 8), np.float32)
    kv = np.zeros((1, 1, 16, 8), np.float32)
    ssd = (np.zeros((1, 8, 2, 4), np.float32), np.zeros((1, 8, 2), np.float32),
           np.zeros(2, np.float32), np.zeros((1, 8, 4), np.float32),
           np.zeros((1, 8, 4), np.float32))
    cfg = get_config("tinyllama-1.1b").reduced(n_layers=1)
    tokens = {"tokens": np.zeros((1, 4), np.int32)}
    call = {
        "flash_attention": lambda: tk.flash_attention(q, kv, kv),
        "attention_oracle": lambda: tk.attention_oracle(q, kv, kv),
        "flash_attention_persistent": lambda: tk.flash_attention_persistent(q, kv, kv),
        "ssd_scan": lambda: tk.ssd_scan(*ssd),
        "ssd_scan_oracle": lambda: tk.ssd_scan_oracle(*ssd),
        "models.api.forward": lambda: api.forward(api.init_params(0, cfg), cfg, tokens),
        "models.api.init_cache": lambda: api.init_cache(
            get_config("mamba2-370m").reduced(n_layers=1), 1, 8),
        "models.params.params_from_numpy": lambda: params_from_numpy(
            {"layers": {}}, cfg),
        "spin_images": lambda: tk.spin_images(pts, nrm, 4),
        "spin_images_oracle": lambda: tk.spin_images_oracle(pts, nrm, 4),
        "mandelbrot": lambda: tk.mandelbrot(32, ct=5),
        "mandelbrot_persistent": lambda: tk.mandelbrot_persistent(
            32, ct=5, block_h=16, block_w=16, workers=2),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_library_name_tracks_the_compiler(monkeypatch):
    """A build by another nvcc is another library, never loaded in its place."""
    from repro_torch.kernels import _build

    names = []
    for compiler in ("/a/nvcc\nrelease 12.4", "/a/nvcc\nrelease 12.8", "/b/nvcc\nrelease 12.8"):
        monkeypatch.setattr(_build, "_compiler_id", lambda c=compiler: c)
        names.append(_build._library_path("window").name)
    assert len(set(names)) == 3 and all(n.startswith("window-") for n in names)


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("width,height,ct,bh,bw", MANDEL_GRID)
def test_mandelbrot_kernel_matches_plain(width, height, ct, bh, bw):
    require_card()
    k = tk.mandelbrot(width, height, ct=ct)
    assert torch.equal(k, tk.mandelbrot_ref(width, height, ct=ct))


@pytest.mark.cuda
@pytest.mark.parametrize("technique", ["gss", "fac2", "tss", "ss"])
def test_mandelbrot_persistent_kernel_equals_static(technique):
    require_card()
    ref = tk.mandelbrot(200, 120, ct=150)
    out, sched = tk.mandelbrot_persistent(
        200, 120, ct=150, block_h=32, block_w=32, technique=technique, workers=5,
        costs=mandelbrot_tile_costs(ref, 32, 32))
    assert torch.equal(out, ref)
    plain, _ = tk.mandelbrot_persistent(
        200, 120, ct=150, block_h=32, block_w=32, workers=5, schedule=sched,
        device="cpu")
    assert torch.equal(out.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n_points,n_images,W,bin_size,angle", SPIN_GRID)
def test_spin_image_kernel_matches_plain(n_points, n_images, W, bin_size, angle):
    require_card()
    pts, nrm = (torch.from_numpy(a).cuda() for a in cloud(n_points))
    k = tk.spin_images(pts, nrm, n_images, img_width=W, bin_size=bin_size,
                       support_angle=angle)
    p = tk.spin_images_oracle(pts, nrm, n_images, img_width=W,
                              bin_size=bin_size, support_angle=angle)
    assert torch.equal(k, p)


@pytest.mark.cuda
def test_launch_on_another_card_keeps_the_current_device():
    """Every kernel launches on its tensors' card and leaves the caller's
    current device as it was."""
    require_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.device import DeviceWindow, claim_schedule

    torch.cuda.set_device(0)
    pts, nrm = cloud(256)
    spins = tk.spin_images(pts, nrm, 16, bin_size=0.5, device="cuda:1")
    img = tk.mandelbrot(64, ct=40, device="cuda:1")
    out, sched = tk.mandelbrot_persistent(64, ct=40, block_h=16, block_w=16,
                                          workers=3, device="cuda:1")
    w = DeviceWindow(device="cuda:1")
    assert w.fetch_add("k", 5) == 0 and w.fetch_add("k", 1) == 5
    assert torch.cuda.current_device() == 0
    assert torch.empty(1, device="cuda").device.index == 0
    assert spins.device.index == img.device.index == sched.slab.device.index == 1
    assert torch.equal(spins.cpu(), tk.spin_images(pts, nrm, 16, bin_size=0.5,
                                                   device="cpu"))
    assert torch.equal(img.cpu(), tk.mandelbrot(64, ct=40, device="cpu"))
    assert torch.equal(out, img)
    plain = claim_schedule("gss", sched.N, 3, device="cpu")
    assert np.array_equal(sched.sizes, plain.sizes)
