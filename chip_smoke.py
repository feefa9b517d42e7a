#!/usr/bin/env python3
"""Drive the repro_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` and runs the paper's
protocol and applications through the port's public entry points:

  1. build every kernel (one nvcc per source, in parallel; set-up time);
  2. the device-window claim loop through the facade:
     ``dls.loop(N, t, P=<SM count>, runtime="device")`` drained by
     ``executor="device"`` for static/ss/gss/tss/fac2, over the 4,096 64x64
     tiles of a 4096x4096 Mandelbrot image (CT 2000) with the tiles'
     escape-iteration costs, plus the GSS boundary case (N=513, P=3) drained
     both by the protocol kernel and by host claims through the window's
     fetch-add kernel;
  3. the static Mandelbrot kernel at 4096x4096, CT 2000;
  4. the persistent Mandelbrot kernel over the gss and fac2 schedules;
  5. PSIA spin images: 800,000 points (the paper's object size) and 8,192
     images, W=5, support angle 2.0, bin size 0.05.

The launch counts are zeroed just before phases 2-5 and read just after.
Every kernel is then held against its plain PyTorch version on the same
inputs, every schedule against the host plan, and each kernel is timed
with CUDA events beside its plain version and its bound.  The script exits
non-zero without a result line when there is no card or no package beside
it, and on any failed check.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The H100 SXM's published peaks: the least time a kernel could take is the
# larger of its bytes over the memory rate and its operations over the f32
# rate without FMA (half the 67 TFLOP/s FMA rate).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2

TECHNIQUES = ("static", "ss", "gss", "tss", "fac2")
IMG, CT, TILE = 4096, 2000, 64
N_POINTS, N_IMAGES, IMG_W, SUPPORT, BIN = 800_000, 8192, 5, 2.0, 0.05
MANDEL_OPS_PER_ITER = 16  # 15 f32 arithmetic operations and one compare
SPIN_OPS_PER_PAIR = 32    # diff 3, beta 5, r2 5, alpha 4, cos 5, bins 5, gates 5
REPS = 5


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps: int = REPS):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_ms(fn, reps: int = REPS):
    """Median host-clock time of ``fn()`` (plain code that runs on the CPU)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes / HBM rate, ops / f32 rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def claims_in_grant_order(rep):
    rows = sorted((c.step, pe, c.start, c.size)
                  for pe, per in enumerate(rep.per_pe_claims) for c in per)
    return [list(col) for col in zip(*rows)]


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2

    from repro_torch import dls
    from repro_torch.core.chunk_calculus import max_steps_bound, plan
    from repro_torch.device import claim_schedule, host_spec, slab_to_numpy
    from repro_torch.device.persistent import (
        _claim_loop_cuda, _claim_loop_plain, cost_prefix_sum)
    from repro_torch.device.window import fetch_add_slab
    from repro_torch.kernels import (
        _build, mandelbrot, mandelbrot_persistent, mandelbrot_ref, spin_images,
        spin_images_oracle)
    from repro_torch.kernels.mandelbrot.persistent import (
        _persistent_cuda, _persistent_plain, mandelbrot_tile_costs)

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    P = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"device: {kind}, {P} SMs, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (set-up, nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # -- 2-5. the main path, launch counts zeroed just before --------------
    N = (IMG // TILE) ** 2
    rng = np.random.default_rng(0)
    pts_np = rng.normal(size=(N_POINTS, 3)).astype(np.float32)
    nrm_np = rng.normal(size=(N_POINTS, 3)).astype(np.float32)
    nrm_np /= np.linalg.norm(nrm_np, axis=1, keepdims=True)
    points = torch.from_numpy(pts_np).to(dev)
    normals = torch.from_numpy(nrm_np).to(dev)
    torch.cuda.synchronize()

    _build.reset_launches()
    t_main = time.perf_counter()
    image = mandelbrot(IMG, ct=CT)
    costs = mandelbrot_tile_costs(image, TILE, TILE)
    sessions = {}
    for t in TECHNIQUES:
        s = dls.loop(N, t, P=P, runtime="device")
        sessions[t] = (s, dls.execute(s, None, executor="device", costs=costs))
    s513 = dls.loop(513, "gss", P=3, runtime="device")
    rep513 = dls.execute(s513, None, executor="device")
    s513h = dls.loop(513, "gss", P=3, runtime="device")
    rep513h = dls.execute(s513h, None, executor="serial")
    schedules = {t: claim_schedule(t, N, P, costs=costs) for t in ("gss", "fac2")}
    persistent = {t: mandelbrot_persistent(
        IMG, ct=CT, block_h=TILE, block_w=TILE, workers=P, schedule=schedules[t])[0]
        for t in schedules}
    spins = spin_images(points, normals, N_IMAGES, img_width=IMG_W,
                        bin_size=BIN, support_angle=SUPPORT)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(_build.LAUNCHES)
    print(f"main path: {main_s:.2f} s wall, launches {launches}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")

    err = {}  # kernel -> max |kernel - plain| over this run's outputs
    # -- 2. checks: schedules ----------------------------------------------
    for t in TECHNIQUES:
        s, rep = sessions[t]
        sizes, starts = plan(host_spec(t, N, P))
        steps, workers, st, sz = claims_in_grant_order(rep)
        check(np.array_equal(st, starts) and np.array_equal(sz, sizes),
              f"{t}: schedule == host plan")
        check(np.array_equal(steps, np.arange(len(sizes))), f"{t}: steps 0..S-1")
        cov = np.zeros(N, np.int64)
        for a, b in zip(st, sz):
            cov[a:a + b] += 1
        check((cov == 1).all(), f"{t}: claims partition [0, N)")
        check(rep.n_rmw_global == 2 * rep.steps, f"{t}: n_rmw_global == 2*steps")
        i_slot, lp_slot = s.runtime.counter_slots()
        slab = slab_to_numpy(s.runtime.window.slab())
        check(slab[i_slot] == rep.steps and slab[lp_slot] >= N,
              f"{t}: slab counters drained (i={slab[i_slot]}, lp={slab[lp_slot]})")
        plain = claim_schedule(t, N, P, costs=costs, device="cpu")
        for f, got in (("steps", steps), ("workers", workers), ("starts", st),
                       ("sizes", sz), ("counts", [len(c) for c in rep.per_pe_claims])):
            check(np.array_equal(getattr(plain, f), got), f"{t}: facade {f} == plain")
        check(rep.wall_time == plain.makespan(), f"{t}: makespan (max clock) == plain")
        if t in schedules:
            k = schedules[t]
            for f in ("steps", "workers", "starts", "sizes", "counts", "clocks"):
                check(np.array_equal(getattr(k, f), getattr(plain, f)),
                      f"{t}: kernel {f} == plain {f}")
                d = np.abs(getattr(k, f).astype(np.float64) - getattr(plain, f))
                err["protocol"] = max(err.get("protocol", 0.0), float(d.max()))
        print(f"schedule {t}: N={N} P={P} steps={rep.steps} modeled makespan / "
              f"ideal {float(rep.wall_time / (costs.sum() / P))!r}; == host plan "
              f"and plain, partition, 2 RMW/step, drained")
    for name, rep in (("device", rep513), ("host claims", rep513h)):
        sizes, starts = plan(host_spec("gss", 513, 3))
        _, _, st, sz = claims_in_grant_order(rep)
        check(np.array_equal(st, starts) and np.array_equal(sz, sizes),
              f"gss (513, 3) via {name} == host plan")
    print(f"schedule gss (513, 3): sizes {sz} == host plan via the protocol "
          f"kernel and via host fetch-adds")

    # -- 3. Mandelbrot static vs plain ---------------------------------------
    plain_image = mandelbrot_ref(IMG, ct=CT)
    frac = (image != plain_image).double().mean().item()
    err["mandelbrot_static"] = float((image - plain_image).abs().max())
    check(frac < 0.005, f"mandelbrot: {frac:.6f} of pixels differ (< 0.5 %)")
    check(int(image.max()) == CT and int(image.min()) >= 1
          and float(image.double().std()) > 5, "mandelbrot: interior hits CT, not flat")
    sum_counts = int(image.sum(dtype=torch.int64))
    print(f"mandelbrot static {IMG}x{IMG} CT {CT}: {frac!r} of pixels differ "
          f"from the plain version; sum(counts)={sum_counts}")

    # -- 4. Mandelbrot persistent == static ----------------------------------
    for t, out in persistent.items():
        check(torch.equal(out, image), f"persistent ({t}) == static exactly")
    nclaims, pst, psz = schedules["gss"].worker_lists()
    pers_plain = _persistent_plain(nclaims, pst, psz, width=IMG, height=IMG,
                                   ct=CT, xlim=(-2.0, 1.0), ylim=(-1.5, 1.5),
                                   block_h=TILE, block_w=TILE, gw=IMG // TILE,
                                   device=dev)
    check(torch.equal(pers_plain, persistent["gss"]), "persistent kernel == plain")
    err["mandelbrot_persistent"] = float((pers_plain - persistent["gss"]).abs().max())
    print("mandelbrot persistent (gss, fac2) == static exactly; == plain")

    # -- 5. spin images vs plain ---------------------------------------------
    spin_plain = spin_images_oracle(points, normals, N_IMAGES, img_width=IMG_W,
                                    bin_size=BIN, support_angle=SUPPORT,
                                    point_chunk=4096)
    check(torch.equal(spins, spin_plain), "spin images == plain exactly")
    err["spin_image"] = float((spins - spin_plain).abs().max())
    per_image = spins.sum(dim=(1, 2), dtype=torch.int64).double()
    check(per_image.sum() > 0, "spin images are not all zero")
    print(f"spin images: {N_POINTS} points x {N_IMAGES} images (cut from the "
          f"paper's 288,000 images), W={IMG_W}, bin {BIN}: all {N_IMAGES} == "
          f"plain exactly; mean {per_image.mean().item():.1f} points/image")

    # window fetch-add: the same RMW sequence on a CUDA and a CPU slab
    wslab = torch.zeros(2, dtype=torch.int32, device=dev)
    cslab = torch.zeros(2, dtype=torch.int32)
    deltas = [1, 5, -3, 1000, 7]
    olds = [(fetch_add_slab(wslab, 1, d), fetch_add_slab(cslab, 1, d)) for d in deltas]
    err["window_fetch_add"] = float(max(abs(a - b) for a, b in olds))
    check(err["window_fetch_add"] == 0 and torch.equal(wslab.cpu(), cslab),
          "window fetch-add == plain")

    # -- 6. times ------------------------------------------------------------
    rows = []

    def row(name, source, replaces, ms, plain_ms, nbytes, ops, plain_where="card"):
        b_ms, b_by = bound(nbytes, ops)
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=launches[name], max_abs_err=err[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None))
        print(f"time {name}: {ms!r} ms; plain ({plain_where}) {plain_ms!r} ms; "
              f"bound {b_ms!r} ms ({b_by}); library_ms null")

    # window fetch-add: one host RMW (launch + 4-byte read back)
    row("window_fetch_add", "src/repro_torch/csrc/window.cu",
        "src/repro/device/window.py:44",
        cuda_ms(lambda: fetch_add_slab(wslab, 0, 1)),
        host_ms(lambda: fetch_add_slab(cslab, 0, 1)), 12, 1, "host CPU")

    # protocol: the gss loop of phase 2 (the kernel and the slab's reset)
    spec = host_spec("gss", N, P)
    S = int(max_steps_bound(spec))
    kw = dict(technique="gss", N=N, P=P, chunk=1, max_chunk=None, S=S,
              i_slot=0, lp_slot=1, i_bits=(2 * S).bit_length())
    csum = cost_prefix_sum(costs, N)
    csum_dev = torch.from_numpy(csum).to(dev)
    pslab = torch.zeros(2, dtype=torch.int32, device=dev)
    proto_ms = cuda_ms(lambda: _claim_loop_cuda(pslab.zero_(), csum_dev, **kw))
    n_steps = schedules["gss"].n_steps
    proto_plain = host_ms(lambda: _claim_loop_plain(
        torch.zeros(2, dtype=torch.int32), torch.from_numpy(csum), **kw))
    row("protocol", "src/repro_torch/csrc/protocol.cu",
        "src/repro/device/persistent.py:42", proto_ms, proto_plain,
        8 + 4 * (N + 1) + 16 * n_steps + 8 * P, n_steps * (P + 40), "host CPU")
    print(f"  protocol is latency-bound: {n_steps} dependent steps of two "
          f"global atomics each ({proto_ms * 1e3 / n_steps!r} us/step)")

    mb_bytes = 4 * IMG * IMG
    row("mandelbrot_static", "src/repro_torch/csrc/mandelbrot.cu",
        "src/repro/kernels/mandelbrot/kernel.py:81",
        cuda_ms(lambda: mandelbrot(IMG, ct=CT)),
        cuda_ms(lambda: mandelbrot_ref(IMG, ct=CT)),
        mb_bytes, MANDEL_OPS_PER_ITER * sum_counts)

    def persistent_ms(t):
        tables = schedules[t].worker_lists()
        return cuda_ms(lambda: _persistent_cuda(
            *tables, width=IMG, height=IMG, ct=CT, xlim=(-2.0, 1.0),
            ylim=(-1.5, 1.5), block_h=TILE, block_w=TILE, gw=IMG // TILE,
            device=dev))

    schedules["ss"] = claim_schedule("ss", N, P, costs=costs)
    for t in ("fac2", "ss"):
        print(f"time mandelbrot_persistent over the {t} schedule: "
              f"{persistent_ms(t)!r} ms")
    row("mandelbrot_persistent", "src/repro_torch/csrc/mandelbrot.cu",
        "src/repro/kernels/mandelbrot/persistent.py:28",
        persistent_ms("gss"),
        cuda_ms(lambda: _persistent_plain(
            nclaims, pst, psz, width=IMG, height=IMG, ct=CT, xlim=(-2.0, 1.0),
            ylim=(-1.5, 1.5), block_h=TILE, block_w=TILE, gw=IMG // TILE,
            device=dev)),
        mb_bytes + 4 * (P + 2 * pst.size), MANDEL_OPS_PER_ITER * sum_counts)
    row("spin_image", "src/repro_torch/csrc/spin_image.cu",
        "src/repro/kernels/spin_image/kernel.py:31",
        cuda_ms(lambda: spin_images(points, normals, N_IMAGES, img_width=IMG_W,
                                    bin_size=BIN, support_angle=SUPPORT)),
        cuda_ms(lambda: spin_images_oracle(
            points, normals, N_IMAGES, img_width=IMG_W, bin_size=BIN,
            support_angle=SUPPORT, point_chunk=4096)),
        24 * N_POINTS + 4 * N_IMAGES * IMG_W * IMG_W,
        SPIN_OPS_PER_PAIR * N_IMAGES * N_POINTS)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
