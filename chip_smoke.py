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
     fetch-add kernel (the gss launch is then timed from fresh counters,
     CUDA-event time per wrapper call, as every other row);
  3. the static Mandelbrot kernel at 4096x4096, CT 2000;
  4. the persistent Mandelbrot kernel over the gss, fac2 and ss schedules
     passed in (host-built claim tables) and claimed by the entry itself
     (the claim tables built on the card behind the protocol kernel, held
     exactly to the host's tables of the same schedule, there and at the
     paper's 1152x1152 one-pixel ss loop; then timed, the ``claim_tables``
     row beside numpy and a ``torch.sort`` version), then, timed, each
     worker's busy time alone against its modeled clock: the "workers"
     lines);
  5. PSIA spin images: 800,000 points (the paper's object size) and 8,192
     images, W=5, support angle 2.0, bin size 0.05 (and how many pairs the
     exact tests pass: the "gate" line and the row's bound);
  6. the tinyllama-1.1b forward at full width (22 layers, B=4 prompts of
     2048 tokens, random weights from seed 0) through ``api.forward`` with
     ``backend="pallas"`` (the static attention kernel in every layer) and
     ``backend="xla"`` (plain-tensor attention), in f32 and then in the
     config's bf16, where the two backends are held against each other and
     against the f32 forward;
  7. attention at tinyllama-1.1b's geometry (H=32, Hkv=4, D=64, T=2048,
     blocks 128x128) through ``flash_attention`` -- causal f32 and bf16
     (B=4), a sliding window of 512 and a non-causal Tq != Tk case -- and
     through ``flash_attention_persistent`` over a varlen batch (B=16,
     lengths drawn from seed 0) claimed by the device loop with gss, fac2
     and ss at P = the SM count; the SASS of the attention library must
     show tensor-core products (HGMMA) in both kernels' bf16 instances and
     in no f32 instance; then ``hybrid_attention_persistent`` over one
     period of MiMo-V2-Flash's attention at the benchmark cell's widths (1
     full layer of 64 q / 4 kv heads and 5 SWA layers of 64 / 8 with a
     128-key window and sinks; q.k 192, v 128; one full-length and one short
     row of T=16384), each layer's launch counted under its wide
     instance's own key, held to the plain version on its own tables and,
     on the valid rows, to the benchmark's plain reference, then each
     instance timed: the ``flash_attention_persistent_full`` and
     ``..._swa_sink`` rows; then ``moe_experts_persistent`` over the
     benchmark cell ``mimo-v2-flash-moe.skewed-ep16-gss``'s period of
     MiMo-V2-Flash's routed experts at its widths and token count (6
     layers, 131,072 tokens a layer over 256 experts onto 16 held, top-8,
     4096 -> 2048), every layer held to the benchmark's reference at the
     cell's limits and each loop's kernel and the combine to their plain
     versions on the layer's own schedules, then timed beside their bounds
     and ``torch._grouped_mm``: the ``moe_experts_up``, ``moe_experts_down``
     and ``moe_combine`` rows;
  8. mamba2-370m at full width (48 layers, d_model 1024, 32 SSD heads of
     dim 64, state 128; random weights from seed 0): ``api.forward`` on
     B=4 prompts of 2048 tokens with ``backend="pallas"`` (the SSD scan
     kernel in every layer) and ``backend="xla"``; ``api.prefill`` over
     1024 tokens and one ``decode_step`` against the forward; the bf16
     forward through the kernel and, swapped in by this script, through
     the scan's plain version, each held to the f32 forward; the serving
     engine (``Engine(backend="pallas")``) behind a ``ContinuousBatcher``
     of 4 workers over 64 requests (gss, the static split, then
     ``technique="auto"``: the replay sweep over the requests' ``max_new``,
     held to a direct ``choose_technique``); and the
     SSD scan kernel alone at the model's geometry and at one serving
     chunk (B=1 x 512).  The SASS of the scan library must show
     tensor-core products (HGMMA) in the bf16 body's tiled kernels and in
     nothing else;
  9. the discrete-event simulator at the paper's PSIA size (288,000 images,
     288 PEs of the 2:1 KNL/Xeon mix, each coordinator placement): 26 runs
     through ``dls.loop(...).execute(executor="sim")`` -- one- and
     two-sided over static, ss, gss, tss, fac2 and wf, hierarchical with 8
     nodes and inner ss -- each held to a direct ``simulate`` (and the
     one-sided unweighted ones to the host plan's chunk count), the same 26
     through ``simulate_many`` in 4 spawned workers, and the fast path's
     batch core with ``backend="torch"`` on the card against numpy (the
     contended ss case, P=1024, and PSIA ss, both under FIFO polling).  No
     kernel: the DES is a host algorithm, and its batch rounds are counted
     in ``repro_torch.sim.fast.TORCH_ROUNDS``, zeroed before each run;
 10. replay (``repro_torch.replay``): phase 2's gss and fac2 device reports
     as traces (coverage, a byte-stable JSONL round trip through a
     ``TraceStore``, equal to the same sessions drained on a CPU window;
     calibrated percent error, gantt); ``dls.loop(N, "auto", trace=...)``
     from the gss trace, whose best-ranked device technique is drained on
     the card and drives persistent Mandelbrot (== phase 3's image), and
     ``"auto"`` with ``runtime="device"``, which raises as in the
     reference; gss and fac2 sim traces at the PSIA size with CUDA up,
     their percent errors and full-N rankings (serial == 4 spawned
     workers) against ``tests/fixtures/torch_replay_psia.json``, written
     by the JAX package; and ``python -m repro_torch.replay`` record,
     calibrate, predict and gantt in subprocesses;
 11. real OS processes (``repro_torch.pt``): the 4096x4096 image of phase
     3 in 512 bands of 8 rows, ``dls.loop(512, t, P=P, window="shm")``
     drained by ``executor="processes"`` with P = min(8, cores) worker
     processes, each bringing up its own CUDA context (forkserver: CUDA is
     up in this process) and rendering its claimed bands with the static
     kernel -- one- and two-sided (the master in this process) over
     static, ss, gss and fac2, hierarchical gss over 2 nodes with inner
     ss, and fac2 with one PE killed mid-chunk (its prefix salvaged, the
     rest orphaned to survivors).  Every run must render each band exactly
     once with a digest equal to this process's serial render, each of
     whose bands is held to its own plain version and whose assembled
     image is held to phase 3's image and its plain version; then the
     window's RMW latency and contention at P = 1, 2, 4, 8, one run's
     trace calibrated with the measured ``o_rma``, and a chunk record's
     send down a worker's pipe against ``multiprocessing.Queue.put``;
 12. (run after 8) the model plane's decode paths at full width, one
     model at a time (random weights from seed 0; f32, then cast to the
     config's bf16):
     tinyllama-1.1b (22 layers; 4 prompts of 512 tokens, 32 greedy tokens,
     also through ``Engine(backend="pallas").generate``), h2o-danube-3-4b
     (24 layers, SWA 4096, head dim 120; 2 prompts of 4,608 tokens, so
     the prefill takes the ring, and 16 steps through it), zamba2-2.7b
     (54 mamba layers, 9 shared-block calls; 2 x 1024, 16 steps, the
     engine), qwen3-moe-235b-a22b (full width, 2 of 94 layers: the card's
     memory; 2 x 120 and 8 steps, dropless, timed at 4 x 512 where
     capacity drops pairs), seamless-m4t-medium (12 + 12 layers; 4
     sources of 1,024 stub frames, 240-token targets, 16 steps, the
     engine) and internvl2-26b (full width, 12 of 48 layers: the
     script's time; 256 stub prefix embeddings + 248 tokens, 8 steps).
     Each prefill and greedy decode step through ``api`` is held to one
     forward over the prompt and the generated tokens (f32: the
     reference's decode bar, atol = rtol = 2e-3), the two backends'
     forwards to each other (f32: 1e-3 of max |logit|), bf16 to bars set
     from sound runs; the static attention kernel must run once per
     uncached attention call and the SSD scan once per mamba layer of a
     forward or prefill, and never in a decode step.  Then both kernels
     at the geometries these models give them (head dims 80, 120 with
     the window, 64, 64 non-causal, 128; the scan at 80 heads, state 64)
     against their plain versions, timed beside SDPA and their bounds.
 13. (run after 12) training, on the "xla" backend (the kernels are not
     differentiable, as the reference's Pallas kernels are not; no kernel
     may launch in this phase): (a) the chunked attention's output and
     dq/dk/dv against the dense path through autograd at tinyllama-1.1b's
     geometry (B 1, T 2048, causal) and at h2o-danube-3-4b's (T 6144,
     SWA 4096), f32, at tests/test_flash_xla.py's bars; (b) the reduced
     tinyllama in f32, params through ``params_from_numpy``: three
     ``make_train_step`` steps and one with 2 microbatches on the card
     against the same on the CPU (losses and grad_norm within 1e-5
     relative, the params' distance within 1e-3 of the distance moved),
     every remat policy's gradients against "none"'s; (c) tinyllama-1.1b
     at full width (22 layers, bf16 params, f32 AdamW state) through
     ``Trainer``: 4 steps of B=4 x T=2048 from the DLS sampler (fac2),
     remat "full" (without remat the dense f32 scores of 22 layers do
     not fit), finite losses, params changed; then one step per policy
     (full, dots, group:11) on one batch, losses within 1e-2 of full's,
     and the split of a step into forward, backward and AdamW; (d) one
     step at B=1 x T=8192, past the chunked threshold (its backward runs
     once a layer); (e) a checkpoint of the full-width params and state
     (2 layers) restored bit for bit, and a Trainer stopped and resumed
     equal to an unbroken one.  Per step: CUDA-event and wall ms,
     tokens/s, peak GiB.
 14. (run after 13) sharding: a one-rank NCCL group and
     ``make_test_mesh(1)``, a (data=1, model=1) mesh.  tinyllama-1.1b at
     full width (22 layers, B 4 x T 512, seed 0), params placed by
     ``distribute(params, params_pspecs(...))``: ``api.forward(...,
     ctx=make_ctx(mesh), backend="pallas")`` against the same forward
     without ctx (f32 within 1e-6, bf16 within 1e-3 of max |logit|; 22
     attention launches each), prefill and one greedy decode step, one
     ``make_train_step(ctx=..., microbatches=2)`` step (loss within 1e-6
     relative); mamba2-370m at full width the same way (48 SSD-scan
     launches a forward); each call's CUDA-event and wall ms with and
     without ctx (their difference: what DTensor dispatch and
     ``local_map`` cost a call); ``python -m repro_torch.launch.serve
     --arch tinyllama-1.1b --no-reduced`` as a subprocess; the device
     hierarchy drained by ``dls.loop(90, "fac2", P=2,
     runtime="hierarchical")``.  The group is destroyed before phase 11.
 15. (run after 11) the examples (``examples/*_torch.py``) at their own
     full width: ``dls_mandelbrot_torch --width 4096 --ct 2000 --workers
     8`` in this process (512 launches of the static kernel from 8
     threads, the image equal to phase 11's serial band render), then
     ``train_e2e_torch --preset 100m`` (113M parameters, batch 8 x 512)
     for 25 steps and a re-run to 30 that resumes at step 25 (ms a step,
     tokens/s, peak memory, checkpoint times), and quickstart, serve_dls,
     dls_hierarchical, serve_open_loop and dls_processes as subprocesses,
     each held to its asserts and last line, with no child left after
     dls_processes.

The launch counts are zeroed just before each path (2-5, 6, 7 and its
hybrid and MoE stacks, 8, 10's run of the selected technique, 11, whose
worker processes count their own launches into shared memory, each model
of 12, and 15's Mandelbrot example) and read just after.
Every kernel is then held against its plain PyTorch version on the same
inputs, every schedule against the host plan, the two model backends
against each other, and each kernel is timed with CUDA events
beside its plain version, its bound and, for attention, PyTorch's
``scaled_dot_product_attention`` (a yardstick only; the port never calls
it).  The script exits non-zero without a result line when there is no
card or no package beside it, and on any failed check.
"""
from __future__ import annotations

import json
import re
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
# Attention's multiply-adds could run as FMAs: its operations count at the
# f32 rate of 67 TFLOP/s, and for bf16 inputs at the 989 TFLOP/s bf16
# tensor-core rate.
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

TECHNIQUES = ("static", "ss", "gss", "tss", "fac2")
IMG, CT, TILE = 4096, 2000, 64
PIXELS = 1152  # the paper's image (arXiv:1901.02773, Fig. 5), one pixel an iteration
PIXEL_CT = 1000  # ... and its iteration cap
N_POINTS, N_IMAGES, IMG_W, SUPPORT, BIN = 800_000, 8192, 5, 2.0, 0.05
# Mandelbrot: 13 f32 arithmetic operations and one compare per iteration
# (|z|^2's two products are the next iteration's zr*zr and zi*zi); bounds
# that count those products anew (16 operations) are printed beside
MANDEL_OPS_PER_ITER, MANDEL_OPS_PER_ITER_ANEW = 14, 16
# spin images: every pair needs beta and two compares (diff 3, beta 5);
# only pairs whose bin row k is in [0, W) need the other 24 (r2 5, alpha 4,
# cos 5, bins 5, gates 5); the all-pairs bound counts 32 for every pair
SPIN_OPS_PER_PAIR, SPIN_OPS_K_PAIR = 8, 24
REPS = 5


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def become_subreaper() -> None:
    """Make this process its descendants' reaper (Linux
    ``PR_SET_CHILD_SUBREAPER``): a worker whose parent (the forkserver)
    exits before it does becomes a child here, where ``stop_children``
    sees it, and not init's."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    check(libc.prctl(36, 1, 0, 0, 0) == 0,
          f"prctl(PR_SET_CHILD_SUBREAPER): errno {ctypes.get_errno()}")


def _children() -> list:
    """(pid, command) of every process whose parent is this one."""
    import os

    me, kids = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            stat = Path(f"/proc/{name}/stat").read_text()
            cmd = Path(f"/proc/{name}/cmdline").read_bytes()
        except OSError:  # exited meanwhile
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == me:
            kids.append((int(name), cmd.replace(b"\0", b" ").decode(errors="replace")[:160]))
    return kids


def _reap(grace_s: float, keep=()) -> list:
    """Wait up to ``grace_s`` for every child but ``keep`` to exit, reaping
    each; SIGKILL what is left, and return (pid, command) of those."""
    import os
    import signal

    deadline, killed = time.monotonic() + grace_s, []
    while True:
        kids = [k for k in _children() if k[0] not in keep]
        for pid, _ in kids:
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
        kids = [k for k in _children() if k[0] not in keep]
        if not kids:
            return killed
        if time.monotonic() > deadline:
            for pid, cmd in kids:
                os.kill(pid, signal.SIGKILL)
                try:
                    os.waitpid(pid, 0)
                except ChildProcessError:
                    pass
                killed.append((pid, cmd))
        time.sleep(0.05)


def stop_children(grace_s: float = 20.0) -> list:
    """Stop every process this script started before it exits: the
    forkserver the processes executor started (with torch preloaded its
    exit takes a while, and it would outlive the script), then every other
    child, then multiprocessing's resource tracker (it exits once the last
    holder of its pipe has).  Returns (pid, command) of each process that
    was still running after ``grace_s`` and had to be killed."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()  # EOF on its pipe; waits for it to exit
    tracker = resource_tracker._resource_tracker
    killed = _reap(grace_s, keep={tracker._pid})
    tracker._stop()
    return killed + _reap(grace_s)


def cuda_ms(fn, reps: int = REPS, warmup: bool = True, per: int = 1):
    """Median of ``reps`` CUDA-event timings of ``fn()``, after one warm-up
    unless ``warmup`` is false.  With ``per`` > 1 each timing spans that
    many calls back to back and is divided by it: the card's time per call
    once the host runs ahead, where one call alone would also time its
    host-side set-up."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
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


def bound(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes / HBM rate, ops / op rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_row(name, source, replaces, launches, max_abs_err, ms, plain_ms,
               bound_ms_by, library_ms, plain_where="card"):
    """One entry of the ``kernels`` result line, printed as it is made."""
    b_ms, b_by = bound_ms_by
    print(f"time {name}: {ms!r} ms; plain ({plain_where}) {plain_ms!r} ms; "
          f"bound {b_ms!r} ms ({b_by}); library {library_ms!r} ms")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max_abs_err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def worker_iterations(schedule, costs):
    """(P,) float64: each worker's modeled busy time, the sum of the escape
    counts of the tiles its claim table holds."""
    import numpy as np

    nclaims, _, starts, sizes = schedule.tables()
    csum = np.concatenate(([0.0], np.cumsum(costs, dtype=np.float64)))
    owner = np.repeat(np.arange(len(nclaims)), nclaims)
    return np.bincount(owner, weights=csum[starts + sizes] - csum[starts],
                       minlength=len(nclaims))


def worker_times(schedule, run):
    """(P,) ms: each worker's busy time on the card, alone -- ``run`` over
    the claim tables with every other worker's ``nclaims`` zeroed, one
    CUDA-event timing each (after one warm-up of the whole schedule)."""
    import numpy as np
    import torch

    nclaims, *flat = card_tables(schedule, torch.device("cuda", 0))
    run(nclaims, *flat)
    times = []
    for w in range(len(nclaims)):
        only = torch.zeros_like(nclaims)
        only[w] = nclaims[w]
        times.append(cuda_ms(lambda: run(only, *flat), reps=1, warmup=False))
    return np.array(times)


def card_tables(schedule, dev):
    """``schedule``'s claim tables on the card, by the entries' own route
    (``persistent_tables`` with the schedule passed in: built on the host,
    uploaded)."""
    from repro_torch.device.persistent import persistent_tables

    return persistent_tables(schedule.technique, schedule.N, schedule.P, schedule=schedule,
                             device=dev)[0]


def card_tables_error(card, schedule) -> int:
    """max |card - host| over the claim tables the card built behind the
    protocol kernel (``PendingClaim.tables``, read back) against the host's
    flat ``schedule.tables()`` and, worker by worker, its padded
    ``worker_lists()``; 0 when they are equal."""
    import numpy as np

    card = [t.cpu().numpy().astype(np.int64) for t in card]
    host = schedule.tables()
    err = max((int(np.abs(c[:len(h)] - h).max()) if len(h) else 0)
              for c, h in zip(card, host))
    nclaims, first, starts, sizes = card
    w_n, w_starts, w_sizes = schedule.worker_lists()
    err = max(err, int(np.abs(nclaims - w_n).max()))
    for w, n in enumerate(w_n):
        at = slice(first[w], first[w] + n)
        for c, h in ((starts[at], w_starts[w, :n]), (sizes[at], w_sizes[w, :n])):
            if n:
                err = max(err, int(np.abs(c - h).max()))
    return err


def tables_by_sort(claim):
    """The claim tables by PyTorch library calls on the card, the same
    layout as the table kernels': a stable sort of the schedule's rows by
    worker (ungranted rows last), two gathers, the counts' exclusive
    prefix sum."""
    import torch

    sched, counts = claim._sched, claim._counts
    key = torch.where(sched[:, 1] >= 0, sched[:, 1], claim.P)
    rows = sched[torch.sort(key, stable=True).indices]
    return (counts, (torch.cumsum(counts, 0) - counts).int(),
            rows[:, 2].contiguous(), rows[:, 3].contiguous())


def claim_tables_bytes(schedule, S: int, chunk: int) -> int:
    """DRAM bytes the three table kernels move: the rank kernel reads the
    granted rows (16 bytes each, their sectors) and one group of 32 rows a
    chunk past them, writes a rank a granted row and a count a worker a
    chunk; the offset kernel reads and writes the chunk counts; the scatter
    reads every row and the granted rows' ranks and writes 8 bytes a
    grant."""
    n, P, chunks = schedule.n_steps, schedule.P, max(1, -(-S // chunk))
    return 16 * (n + 32 * chunks) + 4 * n + 12 * chunks * P + 16 * S + 4 * n + 8 * n


def report_workers(name, real_ms, iters, full_ms):
    """Print the per-worker real / modeled line: the spread of the ratio
    says whether the cost model (modeled iterations) tracks what the body
    pays, apart from the schedule's modeled imbalance."""
    ratio = real_ms / iters.clip(min=1.0) * 1e9  # ms per 1e9 iterations
    r = [float(x) for x in ratio[iters > 0]]
    heavy = int(iters.argmax())
    print(f"workers {name}: real / modeled = {statistics.median(r)!r} ms per "
          f"1e9 iterations (median), min {min(r)!r}, max {max(r)!r}, max/min "
          f"{max(r) / min(r)!r}, cv {statistics.pstdev(r) / statistics.mean(r)!r}; "
          f"modeled makespan / ideal {float(iters.max() / iters.mean())!r}; "
          f"alone: slowest worker {float(real_ms.max())!r} ms (worker "
          f"{int(real_ms.argmax())}), heaviest modeled worker (worker {heavy}) "
          f"{float(real_ms[heavy])!r} ms; whole grid {full_ms!r} ms")


def claims_in_grant_order(rep):
    rows = sorted((c.step, pe, c.start, c.size)
                  for pe, per in enumerate(rep.per_pe_claims) for c in per)
    return [list(col) for col in zip(*rows)]


# attention at tinyllama-1.1b's geometry; the varlen draw of
# benchmarks/kernels_selfsched.py:86-88 (lengths first, from seed 0)
ATT_H, ATT_HKV, ATT_D, ATT_T, ATT_BLK = 32, 4, 64, 2048, 128
ATT_B, VARLEN_B, SWA, PERSISTENT_TECHNIQUES = 4, 16, 512, ("gss", "fac2", "ss")
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
MODEL, MODEL_B, MODEL_T = "tinyllama-1.1b", 4, 2048
# mamba2-370m: the forward, prefill/decode and serving phase
SSM_MODEL, SSM_B, SSM_T, SSM_PREFIX = "mamba2-370m", 4, 2048, 1024
SERVE_N, SERVE_PROMPT, SERVE_WORKERS, SERVE_MAX_NEW = 64, 512, 4, (8, 64)
SSD_SOURCE = "src/repro_torch/csrc/ssd_scan.cu"
SSD_CHUNK = 128
# prefill and decode against the forward, of max |logit|: sound runs on the
# H100 read at most 1.0e-6 (prefill) and 2.5e-5 (decode); the planted decode
# faults of phase 8 must read above the decode bar
PREFILL_DECODE_BARS = {"prefill": 2e-5, "decode": 2e-4}
# bf16 attention against its plain version: |kernel - plain| <= 3e-2 and
# <= 5e-3 + 1e-2 |plain|.  The relative part covers the output's bf16
# rounding, the absolute part ("slack", printed) the rounding of p before
# P.V; the planted faults of tests/test_torch_attention.py must fail it
BF16_BAR, BF16_ATOL, BF16_RTOL = 3e-2, 5e-3, 1e-2
# the tinyllama bf16 forward: max |pallas - xla| <= 5e-2 of max |logit|,
# and the pallas forward's RMS distance to the f32 forward at most 1.1
# times the xla backend's (PERF.md, PR 14: the sound readings)
MODEL_BF16_BAR, MODEL_BF16_RMS = 5e-2, 1.1
# the DES at the paper's PSIA size (core/sim.py:262, benchmarks/fig4_psia.py)
DES_N, DES_P, DES_NODES, DES_WORKERS = 288_000, 288, 8, 4
DES_TECHNIQUES = ("static", "ss", "gss", "tss", "fac2", "wf")
DES_RTOL = 1e-9  # the torch batch core's contract against numpy
# phase 10: the PSIA rankings and percent errors, written by the JAX package
# (tests/_torch_replay_cases.py)
REPLAY_FIXTURE = "tests/fixtures/torch_replay_psia.json"


def close(a, b, atol: float, rtol: float = 0.0):
    """(all |a - b| <= atol + rtol * |b|, max |a - b|) over f32 copies."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return bool((d <= atol + rtol * b.abs()).all()), float(d.max())


def bf16_close(a, b):
    """(a within both bf16 bars of b, max |a - b|, the absolute slack
    max(|a - b| - BF16_RTOL |b|) that the relative bar leaves to atol)."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    slack = d - BF16_RTOL * b.abs()
    ok = bool((d <= BF16_BAR).all()) and float(slack.max()) <= BF16_ATOL
    return ok, float(d.max()), float(slack.max())


def causal_pairs(T: int, L: int) -> int:
    """(row, key) pairs a causal head of T rows attends over L valid keys."""
    return L * (L + 1) // 2 + (T - L) * L


def sass_functions(lib: Path) -> dict:
    """``cuobjdump -sass`` of a built library: mangled kernel name -> its
    SASS text."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib.name}: {out.stderr.strip()}")
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {n: "\n".join(body) for n, body in funcs.items()}


def ptxas_report(log: str) -> dict:
    """``-Xptxas -v`` output: mangled kernel -> its registers, spills and
    static shared memory, as ptxas printed them."""
    report, name = {}, None
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            report[name] = []
        elif name is not None and ("spill" in line or "registers" in line):
            report[name].append(line.replace("ptxas info    : ", ""))
    return {n: "; ".join(v) for n, v in report.items()}


def protocol_sass() -> None:
    """Phase 6: the protocol library's ptxas registers, spills and shared
    memory, by instance (R = the clocks a lane keeps in registers; 0: in
    shared memory)."""
    from repro_torch.kernels import _build

    for n, info in sorted(ptxas_report(_build.BUILD_LOGS.get("protocol", "")).items()):
        inst = re.search(r"protocol_kernelILi(\d+)E", n)
        name = f"protocol_kernel<{inst.group(1)}>" if inst else n
        print(f"ptxas {name}: {info}")


def attention_sass() -> None:
    """Phase 7, the build: both attention kernels' bf16 instances run their
    products on the tensor cores (HGMMA in the SASS), the f32 instances do
    not; prints each instance's ptxas registers, spills and shared memory."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.build(["flash_attention"])["flash_attention"]
    ptxas = ptxas_report(_build.BUILD_LOGS.get("flash_attention", ""))
    smem = _build.function("flash_attention", "repro_flash_attention_smem", ctypes.c_int,
                           ctypes.c_int)
    seen = set()
    for n, body in sorted(sass_functions(lib).items()):
        # fa_<kind>_kernel<T, W>, mangled: T is f (float) or 13__nv_bfloat16;
        # the wide persistent instances fa_persistent_<full|swa_sink>_kernel<DQK, DV>
        inst = re.search(r"(fa_(?:static|persistent)_kernel)I(f|13__nv_bfloat16)Li(\d+)E", n)
        wide = re.search(r"(fa_persistent_(?:full|swa_sink)_kernel)ILi(\d+)ELi(\d+)E", n)
        if inst is None and wide is None:
            continue
        if wide is not None:
            kernel, bf16, width, v_width = wide[1], True, int(wide[2]), int(wide[3])
            name = f"{kernel}<{width}, {v_width}>"
        else:
            kernel, bf16, width = inst[1], inst[2] != "f", int(inst[3])
            v_width = width
            name = f"{kernel}<{'bf16' if bf16 else 'f32'}, {width}>"
        hgmma = body.count("HGMMA")
        seen.add((kernel, bf16))
        extra = f"; {smem(width, v_width)} bytes of dynamic shared memory" if bf16 else ""
        print(f"sass {name}: {hgmma} HGMMA; ptxas {ptxas.get(n, 'not built here')}{extra}")
        check(hgmma > 0 if bf16 else hgmma == 0,
              f"{name}: HGMMA {'expected' if bf16 else 'not expected'} ({hgmma})")
    check(seen == {(k, b) for k in ("fa_static_kernel", "fa_persistent_kernel")
                   for b in (False, True)} | {("fa_persistent_full_kernel", True),
                                              ("fa_persistent_swa_sink_kernel", True)},
          f"attention instances in the SASS: {seen}")


def sdpa_ms(q, k, v, **kw):
    """CUDA-event time of PyTorch's fused attention on the same inputs: the
    yardstick for ``library_ms``."""
    import torch.nn.functional as F

    return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                          **kw))


def attention_path(dev, P: int, static_launches: int):
    """Phase 7: both attention kernels at tinyllama-1.1b's geometry, checked
    against their plain versions and the dense oracle, then timed.
    ``static_launches`` is the static kernel's count on the model path, the
    real caller of it; returns the two kernel rows."""
    import numpy as np
    import torch

    from repro_torch.kernels import (
        _build, attention_oracle, flash_attention, flash_attention_persistent)
    from repro_torch.kernels.flash_attention.kernel import _flash_plain
    from repro_torch.kernels.flash_attention.persistent import (
        _persistent_cuda, _persistent_plain, varlen_tile_costs)

    attention_sass()
    H, Hkv, D, T, blk, B, VB = ATT_H, ATT_HKV, ATT_D, ATT_T, ATT_BLK, ATT_B, VARLEN_B
    nq, scale = T // blk, D ** -0.5
    lengths = np.random.default_rng(0).integers(T // 8, T + 1, VB).astype(np.int32)
    g = torch.Generator(device=dev).manual_seed(0)
    qv = torch.randn((VB, H, T, D), generator=g, device=dev)
    kv, vv = (torch.randn((VB, Hkv, T, D), generator=g, device=dev) for _ in range(2))
    q, k, v = qv[:B], kv[:B], vv[:B]
    qc = qv[B:B + 2, :, :T // 2].contiguous()  # Tq = 1024 against Tk = 2048
    q16, k16, v16, qv16, kv16, vv16 = (
        t.to(torch.bfloat16) for t in (q, k, v, qv, kv, vv))
    torch.cuda.synchronize()

    _build.reset_launches()
    t_path = time.perf_counter()
    blocks = {"blk_q": blk, "blk_k": blk}
    static = {
        "f32": flash_attention(q, k, v, causal=True, **blocks),
        "bf16": flash_attention(q16, k16, v16, causal=True, **blocks),
        "swa": flash_attention(q[:2], k[:2], v[:2], causal=True, window=SWA, **blocks),
        "cross": flash_attention(qc, k[:2], v[:2], causal=False, **blocks),
    }
    pers = {t: flash_attention_persistent(qv, kv, vv, lengths=lengths, causal=True,
                                          technique=t, workers=P, **blocks)
            for t in PERSISTENT_TECHNIQUES}
    pers16, sched16 = flash_attention_persistent(qv16, kv16, vv16, lengths=lengths,
                                                 causal=True, workers=P, **blocks)
    full, _ = flash_attention_persistent(q, k, v, causal=True, workers=P, **blocks)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"attention path: {time.perf_counter() - t_path:.2f} s wall, launches "
          f"{ {n: launches[n] for n in ('protocol', 'flash_attention', 'flash_attention_persistent')} }")
    for n in ("protocol", "flash_attention", "flash_attention_persistent"):
        check(launches[n] > 0, f"kernel {n} was not launched on the attention path")

    # checks: the static kernel against its plain version and the oracle
    cases = {"f32": ((q, k, v), {"causal": True}),
             "bf16": ((q16, k16, v16), {"causal": True}),
             "swa": ((q[:2], k[:2], v[:2]), {"causal": True, "window": SWA}),
             "cross": ((qc, k[:2], v[:2]), {"causal": False})}
    err = {}
    for name, (args, kw) in cases.items():
        kw.update(blocks)
        out = static[name]
        check(out.shape == args[0].shape and out.dtype == args[0].dtype
              and bool(out.isfinite().all()), f"static {name}: shape, dtype, finite")
        if name == "bf16":
            ok, err[name], slack = bf16_close(out, _flash_plain(*args, **kw))
            bar = f"{BF16_BAR} and {BF16_ATOL} + {BF16_RTOL} |plain|; slack {slack!r}"
        else:
            ok, err[name] = close(out, _flash_plain(*args, **kw), 2e-5, 2e-5)
            bar = "2e-5"
        check(ok, f"static {name}: kernel == plain within {bar} (max {err[name]!r})")
        print(f"flash_attention {name} {tuple(args[0].shape)} {kw}: max |kernel - "
              f"plain| {err[name]!r} (bar {bar})")
    ok, d = close(static["f32"], attention_oracle(q, k, v, causal=True), 2e-5, 2e-5)
    check(ok, f"static f32: kernel == dense oracle within 2e-5 (max {d!r})")
    ok, wide, slack = bf16_close(static["bf16"], _flash_plain(
        q16.float(), k16.float(), v16.float(), causal=True, **blocks))
    check(ok, f"static bf16: kernel == plain f32 over the same bf16 inputs within the "
              f"bf16 bars (max {wide!r}, slack {slack!r})")
    print(f"flash_attention bf16: max |kernel - plain bf16| {err['bf16']!r}; max |kernel - "
          f"plain f32 over the same bf16 inputs| {wide!r} (slack {slack!r})")

    # checks: the persistent kernel over the varlen batch
    N = VB * H * nq
    costs = varlen_tile_costs(lengths, H, nq, blk, blk, True)
    refs = [attention_oracle(qv[b:b + 1], kv[b:b + 1, :, :L], vv[b:b + 1, :, :L],
                             causal=True) for b, L in enumerate(lengths)]
    for t, (out, sched) in pers.items():
        check(int(sched.sizes.sum()) == N, f"persistent {t}: sizes.sum() == N")
        d_ref = max(close(out[b:b + 1], r, 1e-5)[1] for b, r in enumerate(refs))
        check(d_ref <= 1e-5, f"persistent {t}: rows == oracle within 1e-5 (max {d_ref!r})")
        ok, d_plain = close(out, _persistent_plain(
            *sched.tables(), qv, kv, vv, lengths, causal=True, scale=scale,
            blk_q=blk, blk_k=blk), 1e-5)
        check(ok, f"persistent {t}: kernel == plain within 1e-5 (max {d_plain!r})")
        err.setdefault("persistent_f32", d_plain)
        print(f"schedule {t}: N={N} P={P} steps={sched.n_steps} modeled makespan / "
              f"ideal {float(sched.makespan() / (costs.sum() / P))!r}; max |kernel - "
              f"oracle| {d_ref!r}, |kernel - plain| {d_plain!r}")
    ok, d = close(full, static["f32"], 1e-5)
    check(ok, f"persistent (full lengths) == static within 1e-5 (max {d!r})")
    tables16 = sched16.tables()
    ok, err["persistent_bf16"], slack = bf16_close(pers16, _persistent_plain(
        *tables16, qv16, kv16, vv16, lengths, causal=True, scale=scale,
        blk_q=blk, blk_k=blk))
    check(ok, f"persistent bf16: kernel == plain within the bf16 bars "
              f"(max {err['persistent_bf16']!r}, slack {slack!r})")
    ok, wide, slack32 = bf16_close(pers16, _persistent_plain(
        *tables16, qv16.float(), kv16.float(), vv16.float(), lengths, causal=True,
        scale=scale, blk_q=blk, blk_k=blk))
    check(ok, f"persistent bf16: kernel == plain f32 over the same bf16 inputs within "
              f"the bf16 bars (max {wide!r}, slack {slack32!r})")
    print(f"persistent (full lengths) == static: max {d!r}; bf16 kernel vs plain bf16 "
          f"{err['persistent_bf16']!r} (slack {slack!r}), vs plain f32 over the same "
          f"bf16 inputs {wide!r} (slack {slack32!r})")

    # times: bf16 (the model's type) in the rows, f32 printed beside them
    def persistent_ms(sched, args):
        tables = card_tables(sched, dev)
        return cuda_ms(lambda: _persistent_cuda(*tables, *args, lengths, causal=True,
                                                scale=scale, blk_q=blk, blk_k=blk))

    pairs = B * H * causal_pairs(T, T)
    var_pairs = H * sum(causal_pairs(T, int(L)) for L in lengths)
    cols = torch.arange(T, device=dev)
    var_mask = ((cols[None, :] <= cols[:, None])[None, None]
                & (cols < torch.as_tensor(lengths, device=dev)[:, None, None, None]))
    out_rows = []
    for dt, (sq, sk, sv, lq, lk, lv), rate in (
            ("f32", (q, k, v, qv, kv, vv), F32_FLOPS_PER_S),
            ("bf16", (q16, k16, v16, qv16, kv16, vv16), BF16_FLOPS_PER_S)):
        size = sq.element_size()
        ms = cuda_ms(lambda: flash_attention(sq, sk, sv, causal=True, **blocks))
        plain = cuda_ms(lambda: _flash_plain(sq, sk, sv, causal=True, **blocks))
        lib = sdpa_ms(sq, sk, sv, is_causal=True)
        b_static = bound(size * 2 * (sq.numel() + sk.numel()), 4 * D * pairs, rate)
        print(f"time flash_attention {dt} B={B}: {ms!r} ms "
              f"({4 * D * pairs / ms / 1e9!r} TFLOP/s); plain {plain!r} ms; "
              f"sdpa {lib!r} ms; bound {b_static[0]!r} ms ({b_static[1]})")
        sched = sched16 if dt == "bf16" else pers["gss"][1]
        tables = sched.tables()
        for t in PERSISTENT_TECHNIQUES:
            print(f"time flash_attention_persistent {dt} over the {t} schedule: "
                  f"{persistent_ms(pers[t][1], (lq, lk, lv))!r} ms")
        p_ms = persistent_ms(sched, (lq, lk, lv))
        p_plain = cuda_ms(lambda: _persistent_plain(
            *tables, lq, lk, lv, lengths, causal=True, scale=scale, blk_q=blk, blk_k=blk))
        p_static = cuda_ms(lambda: flash_attention(lq, lk, lv, causal=True, **blocks))
        p_lib = sdpa_ms(lq, lk, lv, attn_mask=var_mask)
        b_var = bound(size * 2 * (lq.numel() + lk.numel())
                      + 4 * (VB + 2 * P + 2 * tables.starts.size), 4 * D * var_pairs, rate)
        print(f"time varlen {dt} B={VB}: persistent (gss) {p_ms!r} ms "
              f"({4 * D * var_pairs / p_ms / 1e9!r} TFLOP/s); static over "
              f"the padded batch {p_static!r} ms; plain {p_plain!r} ms; sdpa with a "
              f"length mask {p_lib!r} ms; bound {b_var[0]!r} ms ({b_var[1]})")
    # the loop leaves the bf16 numbers: those are the rows
    out_rows.append(kernel_row(
        "flash_attention", FA_SOURCE, "src/repro/kernels/flash_attention/kernel.py:27",
        static_launches, err["bf16"], ms, plain, b_static, lib))
    out_rows.append(kernel_row(
        "flash_attention_persistent", FA_SOURCE,
        "src/repro/kernels/flash_attention/persistent.py:30",
        launches["flash_attention_persistent"], err["persistent_bf16"], p_ms,
        p_plain, b_var, p_lib))
    return out_rows


# phase 7's hybrid stack: one period of MiMo-V2-Flash's attention at the
# cell mimo-v2-flash-attn.period-mixed-gss's widths, over a full-length row
# and a short one (the cell's 8 rows would hold 36 GB; the plain version
# walks every tile side by side)
HYB_H, HYB_D, HYB_DV, HYB_T, HYB_WINDOW = 64, 192, 128, 16384, 128
HYB_LAYERS = ((4, None),) + ((8, HYB_WINDOW),) * 5  # (kv heads, window) a layer
HYB_LENGTHS = (16384, 1000)


def hybrid_path(dev, P: int):
    """Phase 7, the hybrid stack: ``hybrid_attention_persistent`` over one
    period (1 full + 5 SWA layers with sinks) at MiMo-V2-Flash's widths;
    every layer held to ``_persistent_plain`` on its schedule's tables
    within the bf16 bars and on its valid rows to the benchmark's plain
    reference, padding rows zero; then each wide instance timed alone on
    its layer's tables.  Returns the two kernel rows."""
    import math

    import numpy as np
    import torch

    from loopbench.reference import hybrid_attention as ref
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.persistent import (
        LAUNCH_KEYS, _persistent_cuda, _persistent_plain, hybrid_attention_persistent)

    lengths = np.array(HYB_LENGTHS, np.int32)
    B, H, T, D, Dv, blk = len(lengths), HYB_H, HYB_T, HYB_D, HYB_DV, ATT_BLK
    scale, N = D ** -0.5, len(lengths) * HYB_H * (HYB_T // ATT_BLK)
    g = torch.Generator(device=dev).manual_seed(0)
    layers = []
    for Hkv, window in HYB_LAYERS:
        q, k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
                   for shape in ((B, H, T, D), (B, Hkv, T, D), (B, Hkv, T, Dv)))
        sinks = (None if window is None
                 else math.log(128.0) + torch.randn(H, generator=g, device=dev))
        layers.append((q, k, v, window, sinks))
    torch.cuda.synchronize()

    _build.reset_launches()
    t_path = time.perf_counter()
    got = hybrid_attention_persistent(layers, lengths=lengths, blk_q=blk, blk_k=blk,
                                      technique="gss", workers=P)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {"protocol": len(layers), "flash_attention_persistent": 0, LAUNCH_KEYS[0]: 1,
            LAUNCH_KEYS[1]: len(layers) - 1}
    print(f"hybrid path: {time.perf_counter() - t_path:.2f} s wall, launches "
          f"{ {n: launches[n] for n in want} }")
    for n, c in want.items():
        check(launches[n] == c, f"hybrid path: {c} {n} launches, got {launches[n]}")

    err = {}
    for i, ((q, k, v, window, sinks), (out, sched)) in enumerate(zip(layers, got)):
        name = LAUNCH_KEYS[window is not None]
        check(out.shape == (B, H, T, Dv) and out.dtype == torch.bfloat16
              and bool(out.isfinite().all()), f"hybrid layer {i}: shape, dtype, finite")
        check(int(sched.sizes.sum()) == N, f"hybrid layer {i}: sizes.sum() == N")
        ok, d, slack = bf16_close(out, _persistent_plain(
            *sched.tables(), q, k, v, lengths, causal=True, scale=scale, blk_q=blk,
            blk_k=blk, window=window, sinks=sinks, zero_padding=True))
        check(ok, f"hybrid layer {i} ({name}): kernel == plain within the bf16 bars "
                  f"(max {d!r}, slack {slack!r})")
        d_ref = s_ref = 0.0
        for b, L, r in ref.varlen_attention(q, k, v, lengths, window=window, sinks=sinks):
            ok, d_b, s_b = bf16_close(out[b, :, :L], r)
            d_ref, s_ref = max(d_ref, d_b), max(s_ref, s_b)
            check(ok, f"hybrid layer {i} ({name}), row {b}: valid rows == reference within "
                      f"the bf16 bars (max {d_b!r}, slack {s_b!r})")
            check(not out[b, :, L:].any(), f"hybrid layer {i}, row {b}: padding rows zero")
        err[name] = max(err.get(name, 0.0), d)
        print(f"hybrid layer {i} {name} window={window}: max |kernel - plain| {d!r} "
              f"(slack {slack!r}); valid rows vs reference {d_ref!r} (slack {s_ref!r}); "
              f"{sched.n_steps} gss grants")

    rows = []
    for name, i in zip(LAUNCH_KEYS, (0, 1)):  # the full layer, the first SWA layer
        q, k, v, window, sinks = layers[i]
        tables = got[i][1].tables()
        card = card_tables(got[i][1], dev)
        kw = {"causal": True, "scale": scale, "blk_q": blk, "blk_k": blk, "window": window,
              "sinks": sinks, "zero_padding": True}
        ms = cuda_ms(lambda: _persistent_cuda(*card, q, k, v, lengths, **kw))
        plain = cuda_ms(lambda: _persistent_plain(*tables, q, k, v, lengths, **kw),
                        reps=1, warmup=False)
        w = ref.layer_work(lengths, H, k.shape[1], D, Dv, window, q.element_size())
        b_ms = bound(w["bytes"], w["ops"], BF16_FLOPS_PER_S)
        print(f"time {name} (layer {i}, {w['pairs']} valid pairs): {ms!r} ms "
              f"({w['ops'] / ms / 1e9!r} TFLOP/s, {w['bytes'] / ms / 1e6!r} GB/s; "
              f"{100 * b_ms[0] / ms!r} % of the bound)")
        rows.append(kernel_row(
            name, FA_SOURCE, "src/repro/kernels/flash_attention/persistent.py:30",
            launches[name], err[name], ms, plain, b_ms, None))
    return rows


MOE_CELL = "mimo-v2-flash-moe.skewed-ep16-gss"  # the benchmark cell whose inputs phase 7 drains
MOE_SOURCE = "src/repro_torch/csrc/moe_experts.cu"
MOE_REPLACES = "src/repro/models/layers.py:478"
# |kernel - plain| <= atol + rtol |plain|: tests/test_torch_moe_experts.py's bf16 bars
MOE_ATOL, MOE_RTOL = 5e-3, 1e-2


def moe_path(dev):
    """Phase 7, the routed experts: ``moe_experts_persistent`` over the
    benchmark cell's period at its widths and token count (6 MoE layers of
    MiMo-V2-Flash, 131,072 tokens a layer routed over 256 experts onto the
    16 held, inputs from the cell's driver at seed 0), its launches counted
    and every layer held to the benchmark's plain reference at the cell's
    limits; then, on each layer's own schedules, both loops' kernels against
    their plain versions within the tests' bf16 bars (the down loop reading
    the card's h), the combine against its plain version and the entry's
    partial sum exactly; then layer 0's three kernels timed beside their
    bounds and ``torch._grouped_mm`` (a yardstick only; the port never calls
    it).  Returns the three kernel rows."""
    import numpy as np
    import torch

    from loopbench import harness
    from loopbench.drivers.moe_experts import Driver
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_experts import kernel as moe
    from repro_torch.kernels.moe_experts.persistent import (
        expert_tiles, moe_experts_persistent, route, sort_assignments)

    wl = harness.workload(MOE_CELL)
    drv = Driver({**wl["traffic"], "token_sets": 1}, harness.config(wl["config"]), 0, dev)
    layers, e0, e1, top_k = drv.layers(0), drv.e0, drv.e1, drv.top_k
    d, ff, E = drv.d, drv.ff, drv.e1 - drv.e0
    torch.cuda.synchronize()

    _build.reset_launches()
    t_path = time.perf_counter()
    got = moe_experts_persistent(layers, experts=(e0, e1), top_k=top_k,
                                 technique=wl["traffic"]["technique"], workers=drv.P)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    L = len(layers)
    want = {"protocol": 2 * L, "moe_experts_up": L, "moe_experts_down": L, "moe_combine": L}
    print(f"moe path: {time.perf_counter() - t_path:.2f} s wall, launches "
          f"{ {n: launches[n] for n in want} }")
    for n, c in want.items():
        check(launches[n] == c, f"moe path: {c} {n} launches, got {launches[n]}")
    nums = drv.check([(0, got)])[0]
    for key, limit in wl["limits"].items():
        check(nums[key] <= limit, f"moe path: {key} {nums[key]!r} within the cell's {limit}")
    print(f"moe path vs the benchmark's reference: {nums}")

    def bf16_bars(out, plain):
        d = (out.float() - plain.float()).abs()
        return bool((d <= MOE_ATOL + MOE_RTOL * plain.float().abs()).all()), float(d.max())

    err, timed = {"moe_experts_up": 0.0, "moe_experts_down": 0.0, "moe_combine": 0.0}, None
    for i, ((x, rw, bias, wg, wu, wd), res) in enumerate(zip(layers, got)):
        ids, w = route(x, rw, bias, top_k)
        check(torch.equal(ids, res.experts), f"moe layer {i}: routing == the entry's")
        rows, pos, counts = sort_assignments(ids, e0, e1)
        c = counts.cpu().numpy()
        R = int(c.sum())
        h = torch.empty((R, ff), dtype=x.dtype, device=dev)
        y = torch.empty((R, d), dtype=x.dtype, device=dev)
        loops = []
        for up, sched, a, src, w0, w1, out, ncol in (
                (True, res.schedules[0], x, rows, wg, wu, h, ff // moe.UP_COLS),
                (False, res.schedules[1], h, None, wd, wd, y, d // moe.DOWN_COLS)):
            costs, meta, _ = expert_tiles(c, ncol)
            check(sched.N == len(costs), f"moe layer {i}: N == the closed form's tiles")
            card, host = card_tables(sched, dev), sched.tables()
            meta_card = torch.from_numpy(meta).to(dev)
            moe.experts_cuda(up, card, a, src, meta_card, w0, w1, out)
            plain = moe.experts_plain(up, host, a, src, meta, w0, w1, torch.empty_like(out))
            name = "moe_experts_up" if up else "moe_experts_down"
            ok, diff = bf16_bars(out, plain)
            check(ok, f"moe layer {i}: {name} kernel == plain within the bf16 bars "
                      f"(max {diff!r})")
            err[name] = max(err[name], diff)
            loops.append((up, card, host, a, src, meta_card, meta, w0, w1, out))
        comb = moe.combine_cuda(pos, w, y, torch.empty_like(x))
        comb_plain = moe.combine_plain(pos, w, y, torch.empty_like(x))
        check(torch.equal(comb, comb_plain), f"moe layer {i}: combine == plain exactly")
        check(torch.equal(comb, res.out), f"moe layer {i}: the entry's partial sum == the "
                                          f"kernels' on its own schedules")
        print(f"moe layer {i}: {R} held rows, loads max / mean "
              f"{float(c.max() / c.mean())!r}; up {res.schedules[0].N} and down "
              f"{res.schedules[1].N} tiles; max |kernel - plain| up {err['moe_experts_up']!r}, "
              f"down {err['moe_experts_down']!r}; combine and partial sum exact")
        if i == 0:
            timed = (R, c, rows, pos, w, counts, loops)
        del h, y, loops

    R, c, rows, pos, w, counts, loops = timed
    x, wg, wu, wd = layers[0][0], layers[0][3], layers[0][4], layers[0][5]
    nbytes = x.element_size()
    work = {"moe_experts_up": (2.0 * R * d * 2 * ff,
                               nbytes * (R * d + 2 * E * ff * d + R * ff)),
            "moe_experts_down": (2.0 * R * ff * d, nbytes * (R * ff + E * d * ff + R * d)),
            "moe_combine": (2.0 * R * d, 8 * x.shape[0] * top_k + nbytes * (R * d + x.numel()))}
    lib = {"moe_experts_up": None, "moe_experts_down": None, "moe_combine": None}
    grouped = getattr(torch, "_grouped_mm", None)
    if grouped is not None:
        xs = x[rows[:R].long()]
        offs = torch.cumsum(counts, 0).to(torch.int32)
        b_up = torch.cat([wg, wu], dim=1).transpose(1, 2)  # gate and up as one product
        h = loops[1][3]
        try:
            lib["moe_experts_up"] = cuda_ms(lambda: grouped(xs, b_up, offs=offs))
            lib["moe_experts_down"] = cuda_ms(lambda: grouped(h, wd.transpose(1, 2), offs=offs))
        except (RuntimeError, TypeError) as e:
            print(f"torch._grouped_mm did not run here: {e!r}"[:400])
        del xs, b_up
    y = loops[1][9]
    rows_out = []
    for up, card, host, a, src, meta_card, meta, w0, w1, out in loops:
        name = "moe_experts_up" if up else "moe_experts_down"
        ms = cuda_ms(lambda: moe.experts_cuda(up, card, a, src, meta_card, w0, w1, out))
        plain = cuda_ms(lambda: moe.experts_plain(up, host, a, src, meta, w0, w1,
                                                  torch.empty_like(out)), reps=1, warmup=False)
        ops, b = work[name]
        b_ms = bound(b, ops, BF16_FLOPS_PER_S)
        print(f"time {name} (layer 0, {R} held rows): {ms!r} ms ({ops / ms / 1e9!r} TFLOP/s; "
              f"{100 * b_ms[0] / ms!r} % of the bound)")
        rows_out.append(kernel_row(name, MOE_SOURCE, MOE_REPLACES, launches[name], err[name],
                                   ms, plain, b_ms, lib[name]))
    ms = cuda_ms(lambda: moe.combine_cuda(pos, w, y, torch.empty_like(x)))
    plain = cuda_ms(lambda: moe.combine_plain(pos, w, y, torch.empty_like(x)),
                    reps=1, warmup=False)
    ops, b = work["moe_combine"]
    rows_out.append(kernel_row("moe_combine", MOE_SOURCE, MOE_REPLACES, launches["moe_combine"],
                               err["moe_combine"], ms, plain, bound(b, ops), None))
    for r in rows_out:
        r.update(held_rows_layer0=R, load_max_layer0=int(c.max()))
    return rows_out


def model_path(dev) -> int:
    """Phase 6: tinyllama-1.1b at full width through ``api.forward``; the two
    attention backends must agree in f32 and, within bars set from sound
    runs, in bf16.  Returns the static kernel's launches in one forward in
    the config's bf16, the instance the kernel row times."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.models.params import cast

    cfg = get_config(MODEL)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (MODEL_B, MODEL_T)).astype(np.int32)}
    torch.cuda.synchronize()

    _build.reset_launches()
    t_path = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg32,
                             device=dev)
    pallas = api.forward(params, cfg32, batch, backend="pallas")
    xla = api.forward(params, cfg32, batch, backend="xla")
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["flash_attention"]
    print(f"model path: {MODEL} f32, {cfg.n_layers} layers, B={MODEL_B} x "
          f"T={MODEL_T}: {time.perf_counter() - t_path:.2f} s wall (init + two "
          f"forwards), flash_attention launches {launches}")
    check(launches == cfg.n_layers, f"one static kernel launch per layer ({launches})")
    shape = (MODEL_B, MODEL_T, cfg.vocab)
    for name, out in (("pallas", pallas), ("xla", xla)):
        check(tuple(out.shape) == shape and bool(out.isfinite().all()),
              f"{name} logits: shape {shape}, finite")
    top = float(xla.abs().max())
    d = float((pallas - xla).abs().max())
    agree = float((pallas.argmax(-1) == xla.argmax(-1)).double().mean())
    print(f"model f32: max |pallas - xla| {d!r} = {d / top!r} of max |logit| "
          f"{top!r}; greedy argmax agrees on {agree!r} of positions")
    check(d <= 1e-3 * top, "model f32: backends agree within 1e-3 of max |logit|")
    check(agree >= 0.999, "model f32: argmax agrees on >= 99.9 % of positions")
    del pallas

    params = cast(params, torch.bfloat16)  # the config's dtype
    torch.cuda.synchronize()
    _build.reset_launches()
    pallas = api.forward(params, cfg, batch, backend="pallas")
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["flash_attention"]
    check(launches == cfg.n_layers,
          f"bf16: one static kernel launch per layer ({launches})")
    forward_times(params, cfg, batch, "pallas", "model bf16")
    xla16 = forward_times(params, cfg, batch, "xla", "model bf16")
    check(tuple(pallas.shape) == shape and bool(pallas.isfinite().all()),
          f"pallas bf16 logits: shape {shape}, finite")
    d = float((pallas.float() - xla16.float()).abs().max())
    rms = [float((out.float() - xla).square().mean().sqrt()) for out in (pallas, xla16)]
    agree = float((pallas.argmax(-1) == xla16.argmax(-1)).double().mean())
    print(f"model bf16: flash_attention launches {launches}; max |pallas - xla| {d!r} = "
          f"{d / top!r} of max |logit|; RMS distance to the f32 forward: pallas "
          f"{rms[0]!r}, xla {rms[1]!r} (ratio {rms[0] / rms[1]!r}); greedy argmax "
          f"agrees on {agree!r} of positions")
    check(d <= MODEL_BF16_BAR * top,
          f"model bf16: backends agree within {MODEL_BF16_BAR} of max |logit|")
    check(rms[0] <= MODEL_BF16_RMS * rms[1],
          f"model bf16: pallas within {MODEL_BF16_RMS}x the xla backend's RMS distance "
          f"to the f32 forward")
    return launches


def forward_times(params, cfg, batch, backend, what):
    """Time ``api.forward`` (CUDA events and wall clock, median of REPS after
    a warm-up); returns the warm-up's logits."""
    import torch

    from repro_torch.models import api

    out = api.forward(params, cfg, batch, backend=backend)
    event_and_wall_ms(lambda: api.forward(params, cfg, batch, backend=backend),
                      f"{what} forward ({backend})", warmup=False)
    return out


def event_and_wall_ms(fn, what, warmup=True):
    """(CUDA-event ms, wall ms) of ``fn()``, medians of REPS after a
    warm-up unless ``warmup`` is false, printed as ``time <what>``."""
    import torch

    if warmup:
        fn()
    torch.cuda.synchronize()
    dev_ms, wall_ms = [], []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        b.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(a.elapsed_time(b))
    out = (statistics.median(dev_ms), statistics.median(wall_ms))
    print(f"time {what}: {out[0]!r} ms CUDA events, {out[1]!r} ms wall")
    return out


def ssd_flops(B, T, H, Dh, S, L):
    """The SSD scan's operations: its four products per (batch, head,
    chunk) of n valid rows, with C.B^T and W.x over the n(n+1)/2 causal
    (row, key) pairs only, as ``causal_pairs`` counts attention:
    2*(n(n+1)/2)*(S + Dh) + 4*n*S*Dh.  A ragged last chunk counts its
    valid rows."""
    def chunk(n):
        return 2 * (n * (n + 1) // 2) * (S + Dh) + 4 * n * S * Dh

    return B * H * ((T // L) * chunk(L) + (chunk(T % L) if T % L else 0))


def ssd_inputs(B, T, H, Dh, S, dev, dtype, seed=0):
    """tests/test_kernels.py::_ssd_inputs (numpy from ``seed``) on the card;
    A stays f32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(B, T, H, Dh)), rng.uniform(0.001, 0.1, size=(B, T, H)),
              -rng.uniform(0.5, 2.0, size=(H,)), rng.normal(size=(B, T, S)),
              rng.normal(size=(B, T, S)))
    x, dt, A, Bm, Cm = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays)
    return x.to(dtype), dt.to(dtype), A, Bm.to(dtype), Cm.to(dtype)


def ssd_bf16_close(a, b):
    """(a within the SSD's bf16 bars of b, max |a - b|, slack): |a - b| <=
    3e-2 + 1e-2 |b| everywhere and the slack max(|a - b| - 1e-2 |b|) <=
    5e-3.  At mamba2's geometry |y| reaches 16-32, where one bf16 step is
    0.125, so the relative part carries the output's rounding."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    slack = float((d - BF16_RTOL * b.abs()).max())
    ok = bool((d <= BF16_BAR + BF16_RTOL * b.abs()).all()) and slack <= BF16_ATOL
    return ok, float(d.max()), slack


def ssd_sass() -> None:
    """Phase 8, the build: the bf16 body's two tiled kernels run their
    products on the tensor cores (HGMMA in the SASS), the f32 body and the
    state-passing kernel do not; prints each instance's ptxas registers,
    spills and shared memory."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.kernel import tc_smem_bytes

    lib = _build.build(["ssd_scan"])["ssd_scan"]
    ptxas = ptxas_report(_build.BUILD_LOGS.get("ssd_scan", ""))
    smem = _build.function("ssd_scan", "repro_ssd_scan_smem", ctypes.c_int, ctypes.c_int)
    seen = set()
    for n, body in sorted(sass_functions(lib).items()):
        inst = re.search(r"(ssd_kernel|ssd_states|ssd_pass|ssd_chunks)ILi(\d+)E", n)
        if inst is None:
            continue
        kernel, width = inst[1], int(inst[2])
        tiled = kernel in ("ssd_states", "ssd_chunks")
        hgmma = body.count("HGMMA")
        seen.add(kernel)
        extra = ""
        if tiled:
            which = kernel == "ssd_chunks"
            extra = f"; {smem(which, width)} bytes of dynamic shared memory"
            check(smem(which, width) == tc_smem_bytes(width)[which],
                  f"{kernel}<{width}>: kernel.tc_smem_bytes mirrors the C layout")
        print(f"sass {kernel}<{width}>: {hgmma} HGMMA; ptxas {ptxas.get(n, 'not built here')}"
              f"{extra}")
        check(hgmma > 0 if tiled else hgmma == 0,
              f"{kernel}<{width}>: HGMMA {'expected' if tiled else 'not expected'} ({hgmma})")
    check(seen == {"ssd_kernel", "ssd_states", "ssd_pass", "ssd_chunks"},
          f"ssd_scan instances in the SASS: {seen}")


def ssd_kernel_path(dev, cfg, launches: int):
    """Phase 8, the kernel alone at mamba2-370m's geometry: checked against
    its plain version (f32; bf16 at every chunk size, ragged T, strided
    views; the two decay limits), then timed beside it and its bound, and
    at one serving chunk's prefill (B=1 x 512).  ``launches`` is the
    kernel's count in one bf16 forward of the model, its real caller;
    returns the kernel's row."""
    import torch

    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ssd_scan.kernel import _ssd_plain

    ssd_sass()
    B, T, H, Dh, S, L = SSM_B, SSM_T, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, SSD_CHUNK

    def timed(args, name):
        """(kernel ms, plain ms, bound): the kernel per call in runs of ten
        back to back (one call alone is printed beside it: it also times
        the wrapper's host-side set-up), the bound from these inputs' bytes
        and the operations their T needs."""
        Bx, Tx = args[0].shape[:2]
        size = args[0].element_size()
        nbytes = size * (2 * args[0].numel() + args[1].numel() + 2 * args[3].numel()) + 4 * H
        rate = F32_FLOPS_PER_S if args[0].dtype == torch.float32 else BF16_FLOPS_PER_S
        flops = ssd_flops(Bx, Tx, H, Dh, S, L)
        one = cuda_ms(lambda: ssd_scan(*args, chunk=L))
        ms = cuda_ms(lambda: ssd_scan(*args, chunk=L), per=10)
        plain_ms = cuda_ms(lambda: _ssd_plain(*args, chunk=L))
        b = bound(nbytes, flops, rate)
        print(f"time ssd_scan {name} x {tuple(args[0].shape)} S={S} chunk={L}: {ms!r} ms "
              f"per call in runs of 10 ({flops / ms / 1e9!r} TFLOP/s), {one!r} ms for one "
              f"call alone; plain {plain_ms!r} ms; bound {b[0]!r} ms ({b[1]}; {flops} "
              f"operations, {nbytes} bytes)")
        return ms, plain_ms, b

    err, times = {}, {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        args = ssd_inputs(B, T, H, Dh, S, dev, dtype)
        y = ssd_scan(*args, chunk=L)
        plain = _ssd_plain(*args, chunk=L)
        check(y.shape == args[0].shape and y.dtype == dtype and bool(y.isfinite().all()),
              f"ssd_scan {name}: shape, dtype, finite")
        if dtype == torch.float32:
            ok, err[name] = close(y, plain, 2e-4, 2e-4)
            bar = "2e-4"
        else:
            ok, err[name], slack = ssd_bf16_close(y, plain)
            bar = f"{BF16_BAR} + {BF16_RTOL} |plain|, slack <= {BF16_ATOL}; slack {slack!r}"
        check(ok, f"ssd_scan {name}: kernel == plain within {bar} (max {err[name]!r})")
        print(f"ssd_scan {name} x {tuple(args[0].shape)} S={S} chunk={L}: max |kernel - "
              f"plain| {err[name]!r} (bar {bar})")
        times[name] = timed(args, name)
    # ragged T and the decay limits (tests/test_kernels.py:190-201)
    args = ssd_inputs(B, 2000, H, Dh, S, dev, torch.float32, seed=1)
    ok, d = close(ssd_scan(*args, chunk=L), _ssd_plain(*args, chunk=L), 2e-4, 2e-4)
    check(ok, f"ssd_scan ragged T=2000: kernel == plain within 2e-4 (max {d!r})")
    x, dt, A, Bm, Cm = args
    tiny = float(ssd_scan(x, dt * 1e-8, A, Bm, Cm, chunk=L).abs().max())
    check(tiny < 1e-5, f"ssd_scan dt -> 0: output ~0 (max {tiny!r})")
    forget = ssd_scan(x, dt, torch.full_like(A, -1e5), Bm, Cm, chunk=L)
    expect = torch.einsum("bts,bts,bth,bthd->bthd", Cm, Bm, dt, x)
    ok, d_forget = close(forget, expect, 1e-4)
    check(ok, f"ssd_scan A -> -inf: y == dt C.B x within 1e-4 (max {d_forget!r})")
    print(f"ssd_scan ragged T=2000: max |kernel - plain| {d!r}; dt -> 0: max |y| "
          f"{tiny!r}; A -> -inf: max |y - dt C.B x| {d_forget!r}")
    # bf16 at ragged T, every chunk size, and on the model's strided views
    x, dt, A, Bm, Cm = (t.to(torch.bfloat16) if t.dim() > 1 else t for t in args)
    packed = torch.cat([x.reshape(B, 2000, H * Dh), Bm, Cm], dim=-1)
    views = (packed[..., :H * Dh].reshape(B, 2000, H, Dh), dt, A,
             packed[..., H * Dh:H * Dh + S], packed[..., H * Dh + S:])
    for chunk in (32, 64, 96, 128):
        plain = _ssd_plain(x, dt, A, Bm, Cm, chunk=chunk)
        for what, inputs in (("contiguous", (x, dt, A, Bm, Cm)), ("strided views", views)):
            ok, d, slack = ssd_bf16_close(ssd_scan(*inputs, chunk=chunk), plain)
            check(ok, f"ssd_scan bf16 T=2000 chunk={chunk} {what}: within the bf16 bars "
                      f"(max {d!r}, slack {slack!r})")
            print(f"ssd_scan bf16 T=2000 chunk={chunk} {what}: max |kernel - plain| {d!r}, "
                  f"slack {slack!r}")
    del x, dt, A, Bm, Cm, packed, views, plain, args
    # one serving chunk's prefill: B=1 prompt of 512 tokens
    timed(ssd_inputs(1, 512, H, Dh, S, dev, torch.bfloat16, seed=2), "bf16 serving chunk")
    print(f"time ssd_scan f32: {times['f32'][0]!r} ms; plain {times['f32'][1]!r} ms; "
          f"bound {times['f32'][2][0]!r} ms ({times['f32'][2][1]})")
    ms, plain_ms, b = times["bf16"]  # the model's type: the row
    return kernel_row("ssd_scan", SSD_SOURCE, "src/repro/kernels/ssd_scan/kernel.py:36",
                      launches, err["bf16"], ms, plain_ms, b, None)


def ssm_model_path(dev):
    """Phase 8: mamba2-370m at full width through the port's entry points --
    the forward in both backends, prefill/decode against the forward, and
    the serving engine behind the continuous batcher -- then the SSD
    kernel alone.  Returns the kernel's row."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan.kernel import _ssd_plain
    from repro_torch.models import api
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.params import cast
    from repro_torch.replay import choose_technique
    from repro_torch.serve import ContinuousBatcher, Engine, Request

    cfg = get_config(SSM_MODEL)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (SSM_B, SSM_T)).astype(np.int32)
    batch = {"tokens": tokens}
    torch.cuda.synchronize()

    # -- the forward in both backends (f32) --------------------------------
    _build.reset_launches()
    t_path = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg32, device=dev)
    pallas = api.forward(params, cfg32, batch, backend="pallas")
    xla = api.forward(params, cfg32, batch, backend="xla")
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    print(f"ssm model path: {SSM_MODEL} f32, {cfg.n_layers} layers, B={SSM_B} x "
          f"T={SSM_T}: {time.perf_counter() - t_path:.2f} s wall (init + two forwards), "
          f"launches {launches}")
    check(launches["ssd_scan"] == cfg.n_layers,
          f"one ssd_scan launch per layer ({launches['ssd_scan']})")
    check(sum(launches.values()) == launches["ssd_scan"], "no other kernel on the ssm path")
    shape = (SSM_B, SSM_T, cfg.vocab)
    for name, out in (("pallas", pallas), ("xla", xla)):
        check(tuple(out.shape) == shape and bool(out.isfinite().all()),
              f"ssm {name} logits: shape {shape}, finite")
    top = float(xla.abs().max())
    d = float((pallas - xla).abs().max())
    agree = float((pallas.argmax(-1) == xla.argmax(-1)).double().mean())
    print(f"ssm model f32: max |pallas - xla| {d!r} = {d / top!r} of max |logit| {top!r}; "
          f"greedy argmax agrees on {agree!r} of positions")
    check(d <= 1e-3 * top, "ssm model f32: backends agree within 1e-3 of max |logit|")
    check(agree >= 0.999, "ssm model f32: argmax agrees on >= 99.9 % of positions")
    f32_logits = xla  # the bf16 forwards' reference
    del xla

    # -- prefill / decode against the forward (f32) ------------------------
    _build.reset_launches()
    cache = api.init_cache(cfg32, SSM_B, SSM_T, device=dev)
    lg, cache = api.prefill(params, cfg32, {"tokens": tokens[:, :SSM_PREFIX]}, cache,
                            backend="pallas")
    check(_build.LAUNCHES["ssd_scan"] == cfg.n_layers,
          f"prefill: one ssd_scan launch per layer ({_build.LAUNCHES['ssd_scan']})")
    token = tokens[:, SSM_PREFIX]
    lg2, after = api.decode_step(params, cfg32, token, cache, backend="pallas")
    check(_build.LAUNCHES["ssd_scan"] == cfg.n_layers, "decode launches no scan kernel")
    check(int(after["pos"]) == SSM_PREFIX + 1, "cache position after prefill + decode")
    for what, pos, got in (("prefill", SSM_PREFIX - 1, lg), ("decode", SSM_PREFIX, lg2)):
        top = float(pallas[:, pos].abs().max())
        dd = float((got - pallas[:, pos]).abs().max())
        check(dd <= PREFILL_DECODE_BARS[what] * top,
              f"{what} == forward within {PREFILL_DECODE_BARS[what]} of max |logit| "
              f"(max {dd!r} of {top!r})")
        print(f"{what} at position {pos}: max |{what} - forward| {dd!r} = {dd / top!r} "
              f"of max |logit| {top!r}")
    # planted decode faults, each a cache handed over wrong: the decode bar
    # must tell them from a sound step
    _, stale = api.prefill(params, cfg32, {"tokens": tokens[:, :SSM_PREFIX - 1]},
                           api.init_cache(cfg32, SSM_B, SSM_T, device=dev),
                           backend="pallas")
    faults = {"conv tail dropped": {**cache, "ssm": {
                  **cache["ssm"], "conv": torch.zeros_like(cache["ssm"]["conv"])}},
              "state one token stale": {**cache, "ssm": {
                  **cache["ssm"], "state": stale["ssm"]["state"]}}}
    want = pallas[:, SSM_PREFIX]
    top = float(want.abs().max())
    for what, bad in faults.items():
        dd = float((api.decode_step(params, cfg32, token, bad, backend="pallas")[0]
                    - want).abs().max())
        print(f"planted decode fault, {what}: max |decode - forward| {dd!r} = "
              f"{dd / top!r} of max |logit|")
        check(dd > PREFILL_DECODE_BARS["decode"] * top,
              f"planted fault ({what}) reads above the decode bar")
    del stale, faults, after
    del pallas, cache

    # -- bf16 forwards: times, launches, and the kernel against its plain
    # version swapped in for the whole forward ---------------------------
    params = cast(params, torch.bfloat16)  # the config's dtype; A_log, D, dt_bias stay f32
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = {"pallas": forward_times(params, cfg, batch, "pallas", "ssm bf16")}
    bf16_launches = _build.LAUNCHES["ssd_scan"] // (1 + REPS)
    check(_build.LAUNCHES["ssd_scan"] == (1 + REPS) * cfg.n_layers,
          f"bf16: one ssd_scan launch per layer in each forward ({_build.LAUNCHES['ssd_scan']} "
          f"in {1 + REPS} forwards)")
    outs["xla"] = forward_times(params, cfg, batch, "xla", "ssm bf16")
    kernel_fn = ssm_mod.ssd_scan
    ssm_mod.ssd_scan = _ssd_plain  # the script's swap, undone below
    try:
        _build.reset_launches()
        outs["plain"] = api.forward(params, cfg, batch, backend="pallas")
        check(_build.LAUNCHES["ssd_scan"] == 0, "the swapped forward launches no scan kernel")
    finally:
        ssm_mod.ssd_scan = kernel_fn
    rms = {k: float((v.float() - f32_logits).square().mean().sqrt()) for k, v in outs.items()}
    top = float(outs["xla"].abs().max())
    print(f"ssm bf16: max |pallas - xla| {float((outs['pallas'] - outs['xla']).abs().max())!r} "
          f"of max |logit| {top!r}; RMS distance to the f32 forward: kernel {rms['pallas']!r}, "
          f"plain scan swapped in {rms['plain']!r} (ratio {rms['pallas'] / rms['plain']!r}), "
          f"xla {rms['xla']!r}")
    check(rms["pallas"] <= MODEL_BF16_RMS * rms["plain"],
          f"ssm bf16: the kernel forward within {MODEL_BF16_RMS}x the plain scan's RMS "
          f"distance to the f32 forward")
    del outs, f32_logits
    # where the forward's time goes: its matrix products alone, same shapes
    h = torch.randn((SSM_B * SSM_T, cfg.d_model), device=dev, dtype=torch.bfloat16)
    lp = params["layers"][0]["ssm"]
    hi = torch.randn((SSM_B * SSM_T, cfg.d_inner), device=dev, dtype=torch.bfloat16)
    proj_ms = cuda_ms(lambda: (h @ lp["in_proj"], hi @ lp["out_proj"]))
    head_ms = cuda_ms(lambda: h @ params["embed"].T)
    print(f"time ssm bf16 products: in_proj + out_proj {proj_ms!r} ms a layer "
          f"({cfg.n_layers * proj_ms!r} ms for {cfg.n_layers}); LM head {head_ms!r} ms")
    del h, hi

    # -- serving: the engine behind the continuous batcher (bf16) ----------
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (SERVE_N, SERVE_PROMPT)).astype(np.int32)
    max_new = rng.integers(SERVE_MAX_NEW[0], SERVE_MAX_NEW[1] + 1, SERVE_N)
    engine = Engine(cfg, params, backend="pallas")
    step = engine.generate(prompts[:2], max_new=4)
    cache = api.init_cache(cfg, 2, SERVE_PROMPT + 4, device=dev)
    lg, cache = api.prefill(params, cfg, {"tokens": prompts[:2]}, cache, backend="pallas")
    loop = []
    tok = lg.argmax(-1).int()
    for _ in range(4):
        loop.append(tok.cpu().numpy())
        lg, cache = api.decode_step(params, cfg, tok, cache, backend="pallas")
        tok = lg.argmax(-1).int()
    check(np.array_equal(step, np.stack(loop, 1)), "generate == stepwise prefill + greedy")
    for name in ("gss", "static", "auto"):
        reqs = [Request(rid=i, prompt=prompts[i], max_new=int(m))
                for i, m in enumerate(max_new)]
        seen = []

        def process(chunk, worker):
            t0 = time.perf_counter()
            out = engine.generate(np.stack([r.prompt for r in chunk]),
                                  max_new=max(r.max_new for r in chunk))
            torch.cuda.synchronize()
            for i, r in enumerate(chunk):
                r.output = out[i, :r.max_new].tolist()
            seen.extend(r.rid for r in chunk)
            return time.perf_counter() - t0

        _build.reset_launches()
        batcher = ContinuousBatcher(n_workers=SERVE_WORKERS,
                                    technique="auto" if name == "auto" else "gss",
                                    auto_seed=0)
        done = batcher.schedule(reqs, process, static=name == "static")
        rep = batcher.last_report
        sizes = [c.size for c in sorted((c for per in rep.per_pe_claims for c in per),
                                        key=lambda c: c.step)]
        check(sorted(seen) == list(range(SERVE_N)), f"serve {name}: every request once")
        check(all(len(r.output) == r.max_new for r in reqs), f"serve {name}: all tokens")
        check(_build.LAUNCHES["ssd_scan"] == cfg.n_layers * rep.steps,
              f"serve {name}: one prefill (48 scan launches) per claimed chunk")
        print(f"serve {name}: {SERVE_N} requests x {SERVE_PROMPT}-token prompts, "
              f"max_new {SERVE_MAX_NEW[0]}..{SERVE_MAX_NEW[1]}, {SERVE_WORKERS} workers: "
              f"{rep.steps} chunks of {sizes}, "
              f"makespan {float(done.max())!r} s, mean latency {float(done.mean())!r} s, "
              f"ssd_scan launches {_build.LAUNCHES['ssd_scan']}")
        if name == "auto":
            # technique="auto": the replay sweep over the queue's max_new
            d = rep.auto_decision
            direct = choose_technique(N=SERVE_N, P=SERVE_WORKERS, costs=max_new, seed=0)
            check(d is not None and d["source"] == "hints", "serve auto: decision from hints")
            check(rep.technique == d["chosen"], "serve auto: the batcher ran the chosen technique")
            check(d["n_evaluated"] == d["n_candidates"] == 13, "serve auto: all 13 evaluated")
            check(d["chosen"] == direct["chosen"],
                  f"serve auto: chose {d['chosen']!r}, a direct choose_technique "
                  f"{direct['chosen']!r}")
            print(f"serve auto: chose {d['chosen']} (top 3 "
                  f"{[(r['technique'], r['T_loop']) for r in d['ranking'][:3]]}), sweep_s "
                  f"{d['sweep_s']!r} s (direct {direct['sweep_s']!r} s)")
    del params, engine
    torch.cuda.empty_cache()
    return ssd_kernel_path(dev, cfg, bf16_launches)


def same_result(a, b) -> bool:
    """Two ``SimResult``s equal in every field, arrays bit for bit."""
    import numpy as np

    return (a.T_loop == b.T_loop and a.n_claims == b.n_claims and a.cov == b.cov
            and np.array_equal(a.finish, b.finish)
            and np.array_equal(a.per_pe_iters, b.per_pe_iters)
            and a.master_serve_time == b.master_serve_time
            and a.mean_claim_latency == b.mean_claim_latency
            and (a.n_rmw_global, a.n_rmw_local) == (b.n_rmw_global, b.n_rmw_local)
            and a.chunk_trace == b.chunk_trace)


def des_path() -> None:
    """Phase 9: the DES at the paper's PSIA size, through the facade.

    26 runs of ``dls.loop(...).execute(executor="sim")`` (2:1 mix, each
    coordinator; one- and two-sided over six techniques, hierarchical
    with 8 nodes and inner SS), each held to a direct ``simulate``; the
    same configs through ``simulate_many`` in 4 workers (CUDA is up, so
    they must be spawned); then the fast path's batch core on the card
    (``backend="torch"``) against numpy where rounds happen (FIFO polling).
    """
    import numpy as np
    import torch

    from repro_torch import dls
    from repro_torch.core.chunk_calculus import LoopSpec, plan
    from repro_torch.core.sim import (
        PSIA_MEAN_COST, SimConfig, paper_cluster, psia_costs, simulate)
    from repro_torch.core.weights import weights_from_speeds
    from repro_torch.sim import fast, simulate_many

    t_phase = time.perf_counter()
    costs = psia_costs(DES_N, mean=PSIA_MEAN_COST)
    configs, serial = [], []
    for where in ("knl", "xeon"):
        speeds, coord = paper_cluster("2:1", where)
        weights = tuple(weights_from_speeds(speeds))
        runs = [(rt, t) for rt in ("one_sided", "two_sided") for t in DES_TECHNIQUES]
        for rt, t in runs + [("hierarchical", "gss")]:
            loop_kw = dict(weights=weights) if t == "wf" else {}
            sim_kw = dict(coordinator=coord)
            if rt == "hierarchical":
                loop_kw.update(nodes=DES_NODES, inner_technique="ss")
                sim_kw.update(nodes=DES_NODES, inner_technique="ss")
            t0 = time.perf_counter()
            session = dls.loop(DES_N, t, P=DES_P, runtime=rt, **loop_kw)
            rep = session.execute(None, executor="sim", costs=costs, speeds=speeds,
                                  coordinator=coord)
            wall = time.perf_counter() - t0
            what = f"des {where} {rt} {t}"
            check(int(rep.per_pe_iters.sum()) == DES_N, f"{what}: iterations sum to N")
            cf = SimConfig(session.spec, speeds, costs, impl=rt, **sim_kw)
            r = simulate(cf)
            check(rep.wall_time == r.T_loop, f"{what}: report wall_time == direct T_loop")
            check(rep.n_claims == r.n_claims and np.array_equal(rep.per_pe_iters, r.per_pe_iters),
                  f"{what}: report claims and iterations == direct simulate")
            if rt == "one_sided" and t != "wf":
                # wf's chunk sizes depend on the claiming PE, so its count
                # follows the grant order, not the unweighted host plan
                n_plan = len(plan(session.spec)[0])
                check(r.n_claims == n_plan, f"{what}: claims {r.n_claims} == host plan {n_plan}")
            configs.append(cf)
            serial.append(r)
            print(f"{what}: T_loop {r.T_loop!r} s, claims {r.n_claims}, c.o.v. "
                  f"{r.cov!r}, {wall!r} s wall")

    check(torch.cuda.is_initialized(), "CUDA is up before simulate_many")
    info = {}
    t0 = time.perf_counter()
    par = simulate_many(configs, workers=DES_WORKERS, info=info)
    many_s = time.perf_counter() - t0
    check(info["start_method"] == "spawn", f"simulate_many after CUDA: "
          f"start method {info['start_method']!r} (must be spawn)")
    check(all(same_result(a, b) for a, b in zip(par, serial)),
          "simulate_many results == serial simulate")
    print(f"des simulate_many: {len(configs)} configs, {DES_WORKERS} workers, start "
          f"method {info['start_method']}, {many_s!r} s wall; == serial")

    # the batch core on the card: rounds happen only under FIFO polling
    contended = SimConfig(
        LoopSpec("ss", N=200_000, P=1024),
        np.random.default_rng(7).uniform(0.25, 1.0, size=1024),
        np.full(200_000, 1e-5), impl="one_sided", lock_polling_random=False)
    speeds, coord = paper_cluster("2:1", "knl")
    psia_fifo = SimConfig(LoopSpec("ss", N=DES_N, P=DES_P), speeds, costs, impl="one_sided",
                          coordinator=coord, lock_polling_random=False)
    for name, cf in (("contended ss P=1024 N=200000", contended),
                     ("psia ss fifo 2:1 knl", psia_fifo)):
        walls = {"numpy": [], "torch": []}
        out, rounds = {}, []
        for backend in ("numpy", "torch", "torch", "numpy", "numpy", "torch"):
            fast.reset_torch_rounds()
            t0 = time.perf_counter()
            r = simulate(cf, backend=backend,
                         device="cuda" if backend == "torch" else None)
            walls[backend].append(time.perf_counter() - t0)
            out.setdefault(backend, r)
            if backend == "torch":
                rounds.append(fast.TORCH_ROUNDS["cuda"])
                check(fast.TORCH_ROUNDS["cpu"] == 0, f"{name}: no torch round on the CPU")
        rn, rt = out["numpy"], out["torch"]
        check(min(rounds) > 0, f"{name}: the torch core ran on cuda ({rounds} rounds)")
        rel = float(np.max(np.abs(rt.finish - rn.finish) / np.abs(rn.finish)))
        check(rel <= DES_RTOL and abs(rt.T_loop - rn.T_loop) <= DES_RTOL * rn.T_loop,
              f"{name}: torch core within {DES_RTOL} of numpy (finish rel {rel!r})")
        check(rt.n_claims == rn.n_claims
              and np.array_equal(rt.per_pe_iters, rn.per_pe_iters),
              f"{name}: claims and per-PE iterations equal")
        print(f"des core {name}: {rounds[0]} rounds on cuda per run; T_loop numpy "
              f"{rn.T_loop!r} torch {rt.T_loop!r} (max finish rel {rel!r}); wall "
              f"median of 3: numpy {statistics.median(walls['numpy'])!r} s, "
              f"torch {statistics.median(walls['torch'])!r} s")
    print(f"des phase: {time.perf_counter() - t_phase:.1f} s wall")


def replay_path(root: Path, P: int, costs, sessions, image) -> None:
    """Phase 10: ``repro_torch.replay`` over the card's traces and at the
    paper's PSIA size.

    (a) phase 2's gss and fac2 device reports as traces: coverage, the
    JSONL round trip through a ``TraceStore``, equal to the same session
    drained on a CPU ``DeviceWindow``; percent error, gantt. (b)
    ``technique="auto"`` from the gss trace; the best-ranked technique the
    device runtime takes is drained on the card and drives persistent
    Mandelbrot, whose image must equal phase 3's. (c) gss and fac2 sim
    traces at 288,000 x 288 with CUDA up: percent errors and full-N
    rankings, serial and in 4 spawned workers, against the JAX package's
    fixture. (d) the CLI in subprocesses.
    """
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch import dls
    from repro_torch.core.chunk_calculus import plan
    from repro_torch.core.sim import paper_cluster, psia_costs
    from repro_torch.device import (
        DEVICE_SPEC_TECHNIQUES, DeviceWindow, claim_schedule, host_spec)
    from repro_torch.kernels import _build, mandelbrot_persistent
    from repro_torch.replay import (
        Trace, TraceStore, calibrate, choose_technique, gantt_ascii, predict,
        save_svg)

    t_phase = time.perf_counter()
    N = len(costs)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        traces = {}
        # -- (a) the device traces -------------------------------------------
        for t in ("gss", "fac2"):
            rep = sessions[t][1]
            tr = Trace.from_report(rep)
            cov = np.zeros(N, np.int64)
            for r in tr.records:
                cov[r.start:r.stop] += 1
            check(tr.iters_covered() == N and (cov == 1).all(),
                  f"replay {t}: the device trace covers [0, N) once")
            text = tr.to_jsonl()
            path = TraceStore(tmp / "traces").save(tr)
            again = TraceStore(tmp / "traces").load(path.name)
            check(path.read_text() == text and again.to_jsonl() == text,
                  f"replay {t}: JSONL round trip byte-stable")
            s_cpu = dls.loop(N, t, P=P, runtime="device", window=DeviceWindow(device="cpu"))
            cpu = Trace.from_report(dls.execute(s_cpu, None, executor="device", costs=costs))
            check(cpu.to_jsonl() == text, f"replay {t}: trace == the CPU window's")
            cal = calibrate(tr)
            err = cal.percent_error()
            check(np.isfinite(err), f"replay {t}: finite percent error")
            chart = gantt_ascii(tr)
            svg = save_svg(tr, tmp / f"{t}.svg")
            svg_text = svg.read_text()
            check(chart.count("\n") == P + 1 and svg_text.startswith("<svg")
                  and svg_text.count("<rect") > len(tr.records),
                  f"replay {t}: gantt renders one row per worker")
            traces[t] = tr
            print(f"replay {t}: device trace N={N} P={P}, {len(tr.records)} records, "
                  f"{len(text)} bytes of JSONL == the CPU window's; calibrated replay "
                  f"percent error {err!r} % (fitted speeds {cal.speeds.min()!r}.."
                  f"{cal.speeds.max()!r}); gantt {chart.splitlines()[0]!r}, "
                  f"svg {len(svg_text)} bytes")

        # -- (b) technique="auto" from the device trace, run on the card ------
        auto = dls.loop(N, "auto", P=P, trace=traces["gss"], auto_seed=0, auto_budget_s=None)
        d = auto.auto_decision
        check(d["source"] == "trace" and d["n_evaluated"] == 13 and auto.spec.technique
              == d["chosen"], "replay auto: all 13 candidates ranked from the trace")
        try:
            dls.loop(N, "auto", P=P, runtime="device", costs=costs)
            check(False, 'replay auto: runtime="device" must raise')
        except ValueError as e:
            print(f'replay auto runtime="device": ValueError {e} (as in the reference)')
        best = next(r for r in d["ranking"] if r["technique"] in DEVICE_SPEC_TECHNIQUES)
        tech = best["technique"]
        _build.reset_launches()
        s = dls.loop(N, tech, P=P, runtime="device")
        rep = dls.execute(s, None, executor="device", costs=costs)
        sched = claim_schedule(tech, N, P, costs=costs)
        out = mandelbrot_persistent(IMG, ct=CT, block_h=TILE, block_w=TILE, workers=P,
                                    schedule=sched)[0]
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check(launches["protocol"] == 2 and launches["mandelbrot_persistent"] == 1,
              f"replay auto: the protocol and persistent Mandelbrot ran ({launches})")
        sizes, starts = plan(host_spec(tech, N, P))
        _, _, st, sz = claims_in_grant_order(rep)
        check(np.array_equal(st, starts) and np.array_equal(sz, sizes),
              f"replay auto {tech}: schedule == host plan")
        check(torch.equal(out, image), f"replay auto {tech}: persistent image == static")
        print(f"replay auto: chose {d['chosen']} (sweep {d['sweep_s']!r} s); best device "
              f"technique {tech} (rank {d['ranking'].index(best) + 1}): predicted T_loop "
              f"{best['T_loop']!r}, the card's modeled makespan {float(rep.wall_time)!r}; "
              f"{rep.steps} claims == host plan; persistent Mandelbrot == static; "
              f"launches {launches}")

        # -- (c) the paper's PSIA size on the host, with CUDA up -------------
        check(torch.cuda.is_initialized(), "CUDA is up before the PSIA sweeps")
        fixture = json.loads((root / REPLAY_FIXTURE).read_text())
        speeds, coord = paper_cluster("2:1", "knl")
        psia = psia_costs()
        for t in ("gss", "fac2"):
            t0 = time.perf_counter()
            rep = dls.loop(DES_N, t, P=DES_P).execute(
                None, executor="sim", costs=psia, speeds=speeds, seed=0,
                coordinator=coord, collect_trace=True)
            tr = Trace.from_report(rep, meta={"seed": 0})
            res, walls = {}, {}
            for workers in (0, DES_WORKERS):
                t1 = time.perf_counter()
                res[workers] = predict(tr, seed=0, budget_s=None, workers=workers)
                walls[workers] = time.perf_counter() - t1
            rows = {w: [[p.technique, repr(p.T_loop), p.steps] for p in r["ranking"]]
                    for w, r in res.items()}
            check(rows[0] == rows[DES_WORKERS], f"replay psia {t}: ranking serial == "
                  f"{DES_WORKERS} workers")
            want = fixture["traces"][t]
            got = {"records": len(tr.records), "percent_error": repr(res[0]["percent_error"]),
                   "ranking": rows[0]}
            check(got == want, f"replay psia {t}: == {REPLAY_FIXTURE}")
            print(f"replay psia {t}: {DES_N} x {DES_P}, {len(tr.records)} records, percent "
                  f"error {res[0]['percent_error']!r} %, ranking {rows[0][0][0]} first at "
                  f"{rows[0][0][1]} s, {rows[0][-1][0]} last at {rows[0][-1][1]} s; predict "
                  f"serial {walls[0]!r} s, {DES_WORKERS} spawned workers "
                  f"{walls[DES_WORKERS]!r} s, "
                  f"{time.perf_counter() - t0!r} s in all; == the fixture")
            if t == "gss":
                d = choose_technique(N=DES_N, P=DES_P, trace=tr, seed=0)
                print(f"replay psia choose_technique: {d['chosen']} from {d['N_sim']} "
                      f"iterations, {d['n_evaluated']} evaluated, sweep_s {d['sweep_s']!r} s")

        # -- (d) the CLI -------------------------------------------------------
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        store = tmp / "cli"
        trace_path = str(store / "smoke.jsonl")
        for args in (["record", "--n", "2000", "--p", "4", "--technique", "fac2",
                      "--executor", "sim", "--het", "--store", str(store), "--name", "smoke"],
                     ["calibrate", "--trace", trace_path],
                     ["predict", "--trace", trace_path, "--workers", "0"],
                     ["gantt", "--trace", trace_path, "--svg", str(store / "g.svg")]):
            r = subprocess.run([sys.executable, "-m", "repro_torch.replay"] + args,
                               capture_output=True, text=True, cwd=tmp, env=env,
                               timeout=300)
            check(r.returncode == 0, f"replay cli {args[0]}: exit {r.returncode}: "
                  f"{r.stderr[-2000:]}")
            print(f"replay cli {args[0]}: exit 0; {r.stdout.splitlines()[-1]!r}")
    print(f"replay phase: {time.perf_counter() - t_phase:.1f} s wall")


# phase 11: the paper's one- against two-sided comparison over real OS
# processes (repro_torch.pt) -- the main path's 4096x4096 Mandelbrot image in
# 8-row bands (examples/dls_mandelbrot.py's TILE), one scheduled iteration a
# band, each band rendered by the static kernel in the process that claimed it
BAND_ROWS = 8
BAND_YLIM = (-1.5, 1.5)
PT_TECHNIQUES = ("static", "ss", "gss", "fac2")
PT_TIMEOUT_S, PT_SPAWN_TIMEOUT_S = 240.0, 120.0
_BAND_SHM: dict = {}  # per process: shared-memory name -> (segment, int64 view)
_BAND_CALLS = 0  # the kill run's count of the victim's sub-blocks


def _band_data(name: str):
    got = _BAND_SHM.get(name)
    if got is None:
        from multiprocessing import shared_memory

        import numpy as np

        shm = shared_memory.SharedMemory(name=name)
        got = _BAND_SHM[name] = (shm, np.ndarray((len(shm.buf) // 8,), np.int64,
                                                 buffer=shm.buf))
    return got[1]


class BandResults:
    """What the band workers write, in shared memory the parent owns: a hit
    per band (``workloads.mark_hits``), and in one int64 array each band's
    count sum and 64-bit hash, each PE's kernel launches and its CUDA
    start-up in ns.  ``spec`` is what a worker needs to find them."""

    def __init__(self, n: int, P: int):
        from multiprocessing import shared_memory

        import numpy as np

        from repro_torch.pt import workloads

        self.n, self.P = n, P
        self._hits, hits_name = workloads.alloc_hits(n)
        self._data = shared_memory.SharedMemory(create=True, size=8 * (2 * n + 2 * P))
        _BAND_SHM[self._data.name] = (self._data, np.ndarray(
            (2 * n + 2 * P,), np.int64, buffer=self._data.buf))
        self.spec = (hits_name, self._data.name, n, P)
        self.reset()

    def _view(self):
        return _BAND_SHM[self._data.name][1]

    def reset(self) -> None:
        self._hits.buf[:self.n] = bytes(self.n)
        self._view()[:] = 0

    def hits(self):
        import numpy as np

        return np.frombuffer(bytes(self._hits.buf[:self.n]), np.uint8)

    def digests(self):
        """(n, 2) int64: each band's count sum and hash."""
        return self._view()[:2 * self.n].reshape(2, self.n).T.copy()

    def launches(self):
        return self._view()[2 * self.n:2 * self.n + self.P].copy()

    def startup_s(self):
        """Each PE's CUDA start-up, in s (0 where it brought none up)."""
        return self._view()[2 * self.n + self.P:] / 1e9

    def close(self) -> None:
        _BAND_SHM.pop(self._data.name)  # drop the view before the segment
        for shm in (self._hits, self._data):
            shm.close()
            shm.unlink()


def band_ylim(t: int, width: int):
    """Band ``t``'s rows of the width x width image, as ``examples/
    dls_mandelbrot.py`` computes them: they depend on ``t`` alone, so the
    image does not depend on how the bands were chunked."""
    dy = (BAND_YLIM[1] - BAND_YLIM[0]) / max(width - 1, 1)
    return (BAND_YLIM[0] + dy * (t * BAND_ROWS),
            BAND_YLIM[0] + dy * (t * BAND_ROWS + BAND_ROWS - 1))


def band(t: int, width: int, ct: int):
    """Band ``t`` on the card: (counts, int64 sum, 64-bit hash of its bytes)."""
    import hashlib

    import numpy as np

    from repro_torch.kernels import mandelbrot

    counts = mandelbrot(width, BAND_ROWS, ct=ct, ylim=band_ylim(t, width))
    host = counts.cpu().numpy()
    h = hashlib.blake2b(host.tobytes(), digest_size=8).digest()
    return counts, int(host.sum(dtype=np.int64)), int.from_bytes(h, "little", signed=True)


def render_bands(spec, width: int, ct: int, a: int, b: int) -> None:
    """``work_fn`` of the processes runs: render bands [a, b) on the card,
    write each band's digest and hit, and this PE's launches.  The first
    call in a process without CUDA records its start-up (torch's import
    where the server did not preload it, the context, the kernel library's
    load)."""
    t0 = time.perf_counter()
    cold = "torch" not in sys.modules or not sys.modules["torch"].cuda.is_initialized()
    import torch

    from repro_torch.kernels import _build
    from repro_torch.pt import worker, workloads

    hits_name, data_name, n, P = spec
    pe = worker.CURRENT_PE or 0  # the two-sided master runs in the parent as PE 0
    data = _band_data(data_name)
    if cold:
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
        _build.library("mandelbrot")
        data[2 * n + P + pe] = int((time.perf_counter() - t0) * 1e9)
    for t in range(a, b):
        before = _build.LAUNCHES["mandelbrot_static"]
        _, total, digest = band(t, width, ct)
        data[2 * n + pe] += _build.LAUNCHES["mandelbrot_static"] - before
        data[t], data[n + t] = total, digest
        workloads.mark_hits(hits_name, t, t + 1)


def render_bands_die_at(spec, width: int, ct: int, victim: int, die_after: int,
                        a: int, b: int) -> None:
    """``render_bands``, but PE ``victim`` dies (``os._exit(77)``) before its
    ``die_after + 1``-th sub-block, as ``workloads.die_at`` does, and the
    other PEs hold their first sub-block until the victim has claimed (its
    first chunk is then a batch-0 one)."""
    import os

    global _BAND_CALLS
    from repro_torch.pt import worker, workloads

    if worker.CURRENT_PE == victim:
        if _BAND_CALLS >= die_after:
            os._exit(77)
        _BAND_CALLS += 1
    else:
        workloads.wait_for_victim(victim)
    render_bands(spec, width, ct, a, b)


def _take_records(src, n: int, ready) -> None:
    """Child of ``record_send_us``: say it has started, then read ``n``
    records from a pipe's read end or a queue."""
    get = src.recv if hasattr(src, "recv") else src.get
    ready.set()
    for _ in range(n):
        get()


def record_send_us(ctx, n: int = 4096) -> tuple:
    """Host µs per chunk record, each read by a child process: sent down a
    pipe as a ``pt`` worker sends it (one write, in the OS pipe when
    ``send`` returns); put on a ``multiprocessing.Queue`` as the
    reference's worker puts it (handed to the feeder thread); and the
    queue's time with its feeder flushed at the end (``close`` +
    ``join_thread``), what the put needs before the record is safe."""
    rec = {"kind": "chunk", "pe": 7, "seq": 100, "step": 300, "start": 123456,
           "size": 32, "t0": 1.2345678, "t1": 1.3456789, "lat": 1.2e-05}
    r, w = ctx.Pipe(duplex=False)
    ready = ctx.Event()
    child = ctx.Process(target=_take_records, args=(r, n, ready))
    child.start()
    r.close()
    check(ready.wait(60), "pt record send: the reading child started")
    t0 = time.perf_counter()
    for _ in range(n):
        w.send(rec)
    pipe = (time.perf_counter() - t0) / n * 1e6
    child.join(timeout=60)
    w.close()
    q, ready = ctx.Queue(), ctx.Event()
    child = ctx.Process(target=_take_records, args=(q, n, ready))
    child.start()
    check(ready.wait(60), "pt record send: the reading child started")
    t0 = time.perf_counter()
    for _ in range(n):
        q.put(rec)
    put = (time.perf_counter() - t0) / n * 1e6
    q.close()
    q.join_thread()
    flushed = (time.perf_counter() - t0) / n * 1e6
    child.join(timeout=60)
    return pipe, put, flushed


def bands_plain(width: int, ct: int, n: int, device="cuda"):
    """Every band's plain version in one call, (n, 8, width) int32: each
    band at the f32 geometry its own kernel launch gets (``mandelbrot_ref(
    width, 8, ylim=band_ylim(t, width))``), iterated together."""
    import torch

    from repro_torch.kernels.mandelbrot.ref import escape_counts_at, geometry

    geo = [geometry(width, BAND_ROWS, (-2.0, 1.0), band_ylim(t, width)) for t in range(n)]
    xmin, dx = geo[0][:2]
    ymin, dy = (torch.tensor([g[k] for g in geo], dtype=torch.float32,
                             device=device)[:, None, None] for k in (2, 3))
    cols = torch.arange(width, dtype=torch.int32, device=device)
    rows = torch.arange(BAND_ROWS, dtype=torch.int32, device=device)[:, None]
    return escape_counts_at(xmin + cols.to(torch.float32) * dx,
                            ymin + rows.to(torch.float32) * dy, ct=ct)


def serial_bands(width: int, ct: int, n: int):
    """The parent's own render of every band, one after another, each held
    against its plain version: the assembled (n * 8, width) image on the
    card, the (n, 2) digests, and the largest fraction of a band's pixels
    and |count| difference against the plain version."""
    import numpy as np
    import torch

    image = torch.empty((n * BAND_ROWS, width), dtype=torch.int32, device="cuda")
    digests = np.zeros((n, 2), np.int64)
    for t in range(n):
        counts, total, h = band(t, width, ct)
        image[t * BAND_ROWS:(t + 1) * BAND_ROWS] = counts
        digests[t] = total, h
    plain = bands_plain(width, ct, n)
    from repro_torch.kernels import mandelbrot_ref

    mid = mandelbrot_ref(width, BAND_ROWS, ct=ct, ylim=band_ylim(n // 2, width))
    check(torch.equal(plain[n // 2], mid),
          "pt: the batched plain bands == mandelbrot_ref of one band")
    got = image.view(n, BAND_ROWS, width)
    frac = (got != plain).double().mean(dim=(1, 2))
    worst = int(frac.argmax())
    check(float(frac[worst]) < 0.005,
          f"pt: band {worst} differs from its plain version in {float(frac[worst])!r} "
          "of its pixels (< 0.5 % each band)")
    err = float((got - plain).abs().max())
    return image, digests, float(frac[worst]), err


def processes_path(image, plain_image, smi: str) -> tuple:
    """Phase 11: ``dls.loop(512, t, P=P, window="shm")`` drained by
    ``executor="processes"`` with P = min(8, cores) worker processes, each
    bringing up its own CUDA context, rendering the main path's image band
    by band.

    One- and two-sided over static, ss, gss and fac2; hierarchical gss over
    2 nodes with inner ss; fac2 with PE 1 killed mid-chunk (salvage and
    orphans).  Every run must render every band exactly once, with digests
    equal to the parent's serial render, each of whose bands is held to
    its plain version, and whose assembled image is held to the full-image
    kernel and to its plain version.  Then the window's RMW latency and
    contention, and one run's trace calibrated with the measured
    ``o_rma``.  Returns row 2's launches on this path, and the parent's
    serial render of the bands (the image phase 15 is held to).
    """
    import functools
    import math
    import os
    import shutil

    import torch

    from repro_torch import dls
    from repro_torch.core import LoopSpec, plan
    from repro_torch.kernels import _build, mandelbrot
    from repro_torch.pt import measure_contention, measure_rmw_latency
    from repro_torch.pt.executor import pick_start_method
    from repro_torch.replay import Trace, calibrate

    t_phase = time.perf_counter()
    n, width = IMG // BAND_ROWS, IMG
    P = min(8, os.cpu_count() or 1)
    method = pick_start_method()
    print(f"pt: N={n} bands of {BAND_ROWS}x{width}, CT {CT}, P={P} processes; "
          f"os.cpu_count()={os.cpu_count()}, /dev/shm free "
          f"{shutil.disk_usage('/dev/shm').free} bytes; start method {method!r} "
          f"(CUDA is up in the parent)")
    check(method == "forkserver", "pt: forkserver once CUDA is up")

    # the parent's serial render: the digests every run is held to
    t0 = time.perf_counter()
    assembled, want, band_frac, band_err = serial_bands(width, CT, n)
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0
    frac = (assembled != image).double().mean().item()
    frac_plain = (assembled != plain_image).double().mean().item()
    check(frac < 0.005 and frac_plain < 0.005,
          f"pt: bands vs full image {frac!r}, vs plain {frac_plain!r} (< 0.5 %)")
    mid = band_ylim(n // 2, width)
    kernel_ms = cuda_ms(lambda: mandelbrot(width, BAND_ROWS, ct=CT, ylim=mid), per=64)
    band_ms = host_ms(lambda: band(n // 2, width, CT))
    print(f"pt serial: {n} bands rendered and held to their plain versions in the "
          f"parent {serial_s!r} s; the worst band differs from its plain version in "
          f"{band_frac!r} of its pixels (max |err| {band_err!r}); band {n // 2} with "
          f"its copy and hash {band_ms!r} ms, its kernel {kernel_ms!r} ms back to "
          f"back; the assembled image differs from the full-image kernel in "
          f"{frac!r} of pixels, from the full plain image in {frac_plain!r} ({smi})")

    out = BandResults(n, P)
    runs, launched = {}, []

    def run(label, technique, work=None, progress=64, deaths=0, **kw):
        out.reset()
        session = dls.loop(n, technique, P=P, window="shm", **kw)
        fn = work or functools.partial(render_bands, out.spec, width, CT)
        try:
            rep = session.execute(fn, executor="processes", timeout=PT_TIMEOUT_S,
                                  spawn_timeout=PT_SPAWN_TIMEOUT_S, progress=progress)
        finally:
            session.close()
        ps = rep.process_stats
        check(rep.total_iters == n, f"pt {label}: {rep.total_iters} iterations of {n}")
        check(out.hits().tolist() == [1] * n, f"pt {label}: every band exactly once")
        check((out.digests() == want).all(), f"pt {label}: digests == the serial render's")
        per_pe = out.launches()
        check(int(per_pe.sum()) == n, f"pt {label}: {int(per_pe.sum())} launches, {n} bands")
        check(ps["n_deaths"] == deaths, f"pt {label}: {ps['n_deaths']} deaths")
        up = out.startup_s()
        for e in ps["per_pe"]:
            if e.get("n_chunks", 0) + e.get("n_orphans", 0) > 0:
                check(up[e["pe"]] > 0, f"pt {label}: PE {e['pe']}'s start-up recorded")
        t_up = float(up.max())
        launched.append(int(per_pe.sum()))
        print(f"pt {label}: T_loop {rep.wall_time!r} s, {rep.wall_time - t_up!r} s "
              f"without the largest CUDA start-up; teardown {ps['teardown_s']!r} s; "
              f"claims {rep.steps}; RMW global {rep.n_rmw_global} local "
              f"{rep.n_rmw_local}; {ps['start_method']}/{ps['window_backend']}; "
              f"CUDA start-up per PE (s) {[float(x) for x in up]!r}; launches per "
              f"PE {per_pe.tolist()} (host times of the card's machine, {smi})")
        runs[label] = rep
        return rep

    try:
        _build.reset_launches()
        for t in PT_TECHNIQUES:
            for rt in ("one_sided", "two_sided"):
                run(f"{t} {rt}", t, runtime=rt)
        rep = run("gss hierarchical", "gss", runtime="hierarchical", nodes=2,
                  inner_technique="ss")
        check(rep.n_rmw_local > rep.n_rmw_global > 0,
              f"pt hierarchical: local RMWs {rep.n_rmw_local} > global {rep.n_rmw_global}")
        # PE 1 dies before its 2nd sub-block of 4 bands: its first fac2 chunk is
        # a batch-0 one, 32 bands at P = 8, so 4 are salvaged and 28 orphaned
        # to survivors
        rep = run("fac2 kill", "fac2", progress=4, deaths=1,
                  work=functools.partial(render_bands_die_at, out.spec, width, CT, 1, 1))
        ps = rep.process_stats
        victim = next(e for e in ps["per_pe"] if e.get("died"))
        check(victim["pe"] == 1 and victim["exitcode"] == 77, "pt kill: PE 1 died with 77")
        check(rep.total_iters == n, f"pt kill: {rep.total_iters} bands in the report of {n}")
        check(victim["salvaged_iters"] == 4 and victim["orphaned_iters"] > 0,
              f"pt kill: salvaged {victim['salvaged_iters']}, orphaned {victim['orphaned_iters']}")
        batch0 = int(plan(LoopSpec("fac2", N=n, P=P))[0][0])
        own = rep.per_pe_claims[1]
        check(len(own) == 1 and own[0].size == 4
              and victim["salvaged_iters"] + victim["orphaned_iters"] == batch0,
              f"pt kill: PE 1's claims {own!r}, one salvaged prefix of its batch-0 "
              f"chunk of {batch0}")
        check(sum(o["size"] for o in ps["orphans"]) == victim["orphaned_iters"]
              and all(o["by_pe"] != 1 for o in ps["orphans"]), "pt kill: orphans re-executed")
        print(f"pt kill: PE 1 salvaged {victim['salvaged_iters']} bands, orphaned "
              f"{victim['orphaned_iters']} of its batch-0 chunk of {batch0}; "
              f"{rep.total_iters} bands in the report; re-executed by PEs "
              f"{sorted({o['by_pe'] for o in ps['orphans']})}")
        parent = _build.LAUNCHES["mandelbrot_static"]
        check(parent == sum(runs[f"{t} two_sided"].per_pe_iters[0] for t in PT_TECHNIQUES),
              f"pt: the parent's {parent} launches == the two-sided master's bands")
        print(f"pt launches of mandelbrot_static: {sum(launched)} over {len(runs)} runs, "
              f"{parent} of them by the two-sided master in the parent")
    finally:
        out.close()

    lat = measure_contention((1, 2, 4, 8), base=measure_rmw_latency())
    print(f"pt {lat.summary()} (host times of the card's machine, {smi})")
    from repro_torch.pt.executor import _get_ctx

    pipe_us, put_us, flushed_us = record_send_us(_get_ctx(method))
    print(f"pt record send: {pipe_us!r} us a chunk record down a worker's pipe; "
          f"multiprocessing.Queue.put {put_us!r} us, {flushed_us!r} us with its feeder "
          f"flushed (4096 records, one child reading; host times of the card's "
          f"machine, {smi})")
    native = runs["fac2 one_sided"]
    cal = calibrate(Trace.from_report(native, meta={"seed": 0}),
                    **lat.calibration_overrides(contended_p=P))
    err = cal.percent_error()
    check(math.isfinite(err), f"pt: calibrated percent error {err!r}")
    print(f"pt calibrate fac2 one_sided with the measured o_rma at P={P}: predicted "
          f"T_loop {cal.simulate().T_loop!r} s against {native.wall_time!r} s, "
          f"percent error {err!r}")
    print(f"pt phase: {time.perf_counter() - t_phase:.1f} s wall")
    return {"processes_launches": sum(launched), "processes_runs": len(runs),
            "processes_parent_launches": parent}, assembled


# phase 15: the examples (examples/*_torch.py), each at its own full width
EXAMPLE_TIMEOUT_S = 300
E2E_TOKENS_PER_STEP = 8 * 512  # train_e2e's 100m preset: batch 8 x seq 512
# the first run's steps, then the re-run's total: the resume comes from the
# checkpoint at step 25 (checkpoints every 25; 50 / 75 cost the script ~10 s)
E2E_STEPS = (25, 30)


def load_example(root: Path, name: str):
    """``examples/<name>.py`` as a module (its ``main`` not yet run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, root / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_main(mod, argv):
    """``mod.main(argv)`` in this process: (its result, its stdout, wall s).
    The stdout is printed after the run, each line marked."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = mod.main(argv)
    wall = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        print(f"  | {line}")
    return result, buf.getvalue(), wall


def example_process(root: Path, name: str, argv=()):
    """``python examples/<name>.py argv`` as a subprocess: (stdout, wall s);
    a non-zero exit fails the phase."""
    import os

    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, f"examples/{name}.py", *argv], cwd=root,
                       env=env, capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for line in r.stdout.splitlines():
        print(f"  | {line}")
    check(r.returncode == 0, f"examples: {name} exited {r.returncode}:\n{r.stderr[-3000:]}")
    return r.stdout, wall


def examples_path(root: Path, band_image, plain_image, smi: str) -> dict:
    """Phase 15: the seven examples on the card, each at its own full width.

    ``dls_mandelbrot_torch`` at 4096x4096, CT 2000, over 8 threads in this
    process: 512 static-kernel launches, its image equal to phase 11's
    serial band render (same bands, coordinates and kernel) and within
    0.5 % of the plain image.  ``train_e2e_torch --preset 100m``: 25 steps,
    then a re-run to 30 that must resume at step 25 (per step ms,
    tokens/s, peak memory, each checkpoint's snapshot and write times).
    The other five as subprocesses, each held to its asserts and last
    line; after ``dls_processes_torch`` no child may be left.  Returns row
    2's launches on this path.
    """
    import math
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core.weights import WeightBoard
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    walls = {}

    # -- dls_mandelbrot: 512 bands from 8 threads, each launching the kernel
    mod = load_example(root, "dls_mandelbrot_torch")
    calls, kernel = [], mod.mandelbrot

    def timed_kernel(*a, **kw):  # when each band's launch starts and returns
        t0 = time.perf_counter()
        out = kernel(*a, **kw)
        calls.append((t0, time.perf_counter(), threading.get_ident()))
        return out

    mod.mandelbrot = timed_kernel
    out_dir = Path(tempfile.mkdtemp(prefix="examples_", dir=root / "build"))
    try:
        _build.reset_launches()
        img, out, walls["dls_mandelbrot_torch"] = example_main(mod, [
            "--width", str(IMG), "--ct", str(CT), "--workers", "8",
            "--out", str(out_dir / "mandelbrot.pgm")])
        launched = _build.LAUNCHES["mandelbrot_static"]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    n_bands = IMG // BAND_ROWS
    check(launched == n_bands and len(calls) == n_bands,
          f"examples: dls_mandelbrot launched the static kernel {launched} times "
          f"({len(calls)} calls), {n_bands} bands")
    check(all(v == 0 for k, v in _build.LAUNCHES.items() if k != "mandelbrot_static"),
          f"examples: dls_mandelbrot launched only the static kernel {_build.LAUNCHES}")
    got = torch.from_numpy(img)
    check(torch.equal(got, band_image.cpu()),
          "examples: dls_mandelbrot's image == phase 11's serial band render exactly")
    frac = (got != plain_image.cpu()).double().mean().item()
    check(frac < 0.005, f"examples: dls_mandelbrot vs the plain image {frac!r} (< 0.5 %)")
    span = max(c[1] for c in calls) - min(c[0] for c in calls)
    threads = len({c[2] for c in calls})
    print(f"examples dls_mandelbrot_torch: {IMG}x{IMG} CT {CT}, {launched} launches of "
          f"mandelbrot_static from {threads} threads; == phase 11's band image exactly, "
          f"{frac!r} of pixels differ from the plain image; render {span!r} s from the "
          f"first launch to the last, {span / n_bands * 1e3!r} ms a band (launch, copy "
          f"back, claims); median launch call {statistics.median(c[1] - c[0] for c in calls) * 1e3!r} "
          f"ms; whole example {walls['dls_mandelbrot_torch']!r} s ({smi})")

    # -- train_e2e: 100m, 25 steps, then resumed to 30 -----------------------
    mod = load_example(root, "train_e2e_torch")
    steps_s, snaps, writes = [], [], []
    record, save, write = WeightBoard.record, CheckpointManager.save, CheckpointManager._write

    def timed_record(self, pe, iters, seconds):  # the trainer's own step time
        steps_s.append(seconds)
        return record(self, pe, iters, seconds)

    def timed_save(self, step, *a, **kw):  # the synchronous host snapshot
        t0 = time.perf_counter()
        save(self, step, *a, **kw)
        snaps.append((step, time.perf_counter() - t0))

    def timed_write(self, step, *a):  # the writer thread's file I/O
        t0 = time.perf_counter()
        write(self, step, *a)
        writes.append((step, time.perf_counter() - t0))

    ckpt = Path(tempfile.mkdtemp(prefix="e2e_ckpt_", dir=root / "build"))
    runs = {}
    WeightBoard.record, CheckpointManager.save = timed_record, timed_save
    CheckpointManager._write = timed_write
    try:
        for steps in E2E_STEPS:
            steps_s.clear()
            torch.cuda.reset_peak_memory_stats()
            trainer, out, wall = example_main(mod, [
                "--preset", "100m", "--steps", str(steps), "--ckpt", str(ckpt)])
            runs[steps] = dict(trainer=trainer, out=out, wall=wall, steps_s=list(steps_s),
                               peak=torch.cuda.max_memory_allocated() / 2**30)
    finally:
        WeightBoard.record, CheckpointManager.save = record, save
        CheckpointManager._write = write
        shutil.rmtree(ckpt, ignore_errors=True)
    (n1, n2), (first, second) = E2E_STEPS, (runs[n] for n in E2E_STEPS)
    check(len(first["trainer"].history) == n1 and "resumed" not in first["out"],
          f"examples: train_e2e's first run trains {n1} steps from scratch")
    check(f"[trainer] resumed at step {n1}," in second["out"]
          and len(second["trainer"].history) == n2 - n1,
          f"examples: train_e2e's re-run resumes at step {n1} and trains {n2 - n1} steps")
    losses = first["trainer"].history + second["trainer"].history
    head, tail = statistics.mean(losses[:10]), statistics.mean(losses[-10:])
    check(all(math.isfinite(x) for x in losses) and tail < head,
          f"examples: train_e2e losses finite and falling (mean of the first 10 "
          f"{head!r}, of the last 10 {tail!r})")
    walls["train_e2e_torch"] = first["wall"] + second["wall"]
    for steps, r in runs.items():
        ms = statistics.median(r["steps_s"][1:]) * 1e3
        print(f"examples train_e2e_torch 100m to step {steps}: {len(r['steps_s'])} steps, "
              f"{ms!r} ms a step (median, the trainer's own clock, first step "
              f"{r['steps_s'][0] * 1e3!r} ms), {E2E_TOKENS_PER_STEP / ms * 1e3!r} tokens/s, "
              f"peak {r['peak']!r} GiB; run {r['wall']!r} s ({smi})")
        r["ms"] = ms
    print(f"examples train_e2e_torch checkpoints: snapshot (host copy, blocks the "
          f"step) {snaps!r} s; write (writer thread) {writes!r} s")

    # -- the other five, as subprocesses -------------------------------------
    out, walls["quickstart_torch"] = example_process(root, "quickstart_torch")
    check(out.splitlines()[-1] == "quickstart OK", "examples: quickstart OK")
    out, walls["serve_dls_torch"] = example_process(root, "serve_dls_torch")
    lines = out.splitlines()
    check(lines[-1] == "[serve_dls] real generation OK: (4, 12)",
          f"examples: serve_dls's generation {lines[-1]!r}")
    batchers = [ln for ln in lines if "makespan=" in ln]
    check(len(batchers) == 4 and re.match(r"auto->\w+ ", batchers[-1]),
          f"examples: serve_dls's four batchers {batchers!r}")
    out, walls["dls_hierarchical_torch"] = example_process(root, "dls_hierarchical_torch")
    check(out.splitlines()[-1].startswith("  global-RMW reduction: "),
          "examples: dls_hierarchical ran to its end")
    out, walls["serve_open_loop_torch"] = example_process(root, "serve_open_loop_torch")
    check(out.splitlines()[-1].startswith("[open_loop] auto p99 TTFT "),
          "examples: serve_open_loop ran to its end")
    out, walls["dls_processes_torch"] = example_process(root, "dls_processes_torch")
    check(out.splitlines()[-1].endswith("-- all 2000 iterations still exactly once"),
          "examples: dls_processes's salvage line")
    killed = stop_children()
    check(not killed, f"examples: dls_processes left children behind {killed!r}")
    for name, wall in walls.items():
        print(f"examples wall {name}: {wall!r} s ({smi})")
    print(f"examples phase: {time.perf_counter() - t_phase:.1f} s wall")
    return {"launches_examples": launched, "examples_ms_per_band": span / n_bands * 1e3,
            "examples_e2e_ms_per_step": first["ms"]}


# phase 12: the model plane's decode paths at full width.  name -> (layers
# kept, None for all; B; prompt tokens; new tokens; timing batch (B, T)).
# qwen3-moe keeps 2 of 94 layers (one layer is 2.45 B parameters, 9.7 GB in
# f32: the card's memory), internvl2-26b 12 of 48 (the script's time).  The
# qwen3 checks run at dropless sizes (at most 256 tokens a call); its times
# at 4 x 512, where capacity drops are real.
PLANE = {
    "tinyllama-1.1b": (None, 4, 512, 32, (4, 512)),
    "h2o-danube-3-4b": (None, 2, 4608, 16, (2, 4608)),
    "zamba2-2.7b": (None, 2, 1024, 16, (2, 1024)),
    "qwen3-moe-235b-a22b": (2, 2, 120, 8, (4, 512)),
    "seamless-m4t-medium": (None, 4, 240, 16, (4, 240)),
    "internvl2-26b": (12, 2, 248, 8, (2, 248)),
}
PLANE_ENGINE = ("tinyllama-1.1b", "zamba2-2.7b", "seamless-m4t-medium")
PLANE_SRC = 1024  # seamless: stub source frames
# f32: decode against the forward at tests/test_archs.py:94's bar (atol and
# rtol 2e-3), the two backends within 1e-3 of max |logit|, greedy argmax
# agreement >= 99.9 %
PLANE_DECODE_TOL, PLANE_BACKEND_BAR, PLANE_ARGMAX = 2e-3, 1e-3, 0.999
# bf16, of max |logit|: (decode against the forward, the two backends'
# forwards), about twice the sound readings on an H100 80GB HBM3 at 700 W
# (PERF.md, the model plane's findings): tinyllama 0.020 / 0.022, h2o
# 0.019 / 0.026, seamless 0.016 / 0.018, internvl2 0.015 / 0.017; zamba2
# 0.40 / 0.62 and qwen3-moe 0.19 / 0.24, where bf16 drifts with 54 random
# layers as mamba2's does and a rounding reroutes a token to another
# expert: f32 is their gate
PLANE_BF16_BARS = {
    "tinyllama-1.1b": (5e-2, 5e-2), "h2o-danube-3-4b": (5e-2, 5e-2),
    "zamba2-2.7b": (0.8, 1.0), "qwen3-moe-235b-a22b": (0.4, 0.5),
    "seamless-m4t-medium": (5e-2, 5e-2), "internvl2-26b": (5e-2, 5e-2),
}


def plane_greedy(params, cfg, batch, n_new, dev):
    """Prefill ``batch`` and decode ``n_new`` greedy tokens through the
    port's entry points (backend "pallas").  Returns (tokens (B, n_new),
    logits (B, n_new + 1, vocab): the prefill's and each step's, the
    launches of the prefill and of the decode steps)."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import api

    B, Tp = batch["tokens"].shape
    prefix = batch["prefix_embeds"].shape[1] if "prefix_embeds" in batch else 0
    src = batch["src_embeds"].shape[1] if cfg.is_encdec else None
    cache = api.init_cache(cfg, B, prefix + Tp + n_new, src_len=src, device=dev)
    before = dict(_build.LAUNCHES)
    lg, cache = api.prefill(params, cfg, batch, cache, backend="pallas")
    torch.cuda.synchronize()
    pre = {k: _build.LAUNCHES[k] - before[k] for k in ("flash_attention", "ssd_scan")}
    logits, gen = [lg], []
    tok = lg.argmax(-1).int()
    for _ in range(n_new):
        gen.append(tok)
        lg, cache = api.decode_step(params, cfg, tok, cache, backend="pallas")
        logits.append(lg)
        tok = lg.argmax(-1).int()
    torch.cuda.synchronize()
    dec = {k: _build.LAUNCHES[k] - before[k] - pre[k] for k in pre}
    check(int(cache["pos"]) == prefix + Tp + n_new, f"{cfg.name}: cache position")
    return torch.stack(gen, 1), torch.stack(logits, 1), pre, dec


def plane_forward(params, cfg, batch, backend):
    """(logits, the kernels' launches) of one ``api.forward``."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.models import api

    before = dict(_build.LAUNCHES)
    out = api.forward(params, cfg, batch, backend=backend)
    torch.cuda.synchronize()
    return out, {k: _build.LAUNCHES[k] - before[k] for k in ("flash_attention", "ssd_scan")}


def plane_batch(cfg, B, T, dev, seed=0):
    """Tokens (B, T) from ``seed`` and, by family, the frontend stub's
    source (seamless: PLANE_SRC frames) or prefix (internvl2) on the card."""
    import numpy as np

    from repro_torch.models import api

    batch = {"tokens": np.random.default_rng(seed).integers(0, cfg.vocab, (B, T))
             .astype(np.int32)}
    if cfg.is_encdec:
        batch["src_embeds"] = api.frontend_stub_embeds(cfg, B, PLANE_SRC, seed, device=dev)
    elif cfg.frontend == "vision":
        batch["prefix_embeds"] = api.frontend_stub_embeds(cfg, B, cfg.n_prefix_tokens,
                                                          seed, device=dev)
    return batch


def plane_model(name, dev, launches_out):
    """One model of phase 12: f32 (decode against the forward, the two
    backends, the engine) and then bf16 (the same, with bars set from
    sound runs; times).  Appends the kernels' launches per call to
    ``launches_out``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import api
    from repro_torch.models.params import cast
    from repro_torch.serve import Engine

    layers, B, Tp, n_new, (tB, tT) = PLANE[name]
    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t_model = time.perf_counter()
    params = api.init_params(torch.Generator(device=dev).manual_seed(0), cfg32, device=dev)
    batch = plane_batch(cfg32, B, Tp, dev)
    prefix = cfg.n_prefix_tokens if cfg.frontend == "vision" else 0
    # the expected launches of one forward (pallas) and one prefill: every
    # uncached self-attention call (an enc-dec's encoder and decoder; the
    # hybrid's shared block once a group), and an enc-dec prefill's encoder
    attn_calls = (cfg.enc_layers + cfg.n_layers if cfg.is_encdec else
                  cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers)
    scans = cfg.n_layers if cfg.is_ssm else 0
    want_fwd = {"flash_attention": attn_calls, "ssd_scan": scans}
    want_pre = {"flash_attention": cfg.enc_layers if cfg.is_encdec else 0, "ssd_scan": scans}
    zero = {"flash_attention": 0, "ssd_scan": 0}
    counts = {}

    readings = {}
    for dtype in ("f32", "bf16"):
        c = cfg32 if dtype == "f32" else cfg
        if dtype == "bf16":
            params = cast(params, torch.bfloat16)  # the config's dtype; f32 leaves stay
            batch = {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v
                     for k, v in batch.items()}
        gen, logits, pre, dec = plane_greedy(params, c, batch, n_new, dev)
        full = dict(batch, tokens=np.concatenate([batch["tokens"], gen.cpu().numpy()], 1))
        fwd, fl = plane_forward(params, c, full, "pallas")
        xla, xl = plane_forward(params, c, full, "xla")
        check(fl == want_fwd, f"{name} {dtype}: forward launches {fl} == {want_fwd}")
        check(pre == want_pre, f"{name} {dtype}: prefill launches {pre} == {want_pre}")
        check(dec == zero and xl == zero, f"{name} {dtype}: decode {dec} and xla forward "
              f"{xl} launch nothing")
        counts[dtype] = {"forward": fl, "prefill": pre, "decode": dec}
        T_all = prefix + Tp + n_new
        check(tuple(fwd.shape) == (B, T_all, cfg.vocab), f"{name} {dtype}: forward shape")
        for what, t in (("pallas", fwd), ("xla", xla), ("decode", logits)):
            check(bool(t.isfinite().all()), f"{name} {dtype}: {what} logits finite")
        # prefill (position prefix+Tp-1) and every step against the forward
        ref = fwd[:, prefix + Tp - 1:]
        top = float(fwd.abs().max())
        d_dec = float((logits - ref).abs().max())
        d_back = float((fwd - xla).abs().max())
        agree_dec = float((logits.argmax(-1) == ref.argmax(-1)).double().mean())
        agree_back = float((fwd.argmax(-1) == xla.argmax(-1)).double().mean())
        readings[dtype] = {"decode": d_dec / top, "backends": d_back / top}
        print(f"plane {name} {dtype}: {cfg.n_layers} layers, B={B}, prompt {Tp}"
              f"{f' + {prefix} prefix' if prefix else ''}"
              f"{f', source {PLANE_SRC}' if cfg.is_encdec else ''}, {n_new} new tokens; "
              f"launches {counts[dtype]}; max |decode - forward| {d_dec!r} = "
              f"{d_dec / top!r} of max |logit| {top!r} over the prefill and {n_new} steps; "
              f"max |pallas - xla| {d_back!r} = {d_back / top!r}; argmax agrees: "
              f"decode {agree_dec!r}, backends {agree_back!r}")
        if dtype == "f32":
            ok, _ = close(logits, ref, PLANE_DECODE_TOL, PLANE_DECODE_TOL)
            check(ok, f"{name} f32: decode == forward within atol = rtol = {PLANE_DECODE_TOL}")
            check(d_back <= PLANE_BACKEND_BAR * top,
                  f"{name} f32: backends within {PLANE_BACKEND_BAR} of max |logit|")
            check(agree_dec >= PLANE_ARGMAX and agree_back >= PLANE_ARGMAX,
                  f"{name} f32: greedy argmax agrees on >= {PLANE_ARGMAX}")
        else:
            for k, bar in zip(("decode", "backends"), PLANE_BF16_BARS[name]):
                check(readings["bf16"][k] <= bar,
                      f"{name} bf16: {k} within {bar} of max |logit| "
                      f"({readings['bf16'][k]!r})")
        if name in PLANE_ENGINE:
            prompts = batch["tokens"]
            eng = Engine(c, params, backend="pallas").generate(prompts, max_new=n_new)
            if cfg.is_encdec:  # the engine's source: Tp stub frames, seed 0
                stub = dict(batch, src_embeds=api.frontend_stub_embeds(c, B, Tp,
                                                                       device=dev))
                gen = plane_greedy(params, c, stub, n_new, dev)[0]
            check(np.array_equal(eng, gen.cpu().numpy()),
                  f"{name} {dtype}: Engine.generate == the stepwise greedy tokens")
        del fwd, xla, logits, full
        if dtype == "f32":
            continue
        # times (bf16, the config's dtype)
        tbatch = plane_batch(c, tB, tT, dev, seed=1)
        tcache = api.init_cache(c, tB, prefix + tT + 1,
                                src_len=PLANE_SRC if cfg.is_encdec else None, device=dev)
        shape = f"B={tB} x T={tT}{f' + {prefix} prefix' if prefix else ''}"
        event_and_wall_ms(lambda: api.forward(params, c, tbatch, backend="pallas"),
                          f"plane {name} bf16 forward (pallas) {shape}")
        event_and_wall_ms(lambda: api.prefill(params, c, tbatch, tcache, backend="pallas"),
                          f"plane {name} bf16 prefill {shape}")
        _, tcache = api.prefill(params, c, tbatch, tcache, backend="pallas")
        tok = torch.zeros(tB, dtype=torch.int32, device=dev)
        event_and_wall_ms(lambda: api.decode_step(params, c, tok, tcache, backend="pallas"),
                          f"plane {name} bf16 decode step B={tB}")
        del tcache
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"plane {name}: peak memory {peak!r} GiB; {time.perf_counter() - t_model:.1f} s "
          f"wall; launches {dict(_build.LAUNCHES)}")
    launches_out[name] = {"f32": counts["f32"], "bf16": counts["bf16"]}
    del params, batch
    torch.cuda.empty_cache()
    return readings


def plane_kernels(dev):
    """Phase 12, the kernels at the geometries its models give them, held
    against their plain versions (f32 at the reference's bars, bf16 at
    phase 7's and phase 8's) and timed beside them, SDPA and the bound."""
    import torch

    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.kernels.flash_attention.kernel import _flash_plain
    from repro_torch.kernels.ssd_scan.kernel import _ssd_plain

    def pairs(T, causal, window):
        if not causal:
            return T * T
        return sum(min(r + 1, window or T) for r in range(T))

    once = {"reps": 1, "warmup": False}
    g = torch.Generator(device=dev).manual_seed(0)
    # (caller, B, H, Hkv, T, D, causal, window)
    for who, B, H, Hkv, T, D, causal, window in (
            ("zamba2-2.7b shared block", 2, 32, 32, 1040, 80, True, None),
            ("h2o-danube-3-4b", 2, 32, 8, 4624, 120, True, 4096),
            ("qwen3-moe-235b-a22b", 2, 64, 4, 128, 64, True, None),
            ("seamless-m4t-medium encoder", 4, 16, 16, PLANE_SRC, 64, False, None),
            ("internvl2-26b", 2, 48, 8, 512, 128, True, None)):
        q = torch.randn((B, H, T, D), generator=g, device=dev)
        k, v = (torch.randn((B, Hkv, T, D), generator=g, device=dev) for _ in range(2))
        kw = {"causal": causal, "window": window}
        for dt, rate in ((torch.float32, F32_FLOPS_PER_S), (torch.bfloat16, BF16_FLOPS_PER_S)):
            args = tuple(t.to(dt) for t in (q, k, v))
            out = flash_attention(*args, **kw)
            plain = _flash_plain(*args, **kw)
            if dt == torch.float32:
                ok, d = close(out, plain, 2e-5, 2e-5)
                bar = "2e-5"
            else:
                ok, d, slack = bf16_close(out, plain)
                bar = f"{BF16_BAR} and {BF16_ATOL} + {BF16_RTOL} |plain|; slack {slack!r}"
            check(ok and bool(out.isfinite().all()),
                  f"flash_attention {who} {dt}: kernel == plain within {bar} (max {d!r})")
            ms = cuda_ms(lambda: flash_attention(*args, **kw))
            plain_ms = cuda_ms(lambda: _flash_plain(*args, **kw), **once)
            mask = None
            if window is not None:
                r = torch.arange(T, device=dev)
                mask = (r[None, :] <= r[:, None]) & (r[None, :] > r[:, None] - window)
            lib = sdpa_ms(*args, attn_mask=mask, is_causal=causal and mask is None)
            ops = 4 * D * B * H * pairs(T, causal, window)
            b = bound(args[0].element_size() * 2 * (args[0].numel() + args[1].numel()),
                      ops, rate)
            print(f"plane kernel flash_attention {who} {str(dt)[6:]} q {tuple(q.shape)} "
                  f"Hkv={Hkv} {kw}: max |kernel - plain| {d!r} (bar {bar}); {ms!r} ms "
                  f"({ops / ms / 1e9!r} TFLOP/s); plain {plain_ms!r} ms; sdpa {lib!r} ms; "
                  f"bound {b[0]!r} ms ({b[1]})")
            del out, plain
    # the SSD scan at zamba2-2.7b's 80 heads of 64, state 64 (B=2 x 1040)
    H, Dh, S, L = 80, 64, 64, SSD_CHUNK
    for dt, rate in ((torch.float32, F32_FLOPS_PER_S), (torch.bfloat16, BF16_FLOPS_PER_S)):
        args = ssd_inputs(2, 1040, H, Dh, S, dev, dt)
        y = ssd_scan(*args, chunk=L)
        plain = _ssd_plain(*args, chunk=L)
        if dt == torch.float32:
            ok, d = close(y, plain, 2e-4, 2e-4)
            bar = "2e-4"
        else:
            ok, d, slack = ssd_bf16_close(y, plain)
            bar = f"{BF16_BAR} + {BF16_RTOL} |plain|, slack <= {BF16_ATOL}; slack {slack!r}"
        check(ok and bool(y.isfinite().all()),
              f"ssd_scan zamba2 {dt}: kernel == plain within {bar} (max {d!r})")
        ms = cuda_ms(lambda: ssd_scan(*args, chunk=L))
        plain_ms = cuda_ms(lambda: _ssd_plain(*args, chunk=L), **once)
        size = args[0].element_size()
        nbytes = size * (2 * args[0].numel() + args[1].numel() + 2 * args[3].numel()) + 4 * H
        flops = ssd_flops(2, 1040, H, Dh, S, L)
        b = bound(nbytes, flops, rate)
        print(f"plane kernel ssd_scan zamba2-2.7b {str(dt)[6:]} x {tuple(args[0].shape)} "
              f"S={S}: max |kernel - plain| {d!r} (bar {bar}); {ms!r} ms; plain "
              f"{plain_ms!r} ms; bound {b[0]!r} ms ({b[1]})")


def model_plane_path(dev):
    """Phase 12: every family's decode path at full width -- tinyllama-1.1b
    (dense), h2o-danube-3-4b (SWA ring), zamba2-2.7b (hybrid), qwen3-moe
    (2 of 94 layers), seamless-m4t-medium (enc-dec), internvl2-26b (VLM
    prefix, 12 of 48 layers) -- through ``api`` and ``Engine``, then the
    kernels at the geometries these models give them.  Returns each
    model's launches per call of the two kernels."""
    t_phase = time.perf_counter()
    launches, readings = {}, {}
    for name in PLANE:
        readings[name] = plane_model(name, dev, launches)
    print(f"plane bf16 readings (decode, backends) of max |logit| beside their bars: "
          f"{ {n: ((r['bf16']['decode'], r['bf16']['backends']), PLANE_BF16_BARS[n]) for n, r in readings.items()} !r}")
    plane_kernels(dev)
    print(f"plane phase: {time.perf_counter() - t_phase:.1f} s wall")
    return launches


# phase 13: training.  (a) the chunked attention at tinyllama-1.1b's
# geometry and h2o-danube's window, at the reference's bars
# (tests/test_flash_xla.py): forward atol = rtol = 2e-5, gradients atol 5e-5,
# rtol 5e-4; (b) the reduced tinyllama's train steps on the card against the
# CPU; (c) tinyllama-1.1b at full width through Trainer, then one step per
# remat policy; (d) one step past the chunked threshold; (e) checkpoints.
TRAIN_MODEL = "tinyllama-1.1b"
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 2048, 4
TRAIN_LONG_T = 8192  # (d): the chunked path's threshold
TRAIN_SWA_T = 6144  # (a): h2o-danube's window of 4096 at work
# TinyLlama's published peak learning rate, no warm-up: a bf16 param of
# |w| ~ 0.02 moves by more than its ulp in the first step
TRAIN_LR = 4e-4
# (b): losses and grad_norm within 1e-5 relative; the params' distance
# within 1e-3 of the distance they moved (an element whose gradient sits at
# the rounding noise takes a step of up to lr either way under AdamW,
# tests/test_torch_train.py)
TRAIN_REL, TRAIN_PARAM_REL = 1e-5, 1e-3
# (c): the other policies' loss against "full"'s, relative, in bf16
REMAT_LOSS_REL = 1e-2


def chunked_check(dev, B, T, H, Hkv, D, window, seed):
    """The chunked attention's output and dq/dk/dv against the dense path
    through autograd, f32; returns (fwd err, grad errs, ms chunked, ms
    dense) of one forward + backward each (CUDA events)."""
    import numpy as np
    import torch

    from repro_torch.models import layers as L

    r = np.random.default_rng(seed)
    data = [torch.from_numpy(r.normal(size=s).astype(np.float32)).to(dev)
            for s in ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D))]

    def run(fn):
        ts = [t.clone().requires_grad_(True) for t in data]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        o = fn(*ts)
        torch.sin(o).sum().backward()
        b.record()
        b.synchronize()
        return [o.detach()] + [t.grad for t in ts], a.elapsed_time(b)

    got, ms = run(lambda *t: L._sdpa_chunked(*t, causal=True, window=window))
    want, dense_ms = run(lambda *t: L._sdpa_xla(*t, causal=True, window=window))
    ok, fwd = close(got[0], want[0], 2e-5, 2e-5)
    check(ok, f"chunked attention T={T} window={window}: forward within 2e-5 ({fwd!r})")
    errs = []
    for name, a, b in zip("qkv", got[1:], want[1:]):
        ok, e = close(a, b, 5e-5, 5e-4)
        check(ok, f"chunked attention T={T} window={window}: d{name} within 5e-5 / 5e-4 ({e!r})")
        errs.append(e)
    return fwd, errs, ms, dense_ms


def numpy_tree(params, cfg):
    """The port's params as the reference lays them out, numpy: each
    per-layer list stacked on a leading axis (what ``params_from_numpy``
    takes)."""
    import numpy as np

    from repro_torch.models.params import stacked_depths
    from repro_torch.tree import tree_map

    out = {k: tree_map(lambda t: t.cpu().numpy(), v) for k, v in params.items()}
    for name in stacked_depths(cfg):
        out[name] = tree_map(lambda *xs: np.stack([x.cpu().numpy() for x in xs]),
                             *params[name])
    return out


def tree_distance(a, b) -> float:
    import torch

    from repro_torch.tree import leaves

    return float(torch.sqrt(sum(((x.float().cpu() - y.float().cpu()) ** 2).sum()
                                for x, y in zip(leaves(a), leaves(b)))))


def step_times(fn, what, tokens):
    """One call of ``fn()`` (a train step): CUDA-event ms, wall ms,
    tokens/s by the events and peak GiB since a reset of the peak, printed
    as ``train <what>``; returns (fn's result, the numbers)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ev = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    nums = {"event_ms": ev, "wall_ms": wall, "tokens_per_s": tokens / ev * 1e3,
            "peak_gib": peak}
    print(f"train {what}: {ev!r} ms CUDA events, {wall!r} ms wall, "
          f"{nums['tokens_per_s']!r} tokens/s, peak {peak!r} GiB")
    return out, nums


def train_vs_cpu(dev):
    """(b): the reduced tinyllama in f32, params through
    ``params_from_numpy``, three ``make_train_step`` steps on the card
    against the same three on the CPU; one step with 2 microbatches; each
    remat policy's gradients against "none"'s on the card."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models.params import params_from_numpy
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    from repro_torch.tree import leaves

    cfg = get_config(TRAIN_MODEL).reduced()
    tree = numpy_tree(api.init_params(0, cfg, device="cpu"), cfg)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=0, schedule="constant")
    worst = {"loss": 0.0, "grad_norm": 0.0}

    def steps(microbatches, n):
        """``n`` steps from the same params on the card and on the CPU,
        each step's metrics held to the bar; returns the params."""
        ps = {d: params_from_numpy(tree, cfg, device=d) for d in (dev, "cpu")}
        states = {d: adamw.init(p) for d, p in ps.items()}
        fn = tstep.make_train_step(cfg, opt, microbatches=microbatches)
        for s in range(n):
            batch = {"tokens": np.random.default_rng(30 + s).integers(
                0, cfg.vocab, (4, 64)).astype(np.int32)}
            m = {d: fn(ps[d], states[d], batch)[2] for d in ps}
            for k in worst:
                rel = abs(float(m[dev][k]) - float(m["cpu"][k])) / abs(float(m["cpu"][k]))
                worst[k] = max(worst[k], rel)
                check(rel <= TRAIN_REL, f"train (b) step {s + 1} microbatches="
                                        f"{microbatches}: {k} card vs CPU {rel!r} <= {TRAIN_REL}")
        return ps

    steps(2, 1)
    ps = steps(1, 3)
    p0 = params_from_numpy(tree, cfg, device="cpu")
    moved = tree_distance(ps["cpu"], p0)
    dist = tree_distance(ps[dev], ps["cpu"])
    diffs = [(a.cpu() - b).abs() for a, b in zip(leaves(ps[dev]), leaves(ps["cpu"]))]
    n_over = sum(int((d > 1e-4).sum()) for d in diffs)
    n_all = sum(d.numel() for d in diffs)
    print(f"train (b) reduced {TRAIN_MODEL} f32, 3 steps and, from the same params, "
          f"one with 2 microbatches, card vs CPU: loss {worst['loss']!r}, grad_norm "
          f"{worst['grad_norm']!r} relative at worst; params' distance {dist!r} = "
          f"{dist / moved!r} of the distance moved {moved!r}; max |dp| "
          f"{float(max(d.max() for d in diffs))!r}, {n_over} of {n_all} elements over 1e-4")
    check(dist <= TRAIN_PARAM_REL * moved,
          f"train (b): params' distance within {TRAIN_PARAM_REL} of the distance moved")

    batch = {"tokens": np.random.default_rng(40).integers(0, cfg.vocab, (4, 64)).astype(np.int32)}
    loss0, g0 = tstep.value_and_grad(ps[dev], cfg, batch)
    for policy in ("full", "dots", "group:2"):
        loss, g = tstep.value_and_grad(ps[dev], cfg, batch, remat=policy)
        err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                  for a, b in zip(leaves(g), leaves(g0)))
        print(f"train (b) remat {policy} on the card: loss {float(loss)!r} (none "
              f"{float(loss0)!r}), gradients within {err!r} of each leaf's max")
        check(abs(float(loss) - float(loss0)) <= 1e-6 * abs(float(loss0)) and err <= 1e-6,
              f"train (b): remat {policy} equals none")


# kernel names of the matrix products (cuBLAS, cuBLASLt and CUTLASS)
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")


def profile_split(fn, what):
    """``torch.profiler`` (CUDA activity) over one call of ``fn()``: the
    device time by kernel name, the matrix products' share, the busy share
    of the wall time (which the profiler lengthens), the top kernels."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, count = collections.Counter(), collections.Counter()
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            count[e.name] += 1
    dev = sum(by_name.values())
    gemm = sum(v for k, v in by_name.items() if any(g in k.lower() for g in GEMM_NAMES))
    print(f"train {what} under torch.profiler: {dev!r} ms device time in "
          f"{sum(count.values())} kernels, {wall!r} ms wall (busy {dev / wall!r}); "
          f"matrix products {gemm!r} ms ({gemm / dev!r}), the rest {dev - gemm!r} ms")
    check(dev > 0, f"train {what}: the profiler saw the card's work")
    for name, ms in by_name.most_common(8):
        print(f"  {ms!r} ms ({ms / dev:.2%}) x{count[name]} {name[:100]}")


def checkpoint_path(root, dev):
    """(e): a save and restore of tinyllama's params (bf16) and AdamW
    state (f32) at full width and 2 layers, bit for bit; then a Trainer
    stopped and resumed against an unbroken one (f32, the reduced size of
    tests/test_substrate.py)."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import api
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.tree import leaves, tree_map

    ckdir = root / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        cfg = dataclasses.replace(get_config(TRAIN_MODEL), n_layers=2)
        params = api.init_params(1, cfg, device=dev)
        tree = {"params": params, "opt": adamw.init(params)}
        tree["opt"]["step"].fill_(3)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves(tree))
        mgr = CheckpointManager(str(ckdir / "full"), keep_n=1)
        t0 = time.perf_counter()
        mgr.save(3, tree, extra={"step": 3})
        t_snap = time.perf_counter() - t0
        mgr.wait()
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, extra = mgr.restore(tree_map(torch.zeros_like, tree))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
                   for a, b in zip(leaves(got), leaves(tree)))
        print(f"train (e) checkpoint {TRAIN_MODEL} (2 of 22 layers, bf16 params, f32 "
              f"state): {n_bytes / 1e9!r} GB, snapshot {t_snap!r} s, on disk {t_save!r} s, "
              f"restore {t_restore!r} s; bit-exact {same}")
        check(same and extra == {"step": 3}, "train (e): the restore is bit-exact")
        del got, tree, params

        tiny = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                           n_heads=2, n_kv_heads=2, d_ff=128, vocab=64, dtype="float32")
        kw = dict(per_host_batch=4, seq_len=32, n_samples=500, ckpt_every=10,
                  log_every=1000)
        quiet = dict(log=lambda s: None, device=dev)
        p1, _ = Trainer(tiny, TrainConfig(steps=20, ckpt_dir=str(ckdir / "a"), **kw),
                        **quiet).run()
        Trainer(tiny, TrainConfig(steps=10, ckpt_dir=str(ckdir / "b"), **kw), **quiet).run()
        t3 = Trainer(tiny, TrainConfig(steps=20, ckpt_dir=str(ckdir / "b"), **kw), **quiet)
        p3, _ = t3.run()
        d = max(float((a - b).abs().max()) for a, b in zip(leaves(p1), leaves(p3)))
        print(f"train (e) Trainer stopped at step 10 and resumed to 20 against 20 "
              f"unbroken (f32, tiny): max |dp| {d!r}")
        check(t3.state_step == 20 and d <= 1e-5, "train (e): resume equals an unbroken run")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)


def training_path(root, dev):
    """Phase 13: training on the card -- (a) the chunked attention, (b)
    the card against the CPU, (c) tinyllama-1.1b at full width through
    ``Trainer`` and one step per remat policy, (d) a step past the chunked
    threshold, (e) checkpoints."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import synth_tokens
    from repro_torch.kernels import _build
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train import step as tstep
    from repro_torch.tree import tree_map

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _build.reset_launches()
    cfg = get_config(TRAIN_MODEL)
    h2o = get_config("h2o-danube-3-4b")
    # -- (a) --------------------------------------------------------------
    for what, shape in (
            (f"{TRAIN_MODEL} causal", (1, TRAIN_T, cfg.n_heads, cfg.n_kv_heads, cfg.hd, None)),
            (f"h2o-danube-3-4b SWA {h2o.window}",
             (1, TRAIN_SWA_T, h2o.n_heads, h2o.n_kv_heads, h2o.hd, h2o.window))):
        fwd, errs, ms, dense_ms = chunked_check(dev, *shape, seed=13)
        print(f"train (a) chunked attention {what} (B, T, H, Hkv, D, window) = {shape}, "
              f"f32: forward {fwd!r}, dq/dk/dv {errs!r} from the dense path; forward + "
              f"backward {ms!r} ms, dense {dense_ms!r} ms (CUDA events, first call)")
    torch.cuda.empty_cache()
    # -- (b) --------------------------------------------------------------
    train_vs_cpu(dev)
    torch.cuda.empty_cache()

    # -- (c) --------------------------------------------------------------
    tcfg = TrainConfig(steps=TRAIN_STEPS, per_host_batch=TRAIN_B, seq_len=TRAIN_T,
                       technique="fac2", remat="full", log_every=1)
    opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=0, schedule="constant")
    trainer = Trainer(cfg, tcfg, opt, device=dev, log=lambda s: print(f"  {s}"))
    params, state = trainer.init_or_restore()
    before = [t.clone() for t in (params["embed"], params["layers"][0]["attn"]["wq"],
                                  params["layers"][-1]["mlp"]["wd"])]
    marks, metrics = [], []

    def mark(step, _params, m):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, time.perf_counter()))
        metrics.append({k: float(v) for k, v in m.items()})

    tokens = TRAIN_B * TRAIN_T
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark(0, None, {})
    metrics.clear()
    trainer.run(params, state, hooks=[mark])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = [(a[0].elapsed_time(b[0]), (b[1] - a[1]) * 1e3) for a, b in zip(marks, marks[1:])]
    for i, ((ev, wall), m) in enumerate(zip(steps, metrics)):
        print(f"train (c) {TRAIN_MODEL} full width, bf16, remat full, B={TRAIN_B} x "
              f"T={TRAIN_T}, step {i + 1}: loss {m['loss']!r}, grad_norm {m['grad_norm']!r}; "
              f"{ev!r} ms CUDA events, {wall!r} ms wall (data + step), "
              f"{tokens / ev * 1e3!r} tokens/s")
        check(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
              f"train (c) step {i + 1}: finite loss and grad_norm")
    changed = [float((a != b).double().mean()) for a, b in zip(
        before, (params["embed"], params["layers"][0]["attn"]["wq"],
                 params["layers"][-1]["mlp"]["wd"]))]
    print(f"train (c) peak {peak!r} GiB over the {TRAIN_STEPS} steps; claims from the "
          f"DLS sampler (fac2): epoch state {dataclasses.asdict(trainer.sampler.state())}; "
          f"share of elements changed (embed, layer 0 wq, layer 21 wd): {changed!r}")
    check(len(metrics) == TRAIN_STEPS and min(changed[1:]) > 0.5,
          "train (c): the params changed")
    del before

    # one step per policy on the trained params and one batch; the params
    # and state go back to the trained values from a host copy after each
    # (a copy on the card would cost group:11 the room it needs: it keeps
    # 11 layers' f32 scores, ~4.3 GB a layer)
    batch = {"tokens": torch.from_numpy(synth_tokens(
        99, np.arange(TRAIN_B), TRAIN_T, cfg.vocab)).to(dev)}
    trained = (params, state)
    host = tree_map(lambda t: t.to("cpu", copy=True), trained)
    losses, policy_nums = {}, {}
    for policy in ("full", "dots", "group:11"):
        fn = tstep.make_train_step(cfg, opt, remat=policy)
        (_, _, m), nums = step_times(lambda: fn(params, state, batch),
                                     f"(c) remat {policy} step", tokens)
        losses[policy] = float(m["loss"])
        policy_nums[policy] = nums
        tree_map(lambda t, h: t.copy_(h), trained, host)
        torch.cuda.empty_cache()
    fn = tstep.make_train_step(cfg, opt, remat="full")
    profile_split(lambda: fn(params, state, batch), "(c) remat full step")
    tree_map(lambda t, h: t.copy_(h), trained, host)
    del host
    for policy in ("dots", "group:11"):
        rel = abs(losses[policy] - losses["full"]) / abs(losses["full"])
        print(f"train (c) remat {policy}: loss {losses[policy]!r} against full's "
              f"{losses['full']!r} ({rel!r} relative)")
        check(rel <= REMAT_LOSS_REL, f"train (c): remat {policy} loss within "
                                     f"{REMAT_LOSS_REL} of full's")

    # where one step's time goes (CUDA events): the forward alone, the
    # forward + backward under "full" (which recomputes the forward), the
    # AdamW update; the step's wall time beyond its events is the host's
    with torch.no_grad():
        fwd_ms = event_and_wall_ms(lambda: tstep.loss_fn(params, cfg, batch),
                                   "train (c) split: forward (no grad)")[0]
    grads = {}

    def vg():
        grads["g"] = tstep.value_and_grad(params, cfg, batch, remat="full")[1]

    vg_ms = step_times(vg, "(c) split: forward + backward (remat full)", tokens)[1]["event_ms"]
    p = tree_map(torch.clone, params)
    s = tree_map(torch.clone, state)
    adamw.update(opt, grads["g"], s, p)  # a warm-up: its temporaries allocated
    upd_ms = step_times(lambda: adamw.update(opt, grads["g"], s, p),
                        "(c) split: AdamW update", tokens)[1]["event_ms"]
    del p, s, grads
    full = policy_nums["full"]
    print(f"train (c) split of one step (ms, CUDA events): forward {fwd_ms!r}, "
          f"recomputed forward ~{fwd_ms!r}, backward {vg_ms - 2 * fwd_ms!r}, AdamW "
          f"{upd_ms!r}; the step {full['event_ms']!r}, host beyond the events "
          f"{full['wall_ms'] - full['event_ms']!r}")
    torch.cuda.empty_cache()

    # -- (d) --------------------------------------------------------------
    long_batch = {"tokens": torch.from_numpy(synth_tokens(
        98, np.arange(1), TRAIN_LONG_T, cfg.vocab)).to(dev)}
    bwd_calls = []
    bwd = L._flash_bwd_core
    L._flash_bwd_core = lambda *a: bwd_calls.append(1) or bwd(*a)
    try:
        fn = tstep.make_train_step(cfg, opt, remat="full")
        (_, _, m), _ = step_times(lambda: fn(params, state, long_batch),
                                  f"(d) B=1 x T={TRAIN_LONG_T} remat full step", TRAIN_LONG_T)
    finally:
        L._flash_bwd_core = bwd
    print(f"train (d) loss {float(m['loss'])!r}, grad_norm {float(m['grad_norm'])!r}; "
          f"chunked attention backward calls {len(bwd_calls)}")
    check(bool(torch.isfinite(m["loss"])) and len(bwd_calls) == cfg.n_layers,
          f"train (d): finite loss through the chunked path ({len(bwd_calls)} layers)")
    del params, state, trainer, trained
    torch.cuda.empty_cache()

    # -- (e) --------------------------------------------------------------
    checkpoint_path(root, dev)
    # the training path is the "xla" backend: no kernel of the port runs
    check(not any(_build.LAUNCHES.values()),
          f"train: no kernel launched in phase 13 ({_build.LAUNCHES})")
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s wall")


# phase 14: the model plane sharded on a one-card mesh.  tinyllama-1.1b
# and mamba2-370m at full width, B x T each; the ctx forward's bars of max
# |logit| (f32: the same arithmetic on the same shards; bf16: a rounding
# of the logits' scale), the train step's loss bar (relative)
SHARD_B, SHARD_T = 4, 512
SHARD_BARS = {"float32": 1e-6, "bfloat16": 1e-3}
SHARD_LOSS_BAR = 1e-6


def shard_path(root, dev, card):
    """Phase 14: ``repro_torch.shard`` on a (data=1, model=1) mesh over a
    one-rank NCCL group -- the ctx forward, prefill, decode and train step
    against the same calls without ctx, launches counted under ctx, the
    times of both; ``launch.serve`` at full width; the device hierarchy.
    Returns the kernels' launches under ctx.  (The dry run's tinyllama-1.1b
    ``train_4k`` cell on 256 fake ranks took 35.8 s of the card machine's
    host, over the phase's 30 s for it, so it is not run here.)"""
    import dataclasses
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import dls
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_device_hierarchy, make_test_mesh
    from repro_torch.models import api
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.params import cast
    from repro_torch.optim import adamw
    from repro_torch.shard import cache_pspecs, distribute, make_ctx, params_pspecs
    from repro_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    launches = {"flash_attention": {}, "ssd_scan": {}}
    try:
        mesh = make_test_mesh(1)
        ctx = make_ctx(mesh)
        check(tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model"),
              f"shard: the one-card test mesh {mesh}")
        print(f"shard mesh: {mesh} over a one-rank NCCL group ({card})")
        rng = np.random.default_rng(0)

        def rel(got, want):
            got = got.full_tensor() if hasattr(got, "full_tensor") else got
            return float((got.float() - want.float()).abs().max() / want.float().abs().max())

        def timed(what, fn_ctx, fn_plain):
            a = event_and_wall_ms(fn_ctx, f"shard {what} ctx ({card})")
            b = event_and_wall_ms(fn_plain, f"shard {what} no ctx ({card})")
            print(f"  shard {what}: ctx - no ctx = {a[0] - b[0]!r} ms CUDA events, "
                  f"{a[1] - b[1]!r} ms wall")

        def forward_pair(name, kernel, n_layers, dtype, params32, cfg32, batch):
            cfg = dataclasses.replace(cfg32, dtype=dtype)
            params = params32 if dtype == "float32" else cast(params32, dtype_of(dtype))
            sp = distribute(params, params_pspecs(params), mesh)
            torch.cuda.synchronize()
            _build.reset_launches()
            got = api.forward(sp, cfg, batch, ctx=ctx, backend="pallas")
            torch.cuda.synchronize()
            n = _build.LAUNCHES[kernel]
            launches[kernel][f"{name} {dtype} forward"] = n
            check(n == n_layers, f"shard {name} {dtype}: {n} {kernel} launches "
                  f"in one ctx forward, want {n_layers}")
            want = api.forward(params, cfg, batch, backend="pallas")
            err = rel(got, want)
            check(err <= SHARD_BARS[dtype] and got.shape == want.shape,
                  f"shard {name} {dtype}: ctx forward within {SHARD_BARS[dtype]} of max "
                  f"|logit| ({err!r})")
            print(f"shard {name} {dtype} forward (pallas, {SHARD_B} x {SHARD_T}): "
                  f"{n} {kernel} launches under ctx; |ctx - no ctx| = {err!r} of max |logit|")
            timed(f"{name} {dtype} forward",
                  lambda: api.forward(sp, cfg, batch, ctx=ctx, backend="pallas"),
                  lambda: api.forward(params, cfg, batch, backend="pallas"))
            return sp

        # -- tinyllama-1.1b: forward, prefill, decode, train step --------------
        cfg32 = dataclasses.replace(get_config(MODEL), dtype="float32")
        params32 = api.init_params(0, cfg32, device=dev)
        tokens = torch.from_numpy(rng.integers(0, cfg32.vocab, (SHARD_B, SHARD_T))).to(dev)
        batch = {"tokens": tokens}
        for dtype in ("float32", "bfloat16"):
            sp = forward_pair(MODEL, "flash_attention", cfg32.n_layers, dtype, params32,
                              cfg32, batch)
        del sp
        sp = distribute(params32, params_pspecs(params32), mesh)
        cache = api.init_cache(cfg32, SHARD_B, SHARD_T + 1, device=dev)
        scache = distribute(cache, cache_pspecs(cache, mesh, kv_heads=cfg32.n_kv_heads), mesh)
        _build.reset_launches()
        lg, cg = api.prefill(sp, cfg32, batch, scache, ctx=ctx, backend="pallas")
        lw, cw = api.prefill(params32, cfg32, batch, cache, backend="pallas")
        tok = lw.argmax(-1)
        dg, _ = api.decode_step(sp, cfg32, tok, cg, ctx=ctx, backend="pallas")
        dw, _ = api.decode_step(params32, cfg32, tok, cw, backend="pallas")
        torch.cuda.synchronize()
        launches["flash_attention"][f"{MODEL} float32 prefill+decode"] = \
            _build.LAUNCHES["flash_attention"]
        check(_build.LAUNCHES["flash_attention"] == 0,
              "shard: a cached attention call never reaches the kernel")
        e_pre, e_dec = rel(lg, lw), rel(dg, dw)
        check(e_pre <= SHARD_BARS["float32"] and e_dec <= SHARD_BARS["float32"],
              f"shard {MODEL}: ctx prefill {e_pre!r}, decode {e_dec!r} of max |logit|")
        check(bool((lg.full_tensor().argmax(-1) == tok).all()), "shard: the same greedy token")
        print(f"shard {MODEL} float32 prefill ({SHARD_T} tokens) and one greedy decode "
              f"step: |ctx - no ctx| = {e_pre!r}, {e_dec!r} of max |logit|")
        timed(f"{MODEL} float32 prefill",
              lambda: api.prefill(sp, cfg32, batch, scache, ctx=ctx, backend="pallas"),
              lambda: api.prefill(params32, cfg32, batch, cache, backend="pallas"))
        timed(f"{MODEL} float32 decode step",
              lambda: api.decode_step(sp, cfg32, tok, cg, ctx=ctx, backend="pallas"),
              lambda: api.decode_step(params32, cfg32, tok, cw, backend="pallas"))
        del cache, scache, cg, cw
        torch.cuda.empty_cache()
        ocfg = adamw.AdamWConfig(warmup_steps=1, total_steps=10)
        sopt, opt = adamw.init(sp), adamw.init(params32)
        step_ctx = make_train_step(cfg32, ocfg, ctx=ctx, microbatches=2)
        step = make_train_step(cfg32, ocfg, microbatches=2)
        _build.reset_launches()
        _, _, m_ctx = step_ctx(sp, sopt, batch)
        _, _, m = step(params32, opt, batch)
        torch.cuda.synchronize()
        check(sum(_build.LAUNCHES.values()) == 0, "shard: no kernel launches in a train step")
        e_loss = abs(float(m_ctx["loss"]) - float(m["loss"])) / abs(float(m["loss"]))
        check(e_loss <= SHARD_LOSS_BAR,
              f"shard {MODEL}: ctx train step loss within {SHARD_LOSS_BAR} ({e_loss!r})")
        print(f"shard {MODEL} float32 train step (2 microbatches of {SHARD_B // 2} x "
              f"{SHARD_T}): loss {float(m['loss'])!r}, ctx loss relative error {e_loss!r}")
        timed(f"{MODEL} float32 train step", lambda: step_ctx(sp, sopt, batch),
              lambda: step(params32, opt, batch))
        del sp, sopt, opt, params32, step_ctx, step
        torch.cuda.empty_cache()

        # -- mamba2-370m: the forward through the SSD scan ---------------------
        scfg32 = dataclasses.replace(get_config(SSM_MODEL), dtype="float32")
        sparams32 = api.init_params(0, scfg32, device=dev)
        sbatch = {"tokens": torch.from_numpy(
            rng.integers(0, scfg32.vocab, (SHARD_B, SHARD_T))).to(dev)}
        for dtype in ("float32", "bfloat16"):
            forward_pair(SSM_MODEL, "ssd_scan", scfg32.n_layers, dtype, sparams32, scfg32,
                         sbatch)
        del sparams32
        torch.cuda.empty_cache()

        # -- the device hierarchy -------------------------------------------
        hw = make_device_hierarchy(capacity=64)
        s = dls.loop(90, "fac2", P=2, runtime="hierarchical", nodes=1, window=hw)
        rep = dls.execute(s, None, executor="serial")
        cov = np.zeros(90, np.int64)
        for c in rep.claims:
            cov[c.start:c.start + c.size] += 1
        check((cov == 1).all() and int(rep.per_pe_iters.sum()) == 90,
              "shard: the device hierarchy claims each of 90 iterations once")
        print(f"shard hierarchy: dls.loop(90, fac2, P=2, hierarchical) over "
              f"make_device_hierarchy(capacity=64) on {torch.cuda.device_count()} card(s): "
              f"each iteration claimed once, {rep.steps} claims")
    finally:
        dist.destroy_process_group()

    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    # -- launch.serve at full width ----------------------------------------
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch", MODEL,
                        "--no-reduced", "--requests", "64", "--batch", "8"],
                       capture_output=True, text=True, timeout=300, cwd=root, env=env)
    lines = [x for x in r.stdout.splitlines() if x.startswith("[serve]")]
    check(r.returncode == 0 and len(lines) == 2
          and lines[0].startswith("[serve] generated (8, 16) in ")
          and lines[1].startswith("[serve] makespan: DLS(gss)="),
          f"shard: launch.serve at full width: {r.stdout[-500:]} {r.stderr[-1500:]}")
    for x in lines:
        print(f"shard {x} ({card}; {time.perf_counter() - t0:.1f} s with start-up)")
    print(f"shard phase: {time.perf_counter() - t_phase:.1f} s wall")
    return launches


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
    become_subreaper()

    from repro_torch import dls
    from repro_torch.core.chunk_calculus import max_steps_bound, plan
    from repro_torch.device import claim_schedule, host_spec, slab_to_numpy
    from repro_torch.device.persistent import (
        _RANK_CHUNK as RANK_CHUNK, _claim_loop_cuda, _claim_loop_plain, cost_prefix_sum,
        launch_claim)
    from repro_torch.device.window import fetch_add_slab
    from repro_torch.kernels import (
        _build, mandelbrot, mandelbrot_persistent, mandelbrot_ref, spin_images,
        spin_images_oracle)
    from repro_torch.kernels.mandelbrot.persistent import (
        _persistent_cuda, _persistent_plain, mandelbrot_tile_costs)
    from repro_torch.kernels.spin_image.ref import spin_pair_counts

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
        # phases 6, 7, 8 print theirs by name
        if name not in ("protocol", "flash_attention", "ssd_scan"):
            for fn, info in ptxas_report(log).items():
                print(f"  ptxas {name} {fn}: {info}")

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
    schedules = {t: claim_schedule(t, N, P, costs=costs) for t in ("gss", "fac2", "ss")}
    persistent = {t: mandelbrot_persistent(
        IMG, ct=CT, block_h=TILE, block_w=TILE, workers=P, schedule=schedules[t])[0]
        for t in schedules}
    # the entry's own claim: the protocol, table and compute kernels on one stream
    claimed = {t: mandelbrot_persistent(IMG, ct=CT, block_h=TILE, block_w=TILE, workers=P,
                                        technique=t, costs=costs)
               for t in schedules}
    spins = spin_images(points, normals, N_IMAGES, img_width=IMG_W,
                        bin_size=BIN, support_angle=SUPPORT)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t_main
    launches = dict(_build.LAUNCHES)
    print(f"main path: {main_s:.2f} s wall, launches {launches}")
    for k in ("window_fetch_add", "protocol", "claim_tables", "mandelbrot_static",
              "mandelbrot_persistent", "spin_image"):
        check(launches[k] > 0, f"kernel {k} was not launched on the main path")

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
    for t, (out, sched) in claimed.items():
        check(torch.equal(out, image), f"persistent ({t}, claimed by the entry) == static")
        for f in ("steps", "workers", "starts", "sizes", "counts", "clocks"):
            check(np.array_equal(getattr(sched, f), getattr(schedules[t], f)),
                  f"{t}: the entry's schedule {f} == claim_schedule's")
    tabs = schedules["gss"].tables()
    pers_plain = _persistent_plain(*tabs, width=IMG, height=IMG,
                                   ct=CT, xlim=(-2.0, 1.0), ylim=(-1.5, 1.5),
                                   block_h=TILE, block_w=TILE, gw=IMG // TILE,
                                   device=dev)
    check(torch.equal(pers_plain, persistent["gss"]), "persistent kernel == plain")
    err["mandelbrot_persistent"] = float((pers_plain - persistent["gss"]).abs().max())
    print("mandelbrot persistent (gss, fac2, ss; passed in and claimed by the entry) "
          "== static exactly; == plain")
    # the paper's loop, 1x1 tiles under ss: the kernel's packed path
    pixel_image = mandelbrot(PIXELS, ct=PIXEL_CT)
    pixel_costs = mandelbrot_tile_costs(pixel_image, 1, 1)
    pixel_sched = claim_schedule("ss", PIXELS * PIXELS, P, costs=pixel_costs)
    pixel_tables = card_tables(pixel_sched, dev)
    pixel_kw = dict(width=PIXELS, height=PIXELS, ct=PIXEL_CT, xlim=(-2.0, 1.0),
                    ylim=(-1.5, 1.5), block_h=1, block_w=1, gw=PIXELS, device=dev)
    pixel_out = _persistent_cuda(*pixel_tables, **pixel_kw)
    check(torch.equal(pixel_out, pixel_image), "persistent (ss, 1x1 tiles) == static exactly")
    check(torch.equal(_persistent_plain(*pixel_sched.tables(), **pixel_kw), pixel_out),
          "persistent (ss, 1x1 tiles) == plain")
    print(f"mandelbrot persistent over {PIXELS}x{PIXELS} CT {PIXEL_CT} in 1x1 tiles (ss, "
          f"{pixel_sched.n_steps} claims; packed onto lanes) == static exactly; == plain")
    # the card's claim tables against the host's, at the main path's shapes
    # and at the paper's one-pixel ss loop (1,327,104 grants, many rank chunks)
    table_cases = {t: (t, N, costs) for t in schedules}
    table_cases["ss pixels"] = ("ss", PIXELS * PIXELS, None)
    claims = {}
    for name, (t, n_, c_) in table_cases.items():
        claim = launch_claim(t, n_, P, costs=c_, device=dev)
        card = claim.tables()
        claims[name] = claim, claim.read_back()
        e = card_tables_error(card, claims[name][1])
        lib = tables_by_sort(claim)
        e_lib = card_tables_error(lib, claims[name][1])
        check(e == 0 and e_lib == 0, f"claim tables {name}: card == host tables and "
                                     f"worker_lists (max {e}; torch.sort version {e_lib})")
        err["claim_tables"] = max(err.get("claim_tables", 0), e)
    print(f"claim tables (gss, fac2, ss at N={N}; ss at {PIXELS}x{PIXELS} pixels, "
          f"{claims['ss pixels'][1].n_steps} grants) == the host's tables exactly")

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
    pairs = spin_pair_counts(points, normals, N_IMAGES, img_width=IMG_W,
                             bin_size=BIN, support_angle=SUPPORT, point_chunk=4096)
    check(pairs["land"] == int(per_image.sum()), "gate counts: landed == histograms' total")
    print(f"gate: of {pairs['pairs']} pairs (exact tests, plain version) "
          f"{pairs['k']} have k in [0, W) ({pairs['k'] / pairs['pairs']!r}), "
          f"{pairs['kl']} k and l ({pairs['kl'] / pairs['pairs']!r}), "
          f"{pairs['land']} land ({pairs['land'] / pairs['pairs']!r})")

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
        rows.append(kernel_row(name, source, replaces, launches[name], err[name],
                               ms, plain_ms, bound(nbytes, ops), None, plain_where))

    # window fetch-add: one host RMW (launch + 4-byte read back)
    row("window_fetch_add", "src/repro_torch/csrc/window.cu",
        "src/repro/device/window.py:44",
        cuda_ms(lambda: fetch_add_slab(wslab, 0, 1)),
        host_ms(lambda: fetch_add_slab(cslab, 0, 1)), 12, 1, "host CPU")

    # protocol: the gss launch of the main path, CUDA-event time per wrapper
    # call, each call from fresh counters (two slots of one zeroed slab a call)
    protocol_sass()
    # phase 2's drains and its gss (513, 3) one; claim_schedule's and the entry's
    check(launches["protocol"] == len(TECHNIQUES) + 1 + 2 * len(schedules),
          "the main path's protocol launches")
    spec = host_spec("gss", N, P)
    S = int(max_steps_bound(spec))
    kw = dict(technique="gss", N=N, P=P, chunk=1, max_chunk=None, S=S,
              i_bits=(2 * S).bit_length())
    csum = cost_prefix_sum(costs, N)
    csum_card = torch.from_numpy(csum).to(dev)
    n_steps = schedules["gss"].n_steps
    slab, calls = torch.zeros(2 * (REPS + 2), dtype=torch.int32, device=dev), []

    def protocol_launch():  # the check's call, cuda_ms's warm-up and its REPS
        calls.append(2 * len(calls))
        return _claim_loop_cuda(slab, csum_card, i_slot=calls[-1], lp_slot=calls[-1] + 1,
                                **kw)[0]

    check(int((protocol_launch()[:, 1] >= 0).sum()) == n_steps,
          "timed gss launch == the main path's")
    proto_plain = host_ms(lambda: _claim_loop_plain(
        torch.zeros(2, dtype=torch.int32), torch.from_numpy(csum), i_slot=0, lp_slot=1, **kw))
    row("protocol", "src/repro_torch/csrc/protocol.cu",
        "src/repro/device/persistent.py:42", cuda_ms(protocol_launch), proto_plain,
        8 + 4 * (N + 1) + 16 * n_steps + 8 * P, n_steps * (P + 40), "host CPU")

    # The plain versions of the applications take seconds where the kernels
    # take milliseconds; each already ran once in its check above, so one
    # timed run of each is enough.
    once = {"reps": 1, "warmup": False}
    mb_bytes = 4 * IMG * IMG
    row("mandelbrot_static", "src/repro_torch/csrc/mandelbrot.cu",
        "src/repro/kernels/mandelbrot/kernel.py:81",
        cuda_ms(lambda: mandelbrot(IMG, ct=CT)),
        cuda_ms(lambda: mandelbrot_ref(IMG, ct=CT), **once),
        mb_bytes, MANDEL_OPS_PER_ITER * sum_counts)
    print(f"  mandelbrot_static bound at {MANDEL_OPS_PER_ITER_ANEW} operations per "
          f"iteration: {bound(mb_bytes, MANDEL_OPS_PER_ITER_ANEW * sum_counts)[0]!r} ms")

    # the claim tables: the three kernels of one PendingClaim.tables() call
    # (the launch count is three a call), against numpy on the host and a
    # torch.sort version on the card; the gss schedule as the other rows,
    # the ss pixel loop beside it
    def tables_row(name):
        claim, sched = claims[name]
        S = int(claim._sched.shape[0])
        return (cuda_ms(claim.tables), host_ms(sched.tables), cuda_ms(lambda: tables_by_sort(claim)),
                bound(claim_tables_bytes(sched, S, RANK_CHUNK), 0))

    tms, tplain, tlib, tbound = tables_row("gss")
    rows.append(kernel_row("claim_tables", "src/repro_torch/csrc/protocol.cu",
                           "src/repro/device/persistent.py:135",
                           launches["claim_tables"], err["claim_tables"], tms, tplain,
                           tbound, tlib, "host CPU"))
    pms, pplain, plib, pbound = tables_row("ss pixels")
    rows[-1].update(kernels_per_call=3, ms_ss_pixels=pms, plain_ms_ss_pixels=pplain,
                    library_ms_ss_pixels=plib, bound_ms_ss_pixels=pbound[0])
    print(f"time claim_tables ss over {PIXELS}x{PIXELS} pixels: {pms!r} ms; plain (host "
          f"CPU) {pplain!r} ms; bound {pbound[0]!r} ms ({pbound[1]}); torch.sort {plib!r} ms")

    def run_persistent(*tables):
        return _persistent_cuda(
            *tables, width=IMG, height=IMG, ct=CT, xlim=(-2.0, 1.0),
            ylim=(-1.5, 1.5), block_h=TILE, block_w=TILE, gw=IMG // TILE,
            device=dev)

    # per schedule: the time, and the schedule-aware bound -- the busiest
    # worker's modeled iterations on one SM's share of the f32 rate
    pers_ms, sched_bound = {}, {}
    for t in ("gss", "fac2", "ss"):
        tables = card_tables(schedules[t], dev)
        pers_ms[t] = cuda_ms(lambda: run_persistent(*tables))
        iters = worker_iterations(schedules[t], costs)
        sched_bound[t] = MANDEL_OPS_PER_ITER * float(iters.max()) / (F32_OPS_PER_S / P) * 1e3
        print(f"time mandelbrot_persistent over the {t} schedule: {pers_ms[t]!r} ms; "
              f"schedule-aware bound {sched_bound[t]!r} ms (at "
              f"{MANDEL_OPS_PER_ITER_ANEW} operations per iteration "
              f"{sched_bound[t] * MANDEL_OPS_PER_ITER_ANEW / MANDEL_OPS_PER_ITER!r})")
        if t != "fac2":
            report_workers(t, worker_times(schedules[t], run_persistent), iters, pers_ms[t])
    row("mandelbrot_persistent", "src/repro_torch/csrc/mandelbrot.cu",
        "src/repro/kernels/mandelbrot/persistent.py:28", pers_ms["gss"],
        cuda_ms(lambda: _persistent_plain(
            *tabs, width=IMG, height=IMG, ct=CT, xlim=(-2.0, 1.0),
            ylim=(-1.5, 1.5), block_h=TILE, block_w=TILE, gw=IMG // TILE,
            device=dev), **once),
        mb_bytes + 4 * (2 * P + 2 * tabs.starts.size), MANDEL_OPS_PER_ITER * sum_counts)
    # the paper's loop (phase 4's pixel tables), beside its schedule-aware bound
    pixel_ms = cuda_ms(lambda: _persistent_cuda(*pixel_tables, **pixel_kw))
    pixel_bound = (MANDEL_OPS_PER_ITER * float(worker_iterations(pixel_sched, pixel_costs).max())
                   / (F32_OPS_PER_S / P) * 1e3)
    print(f"time mandelbrot_persistent over {PIXELS}x{PIXELS} pixels (ss, packed): "
          f"{pixel_ms!r} ms; schedule-aware bound {pixel_bound!r} ms")
    rows[-1].update(ms_fac2=pers_ms["fac2"], ms_ss=pers_ms["ss"],
                    schedule_bound_ms=sched_bound, ms_pixels_ss=pixel_ms,
                    bound_ms_pixels_ss=pixel_bound)

    spin_ops = SPIN_OPS_PER_PAIR * pairs["pairs"] + SPIN_OPS_K_PAIR * pairs["k"]
    spin_bytes = 24 * N_POINTS + 4 * N_IMAGES * IMG_W * IMG_W
    row("spin_image", "src/repro_torch/csrc/spin_image.cu",
        "src/repro/kernels/spin_image/kernel.py:31",
        cuda_ms(lambda: spin_images(points, normals, N_IMAGES, img_width=IMG_W,
                                    bin_size=BIN, support_angle=SUPPORT)),
        cuda_ms(lambda: spin_images_oracle(
            points, normals, N_IMAGES, img_width=IMG_W, bin_size=BIN,
            support_angle=SUPPORT, point_chunk=4096), **once),
        spin_bytes, spin_ops)
    all_pairs = bound(spin_bytes, (SPIN_OPS_PER_PAIR + SPIN_OPS_K_PAIR) * pairs["pairs"])[0]
    rows[-1].update(bound_all_pairs_ms=all_pairs)
    print(f"  spin_image bound of every pair at {SPIN_OPS_PER_PAIR + SPIN_OPS_K_PAIR} "
          f"operations: {all_pairs!r} ms")

    # f32 products in full f32 on both sides (TF32 off, PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows += attention_path(dev, P, static_launches=model_path(dev))
    rows += hybrid_path(dev, P)
    rows += moe_path(dev)
    t_ssm = time.perf_counter()
    rows.append(ssm_model_path(dev))
    print(f"ssm phase: {time.perf_counter() - t_ssm:.1f} s wall")
    # -- 12. the model plane's decode paths at full width -------------------
    plane = model_plane_path(dev)
    for r in rows:
        if r["name"] in ("flash_attention", "ssd_scan"):
            r["launches_model_plane"] = {
                m: {call: n[r["name"]] for call, n in v["bf16"].items()}
                for m, v in plane.items()}
    # -- 13. training: the chunked attention, card vs CPU, tinyllama-1.1b --
    training_path(root, dev)
    # -- 14. sharding: the model plane on a one-card mesh, serve, dry run -----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    shard = shard_path(root, dev, card)
    for r in rows:
        if r["name"] in shard:
            r["launches_shard"] = shard[r["name"]]
    # -- 9. the DES (no kernel: the fast path's batch core on the card) -----
    des_path()
    # -- 10. replay: device traces, technique="auto", PSIA, the CLI --------
    replay_path(root, P, costs, sessions, image)

    # -- 11. processes: bands of the image over real OS processes ----------
    static_row = next(r for r in rows if r["name"] == "mandelbrot_static")
    pt_launches, band_image = processes_path(image, plain_image, card)
    static_row.update(pt_launches)
    killed = stop_children()
    print(f"processes: every child stopped; {len(killed)} killed after the grace "
          f"period {killed!r}")
    # -- 15. the examples, at their own full width ---------------------------
    static_row.update(examples_path(root, band_image, plain_image, card))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
