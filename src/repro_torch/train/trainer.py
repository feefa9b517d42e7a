"""Training loop: DLS-claimed data, AWF straggler mitigation, checkpoints.

Port of ``repro.train.trainer``.  ``Trainer`` is the single-process driver
(one process = one "host"), on ``device`` (default ``"cuda"``; it raises
without a card and never moves to the CPU unless asked).  ``SimCluster``
runs H logical hosts as threads against one shared RMA window -- the
paper's execution model in-process -- so fault-tolerance/elasticity tests
can kill and revive hosts and watch the unclaimed work get picked up by
survivors (the one-sided protocol's natural elasticity).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.core.weights import WeightBoard
from repro_torch.data.pipeline import DLSSampler, EpochState, HostDataIterator
from repro_torch.kernels import _build
from repro_torch.models import api
from repro_torch.optim import adamw

from .step import make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    per_host_batch: int = 8
    seq_len: int = 128
    n_samples: int = 10_000
    n_hosts: int = 1
    host_id: int = 0
    technique: str = "fac2"
    microbatches: int = 1
    remat: str = "none"
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    log_every: int = 10


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (``jax.block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, cfg, tcfg: TrainConfig, opt_cfg: Optional[adamw.AdamWConfig] = None,
                 *, window=None, board: Optional[WeightBoard] = None,
                 log: Callable[[str], None] = print, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = _build.target_device(device, "Trainer")
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(total_steps=tcfg.steps)
        self.log = log
        self.board = board or WeightBoard(tcfg.n_hosts)
        self.sampler = DLSSampler(
            tcfg.n_samples, tcfg.n_hosts, tcfg.host_id,
            technique=tcfg.technique, window=window, weight_board=self.board)
        self.data = HostDataIterator(
            self.sampler, seq_len=tcfg.seq_len, vocab=cfg.vocab,
            per_host_batch=tcfg.per_host_batch, seed=tcfg.seed)
        self.step_fn = make_train_step(
            cfg, self.opt_cfg, microbatches=tcfg.microbatches, remat=tcfg.remat)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, host_id=tcfg.host_id)
                     if tcfg.ckpt_dir else None)
        self.state_step = 0
        self.history: list = []

    # ------------------------------------------------------------------
    def init_or_restore(self):
        """Params from ``tcfg.seed`` (the port's draws) and a fresh AdamW
        state, or the latest checkpoint's if there is one."""
        params = api.init_params(self.tcfg.seed, self.cfg, device=self.device)
        opt_state = adamw.init(params)
        if self.ckpt is not None:
            restored, extra = self.ckpt.restore({"params": params, "opt": opt_state})
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                self.state_step = int(extra["step"])
                self.sampler.restore(EpochState(**extra["data"]))
                self.log(f"[trainer] resumed at step {self.state_step}, "
                         f"epoch state {extra['data']}")
        return params, opt_state

    def run(self, params=None, opt_state=None, *, hooks=None):
        if params is None:
            params, opt_state = self.init_or_restore()
        it = iter(self.data)
        while self.state_step < self.tcfg.steps:
            batch_np = next(it)
            batch = {"tokens": torch.as_tensor(batch_np["tokens"], device=self.device)}
            t0 = time.perf_counter()
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            # the step's time includes the device's work: AWF learns
            # throughput, not launch latency
            synchronize(self.device)
            dt = time.perf_counter() - t0
            self.state_step += 1
            # AWF: feed measured throughput back into the chunk weights
            self.board.record(self.tcfg.host_id,
                              iters=self.tcfg.per_host_batch, seconds=dt)
            self.history.append(float(metrics["loss"]))
            if hooks:
                for h in hooks:
                    h(self.state_step, params, metrics)
            if self.state_step % self.tcfg.log_every == 0:
                self.log(
                    f"[trainer] step {self.state_step} loss={float(metrics['loss']):.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms "
                    f"w={self.board.weight(self.tcfg.host_id):.2f}")
            if self.ckpt is not None and self.state_step % self.tcfg.ckpt_every == 0:
                st = self.sampler.state()
                self.ckpt.save(
                    self.state_step, {"params": params, "opt": opt_state},
                    extra={"step": self.state_step, "data": dataclasses.asdict(st)})
        if self.ckpt is not None:
            st = self.sampler.state()
            self.ckpt.save(self.state_step, {"params": params, "opt": opt_state},
                           extra={"step": self.state_step,
                                  "data": dataclasses.asdict(st)}, block=True)
            self.ckpt.wait()
        return params, opt_state


# ---------------------------------------------------------------------------
# Simulated multi-host cluster (threads sharing one window) for FT tests
# ---------------------------------------------------------------------------


class SimCluster:
    """H logical hosts as threads; shared RMA window; per-host speed model.

    Used by the fault-tolerance tests and examples: hosts claim data chunks
    via DLS; ``kill(h)`` makes a host stop claiming (its in-flight chunk is
    lost work but the *unclaimed* iteration space is picked up by others --
    with synthetic-deterministic data there is no data loss, only the
    in-flight batch's gradient contribution).
    """

    def __init__(self, n_hosts: int, n_samples: int, *, technique="fac2",
                 speeds=None):
        from repro_torch.core.rma import ThreadWindow

        self.window = ThreadWindow()
        self.board = WeightBoard(
            n_hosts, initial_speeds=speeds if speeds is not None else None)
        self.n_hosts = n_hosts
        self.n_samples = n_samples
        self.technique = technique
        self.speeds = np.asarray(speeds if speeds is not None else np.ones(n_hosts))
        self.alive = np.ones(n_hosts, dtype=bool)
        self.claimed: list = [[] for _ in range(n_hosts)]

    def sampler(self, host_id: int, max_chunk: Optional[int] = None) -> DLSSampler:
        return DLSSampler(self.n_samples, self.n_hosts, host_id,
                          technique=self.technique, window=self.window,
                          weight_board=self.board, max_chunk=max_chunk)

    def kill(self, host_id: int):
        self.alive[host_id] = False
        self.board.mark_dead(host_id)

    def revive(self, host_id: int, rate: float = 1.0):
        self.alive[host_id] = True
        self.board.revive(host_id, rate)

    def run_epoch(self, batch_size: int, *, work_time=None,
                  kill_at: Optional[dict] = None):
        """All hosts drain one epoch; returns per-host sample counts.

        ``work_time(h)`` seconds of simulated compute per batch;
        ``kill_at={host: after_n_batches}`` schedules failures.

        Chunks are capped at 4x the batch size (LoopSpec.max_chunk) so a
        dying host strands at most that much claimed-but-unprocessed work.
        """
        import threading

        samplers = [self.sampler(h, max_chunk=4 * batch_size)
                    for h in range(self.n_hosts)]
        counts = np.zeros(self.n_hosts, dtype=np.int64)
        kill_at = kill_at or {}

        def host(h):
            n_batches = 0
            while self.alive[h]:
                t0 = time.perf_counter()
                idx = samplers[h].claim_batch(batch_size)
                if idx is None:
                    return
                if work_time is not None:
                    time.sleep(work_time(h))
                counts[h] += len(idx)
                self.claimed[h].append(idx)
                self.board.record(h, len(idx), time.perf_counter() - t0)
                n_batches += 1
                if kill_at.get(h) == n_batches:
                    self.kill(h)
                    return

        ts = [threading.Thread(target=host, args=(h,)) for h in range(self.n_hosts)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        return counts
