"""Serving engine: batched prefill/decode + DLS continuous batching.

Port of ``repro.serve.engine``.  The paper's self-scheduling maps onto
inference serving directly: requests are the loop iterations (highly
variable cost -- prompt and generation lengths vary by orders of
magnitude), decode "workers" are batch slots, and the shared work queue is
claimed through the same one-sided protocol (a ``repro_torch.dls``
session) -- no scheduler master thread serializing admissions.

``ContinuousBatcher`` keeps a fixed-size decode batch full: whenever a slot
finishes (EOS / max_len), it claims the next chunk of requests from the
queue.  GSS chunking admits large request groups early (deep queue) and
small ones late (tail latency), which is the decreasing-chunk insight of
the paper applied to admission control.

``Engine.generate`` serves every family of the catalog: dense (SWA
included), moe, ssm, hybrid, vlm and enc-dec, whose source is the
frontend stub's embeddings (``api.frontend_stub_embeds``), as in the
reference.

Differences from the reference: ``Engine`` takes ``backend=`` ("xla" by
default, the reference's behaviour) and passes it to ``prefill`` and
``decode_step``, so a server on the card can run the prefill through the
SSD scan kernel (``backend="pallas"``; a cached attention call takes the
dense path whatever the backend).  It drops the reference's ``max_len``
and ``batch_size``, which nothing reads (the cache is sized from the
prompt and ``max_new``).  ``ctx`` is the reference's sharding context:
under a mesh the params are ``DTensor``s, the engine places its cache by
``cache_pspecs`` and gathers each step's logits to pick the next tokens.
``ContinuousBatcher`` is the reference's, ``technique="auto"`` and
``auto_seed`` included.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import dls
from repro_torch.models import api
from repro_torch.shard import NO_SHARD, ShardCtx, cache_pspecs, distribute
from repro_torch.shard.spec import on_mesh


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (Tp,) int32
    max_new: int = 32
    # filled by the engine:
    output: Optional[list] = None
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    """Single-model batched engine (greedy decoding), on the params' device."""

    def __init__(self, cfg, params, *, backend="xla", ctx: ShardCtx = NO_SHARD):
        self.cfg = cfg
        self.params = params
        self.backend = backend
        self.ctx = ctx

    def _next(self, logits):
        if on_mesh(self.ctx):
            logits = logits.full_tensor()
        return logits.argmax(-1).int()

    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """prompts (B, Tp) -> tokens (B, max_new), greedy."""
        B, Tp = prompts.shape
        device = self.params["embed"].device
        cache = api.init_cache(self.cfg, B, Tp + max_new,
                               src_len=Tp if self.cfg.is_encdec else None,
                               device=device)
        if on_mesh(self.ctx):
            mesh = self.ctx.mesh
            cache = distribute(cache, cache_pspecs(cache, mesh,
                                                   kv_heads=self.cfg.n_kv_heads or None), mesh)
        batch = {"tokens": prompts}
        if self.cfg.is_encdec:
            batch["src_embeds"] = api.frontend_stub_embeds(self.cfg, B, Tp,
                                                           device=device)
        logits, cache = api.prefill(self.params, self.cfg, batch, cache,
                                    ctx=self.ctx, backend=self.backend)
        out = []
        tok = self._next(logits)
        for _ in range(max_new):
            out.append(tok)
            logits, cache = api.decode_step(self.params, self.cfg, tok, cache,
                                            ctx=self.ctx, backend=self.backend)
            tok = self._next(logits)
        return torch.stack(out, dim=1).cpu().numpy()


class ContinuousBatcher:
    """DLS admission control over a request queue (simulation-friendly).

    ``schedule(requests)`` processes the queue with ``n_workers`` decode
    groups; each group claims its next chunk of requests through the
    one-sided protocol.  Per-request cost = prefill + new tokens (supplied by
    ``cost_model`` or real engine calls).  Returns per-request latencies.

    ``technique="auto"`` runs the ``repro_torch.replay`` selection sweep
    per queue: each request's ``max_new`` (when present) becomes the
    per-iteration cost hint, so admission control picks the technique the
    calibrated DES predicts fastest for *this* queue shape.  The decision
    lands in ``last_report.auto_decision``.
    """

    def __init__(self, n_workers: int = 4, technique: str = "gss",
                 min_chunk: int = 1, auto_seed: int = 0):
        self.n_workers = n_workers
        self.technique = technique
        self.min_chunk = min_chunk
        self.auto_seed = auto_seed
        self.last_report: Optional[dls.SessionReport] = None  # of last schedule()

    def schedule(
        self,
        requests: List[Request],
        process: Callable[[List[Request], int], float],
        *,
        static: bool = False,
    ) -> np.ndarray:
        """Simulated clock schedule; ``process(chunk, worker)`` -> seconds.

        static=True replays the STATIC baseline (fixed equal split).
        """
        N = len(requests)
        technique = "static" if static else self.technique
        auto_kw = {}
        if technique == "auto":
            # Selection hint: generation length dominates per-request cost.
            if requests and hasattr(requests[0], "max_new"):
                auto_kw["costs"] = np.array(
                    [float(r.max_new) for r in requests])
            auto_kw["auto_seed"] = self.auto_seed
        session = dls.loop(N, technique=technique, P=self.n_workers,
                           min_chunk=self.min_chunk, **auto_kw)
        t_worker = np.zeros(self.n_workers)
        done_at = np.zeros(N)
        while not session.drained():
            w = int(np.argmin(t_worker))
            c = session.claim(w)
            if c is None:
                # drained() is authoritative under the Runtime contract --
                # no probe claims that burn scheduling steps per worker.
                break
            chunk = requests[c.start: c.stop]
            t_start = float(t_worker[w])
            dt = process(chunk, w)
            t_worker[w] += dt
            session.record(w, c.size, dt, claim=c, t_start=t_start,
                           t_end=t_start + dt)
            done_at[c.start: c.stop] = t_worker[w]
            for r in chunk:
                # Closed-loop queue: every request is present at t=0.
                # TTFT = the chunk's first token (its execution start),
                # not chunk completion; the group finishes together.
                r.t_submit = 0.0
                r.t_first = t_start
                r.t_done = t_start + dt
        self.last_report = session.report(executor="admission")
        return done_at
