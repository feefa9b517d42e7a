"""Self-scheduled data pipeline: hosts claim sample-index chunks via the
paper's one-sided protocol instead of a fixed striped split.

Port of ``repro.data.pipeline``, on ``repro_torch.dls``: numpy only, and
its tokens, claims and ``EpochState``s equal the reference's byte for
byte.  The epoch's ``loop_id`` is Python's ``hash`` of ("epoch", epoch),
salted per process as the reference's is.

Why this matters at 1000+-node scale: with a *static* split (host h gets
indices h::H), one slow or restarted host stalls the whole data-parallel
step.  With DLS claiming, hosts pull variable-size chunks of the global
index space through two atomic fetch-adds (a one-sided ``repro_torch.dls``
session); slow hosts
simply claim less, dead hosts claim nothing, and restarted hosts resume from
the *current* loop pointer -- the window counters (i, lp_start) are part of
the checkpoint, so a restart continues the epoch exactly where it stopped.

AWF weights (from per-host step timings) make the chunk sizes adapt to
measured throughput: the paper's WF with live weights = its cited AWF
future-work direction, used here as straggler mitigation.

Data itself is synthetic-deterministic: token content is a pure function of
(seed, global_index), so any host can materialize any sample -- which is
what makes work-stealing across hosts free.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch import dls
from repro_torch.core import ThreadWindow, Window
from repro_torch.core.weights import WeightBoard


def synth_tokens(seed: int, global_idx: np.ndarray, seq_len: int, vocab: int):
    """Deterministic per-sample token content: counter-based RNG per index."""
    out = np.empty((len(global_idx), seq_len), dtype=np.int32)
    for row, gi in enumerate(np.asarray(global_idx)):
        rng = np.random.default_rng(np.uint64(seed) * np.uint64(1_000_003) + np.uint64(gi))
        out[row] = rng.integers(0, vocab, size=seq_len, dtype=np.int32)
    return out


@dataclasses.dataclass
class EpochState:
    epoch: int
    next_step_i: int  # window counter i (for checkpoint/restore)
    next_lp: int  # window counter lp_start
    # claimed-but-unconsumed index ranges [(start, stop), ...] -- part of the
    # checkpoint so a restart re-serves exactly the un-trained samples
    leftover: list = dataclasses.field(default_factory=list)


class DLSSampler:
    """Per-host sampler that claims chunks of [0, n_samples) via DLS.

    One instance per host process.  ``claim_batch(batch_size)`` returns
    ``batch_size`` global indices, carrying leftovers between calls; returns
    None when the epoch is exhausted (the host should then enter the
    end-of-epoch barrier).
    """

    def __init__(
        self,
        n_samples: int,
        n_hosts: int,
        host_id: int,
        *,
        technique: str = "fac2",
        window: Optional[Window] = None,
        weight_board: Optional[WeightBoard] = None,
        epoch: int = 0,
        min_chunk: int = 1,
        max_chunk: Optional[int] = None,
    ):
        self.n_samples = n_samples
        self.n_hosts = n_hosts
        self.host_id = host_id
        self.technique = technique
        self.window = window if window is not None else ThreadWindow()
        self.board = weight_board
        self.min_chunk = min_chunk
        self.max_chunk = max_chunk
        self._lock = threading.Lock()
        # claimed-but-unconsumed ranges [(start, stop), ...] FIFO
        self._ranges: list = []
        self._buffered = 0
        self._epoch = epoch
        self._new_epoch_session()

    def _new_epoch_session(self):
        # namespace by epoch so monotonic KV windows work across epochs
        # (the weight board only acts for the weighted family -- don't
        # attach a no-op policy, and don't warn, for unweighted techniques;
        # adaptive techniques with no board auto-adopt their telemetry
        # policy inside dls.loop)
        board = self.board if self.technique in dls.WEIGHTED else None
        self.session = dls.loop(
            self.n_samples, technique=self.technique, P=self.n_hosts,
            window=self.window, min_chunk=self.min_chunk,
            max_chunk=self.max_chunk, weights=board,
            loop_id=hash(("epoch", self._epoch)) & 0x7FFFFFFF)

    @property
    def epoch(self) -> int:
        return self._epoch

    def next_epoch(self):
        with self._lock:
            self._epoch += 1
            self._ranges = []
            self._buffered = 0
            self._new_epoch_session()

    def claim_batch(self, batch_size: int) -> Optional[np.ndarray]:
        """Claim until ``batch_size`` indices are buffered; None = exhausted."""
        with self._lock:
            while self._buffered < batch_size:
                c = self.session.claim(self.host_id)
                if c is None:
                    return None  # epoch drained (leftovers < batch: dropped)
                self._ranges.append((c.start, c.stop))
                self._buffered += c.size
            out = []
            need = batch_size
            while need:
                s, e = self._ranges[0]
                take = min(need, e - s)
                out.append(np.arange(s, s + take, dtype=np.int64))
                if take == e - s:
                    self._ranges.pop(0)
                else:
                    self._ranges[0] = (s + take, e)
                need -= take
                self._buffered -= take
            return np.concatenate(out)

    # ---- checkpointable state ----
    def state(self) -> EpochState:
        with self._lock:
            counters = self.session.state()
            return EpochState(
                epoch=self._epoch,
                next_step_i=counters["i"],
                next_lp=counters["lp"],
                leftover=[list(r) for r in self._ranges],
            )

    def restore(self, st: EpochState):
        with self._lock:
            self._epoch = st.epoch
            self._ranges = [tuple(r) for r in st.leftover]
            self._buffered = sum(e - s for s, e in self._ranges)
            self._new_epoch_session()
            self.session.restore({"i": st.next_step_i, "lp": st.next_lp})


class HostDataIterator:
    """Batches for one host: DLS-claimed indices -> synthetic token arrays."""

    def __init__(self, sampler: DLSSampler, *, seq_len: int, vocab: int,
                 per_host_batch: int, seed: int = 0, epochs: Optional[int] = None):
        self.sampler = sampler
        self.seq_len = seq_len
        self.vocab = vocab
        self.per_host_batch = per_host_batch
        self.seed = seed
        self.epochs = epochs

    def __iter__(self) -> Iterator[dict]:
        done_epochs = 0
        while self.epochs is None or done_epochs < self.epochs:
            idx = self.sampler.claim_batch(self.per_host_batch)
            if idx is None:
                done_epochs += 1
                self.sampler.next_epoch()
                continue
            toks = synth_tokens(self.seed + self.sampler.epoch, idx, self.seq_len,
                                self.vocab)
            yield {"tokens": toks, "indices": idx}
