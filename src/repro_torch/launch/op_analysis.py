"""Per-device cost of one eager step: the counterpart of ``repro.launch.hlo_analysis``.

The reference parses the post-SPMD HLO text of a compiled step.  The port
has no HLO: it runs the step once, eagerly (in the dry run, on fake
tensors over a fake process group), and records what each rank executes
on its local shards.  One ``TorchDispatchMode`` (a ``CommDebugMode``,
which lets a ``DTensor`` operation desugar into its local operations and
collectives before it sees them) reads every local operation:

  * ``flops``          -- the operation's count from
                          ``torch.utils.flop_counter.FlopCounterMode``'s
                          formulas (matrix products and convolutions; the
                          reference counts ``dot`` ops only).  Eager
                          execution is trip-count-aware by nature: a layer
                          loop runs as many times as it runs, the backward
                          and the remat recompute included.
  * ``traffic_bytes``  -- each operation's input and output bytes, views
                          and aliases free.  Counted per operation, where
                          the reference counts fusion boundaries, so it
                          reads higher than the reference's.
  * ``collectives``    -- per-op inventory (count, ring-model bytes moved
                          per device), with the reference's ring model:
                          all-gather result x (g-1)/g, all-reduce
                          2 x result x (g-1)/g, reduce-scatter result x
                          (g-1), all-to-all result x (g-1)/g, anything
                          else its result.

``analyze_ops`` returns the keys of ``analyze_hlo``: ``flops``,
``traffic_bytes``, ``collectives`` ({op: {count, moved_bytes}}),
``collective_moved_bytes``, ``top_flops`` and ``top_traffic``, and
``peak_live_bytes``: the most bytes that the step's own allocations held
at once (a storage counts from the operation that makes it until it is
freed; the arguments' storages, named by ``external``, do not count).
Everything is *per device* (rank 0's shards).
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Callable, Iterable

import torch
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

#: functional collectives -> the reference's names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

#: operations that move no bytes of their own
_FREE = {"detach", "alias", "lift_fresh", "wait_tensor", "_unsafe_view", "empty",
         "empty_like", "empty_strided"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def ring_moved(op: str, result_bytes: float, group: int) -> float:
    """Bytes moved per device by one collective, the reference's ring model."""
    gf = (group - 1) / group if group > 1 else 1.0
    if op == "all-gather":
        return result_bytes * gf
    if op == "all-reduce":
        return 2.0 * result_bytes * gf
    if op == "reduce-scatter":
        return result_bytes * max(group - 1, 1)
    if op == "all-to-all":
        return result_bytes * gf
    return float(result_bytes)


def _group_size(name: str, args) -> int:
    """The collective's group size: its argument where it has one, else
    the size of the group it names."""
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    import torch.distributed as dist

    group_name = args[-1]
    return dist.distributed_c10d._resolve_process_group(group_name).size()


class OpCounter(CommDebugMode):
    """Counts flops, bytes and collectives of the local operations."""

    def __init__(self, external: Iterable[torch.Tensor] = ()):
        super().__init__()
        self._flop_registry = FlopCounterMode(display=False).flop_registry
        self._seen = {id(t.untyped_storage()) for t in external}
        self.live = self.peak = 0
        self.flops = 0.0
        self.traffic = 0.0
        self.flops_by = defaultdict(float)
        self.traffic_by = defaultdict(float)
        self.colls = defaultdict(lambda: {"count": 0.0, "moved_bytes": 0.0})
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.paused:  # a DTensor's global-shape metadata run: no rank's work
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:  # a DTensor op: its local ops come back here
            return out
        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        key = f"{func._overloadpacket._qualified_op_name.split('::')[0]}.{name}"
        fn = self._flop_registry.get(func._overloadpacket)
        if fn is not None:
            f = float(fn(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by[key] += f
        if name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            res = sum(_nbytes(t) for t in tree_leaves(out))
            c = self.colls[op]
            c["count"] += 1
            c["moved_bytes"] += ring_moved(op, res, _group_size(name, args))
        elif not (func.is_view or name in _FREE
                  or not any(isinstance(t, torch.Tensor) for t in tree_leaves(out))):
            b = float(sum(_nbytes(t) for t in tree_leaves((args, kwargs)))
                      + sum(_nbytes(t) for t in tree_leaves(out)))
            self.traffic += b
            self.traffic_by[key] += b
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._allocated(t.untyped_storage())
        return out

    def _allocated(self, st):
        if id(st) in self._seen:
            return
        self._seen.add(id(st))
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, id(st), n)

    def _freed(self, key, n):
        self._seen.discard(key)
        self.live -= n


@contextlib.contextmanager
def _paused_during_sharding_prop(counter: OpCounter):
    """``DTensor``'s sharding propagation runs each new operation once on
    global-shape fake tensors to learn its output's metadata (under the
    active fake mode, else a fake mode of its own); those runs are no
    rank's work, so the counter pauses through them."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def paused(self, *a, **k):
        counter.paused += 1
        try:
            return orig(self, *a, **k)
        finally:
            counter.paused -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = paused
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def analyze_ops(step: Callable, *args, external: Iterable[torch.Tensor] = (), **kwargs):
    """Run ``step(*args, **kwargs)`` once under ``OpCounter``: (its
    result, the ``analyze_hlo`` keys and ``peak_live_bytes``)."""
    c = OpCounter(external)
    with _paused_during_sharding_prop(c), c:
        result = step(*args, **kwargs)
    top = lambda d, n=12: sorted(d.items(), key=lambda kv: -kv[1])[:n]  # noqa: E731
    colls = {op: dict(v) for op, v in c.colls.items()}
    return result, {
        "flops": c.flops,
        "traffic_bytes": c.traffic,
        "collectives": colls,
        "collective_moved_bytes": sum(v["moved_bytes"] for v in colls.values()),
        "top_flops": top(c.flops_by),
        "top_traffic": top(c.traffic_by),
        "peak_live_bytes": c.peak,
    }
