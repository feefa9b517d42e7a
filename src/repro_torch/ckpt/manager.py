"""Fault-tolerant checkpointing: async, atomic, keep-N, auto-resume.

Port of ``repro.ckpt.manager``, with the reference's layout (one directory
per step):

    <root>/step_000123/
        manifest.json          tree structure + dtypes/shapes + extra state
        arrays_h<host>.npz     flat param/opt arrays, leaf i under key "i"
    <root>/LATEST              text file: "step_000123"  (atomic rename)

Writes happen on a background thread against ``step_xxx.tmp<host>`` and
are published by a single atomic rename + LATEST update, so a killed
process can never leave a half-written checkpoint as "latest". The DLS
window counters (the data pipeline's epoch state) ride along in the
manifest.

Trees are the port's dicts and lists of tensors, flattened in
``jax.tree_util``'s order (``repro_torch.tree``), and the manifest names
dtypes as numpy does (``"float32"``, ``"bfloat16"``): a tree of dicts
written by either package is restored by the other.  bf16 leaves go to
disk as their raw ``uint16`` bits and come back by a view, with no
``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a snapshot: later in-place updates of ``t``
    do not reach it); bf16 as its raw uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if a.dtype.kind == "u" and dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


class CheckpointManager:
    def __init__(self, root: str, *, keep_n: int = 3, host_id: int = 0,
                 async_save: bool = True):
        self.root = root
        self.keep_n = keep_n
        self.host_id = host_id
        os.makedirs(root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._async = async_save
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             block: bool = False):
        """Snapshot ``tree`` (a tree of dicts and lists of tensors) at
        ``step``.

        Leaves are copied to the host *synchronously* (a consistent
        snapshot); the file I/O happens on the writer thread.
        """
        if self._err is not None:
            raise RuntimeError("previous async save failed") from self._err
        leaves = T.leaves(tree)
        host = [_to_host(t) for t in leaves]
        entries = [{"shape": list(t.shape), "dtype": _dtype_name(t.dtype)} for t in leaves]
        payload = (step, host, f"PyTreeDef({T.structure(tree)})", entries, extra or {})
        if self._async:
            # all writes go through the single worker thread (no concurrent
            # _write: LATEST.tmp and GC are not multi-writer safe)
            self._q.put(payload)
            if block:
                self.wait()
        else:
            self._write(*payload)

    def wait(self):
        """Block until all queued saves are on disk."""
        self._q.join()
        if self._err is not None:
            raise RuntimeError("async save failed") from self._err

    def _worker(self):
        while True:
            payload = self._q.get()
            try:
                self._write(*payload)
            except BaseException as e:  # surfaced on next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _write(self, step, leaves, treedef, manifest_entries, extra):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.root, name + f".tmp{self.host_id}")
        final = os.path.join(self.root, name)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"arrays_h{self.host_id}.npz"),
                 **{str(i): a for i, a in enumerate(leaves)})
        manifest = {
            "step": step,
            "treedef": treedef,
            "leaves": manifest_entries,
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        # atomic publish
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(os.path.join(self.root, "LATEST.tmp"), "w") as f:
            f.write(name)
        os.replace(os.path.join(self.root, "LATEST.tmp"),
                   os.path.join(self.root, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.root) if d.startswith("step_")
                       and not d.endswith(".tmp%d" % self.host_id))
        for d in steps[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.root, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.root, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, like_tree: Any, step: Optional[int] = None):
        """Returns (tree, extra) with tensors shaped like ``like_tree``'s
        leaves, in their dtypes and on their devices.

        ``like_tree`` provides the structure (and sanity-checks shapes);
        pass e.g. the freshly-initialized params.
        """
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = os.path.join(self.root, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_ref = T.leaves(like_tree)
        leaves = []
        with np.load(os.path.join(d, f"arrays_h{self.host_id}.npz")) as z:
            for i, ref in enumerate(leaves_ref):
                t = _from_host(z[str(i)], manifest["leaves"][i]["dtype"])
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"checkpoint leaf {i} shape {tuple(t.shape)} != expected "
                        f"{tuple(ref.shape)}")
                leaves.append(t.to(device=ref.device, dtype=ref.dtype))
        return T.unflatten(like_tree, leaves), manifest["extra"]
