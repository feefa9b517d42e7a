"""Production mesh construction (port of ``repro.launch.mesh``).

The meshes are ``torch.distributed`` ``DeviceMesh``es with the
reference's shapes and axis names, built by ``init_device_mesh`` over the
process group that is up when they are called (NCCL over the cards, gloo
on the CPU, or the fake group of the dry run).  Nothing here touches
device or process-group state at import time.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The target deployment mesh.

    Single pod: 256 cards as (data=16, model=16).
    Multi-pod:  2 pods x 256 cards as (pod=2, data=16, model=16) -- the
    "pod" axis carries pure data parallelism (gradient all-reduce across
    pods), "data" is the in-pod FSDP/batch axis, "model" is TP/EP.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def scaled_mesh_dims(devices: int, *, multi_pod: bool = False):
    """(shape, axis names) of ``make_test_mesh(devices)``."""
    if multi_pod:
        if devices % 2 or devices < 4:
            raise ValueError(f"a multi-pod test mesh needs an even count >= 4, got {devices}")
        rest = devices // 2
        model = _largest_factor_leq(rest, int(rest ** 0.5))
        return (2, rest // model, model), ("pod", "data", "model")
    model = _largest_factor_leq(devices, int(devices ** 0.5))
    return (devices // model, model), ("data", "model")


def make_test_mesh(devices: int, *, multi_pod: bool = False, device_type: str = "cuda"):
    """Scaled-down mesh with the same axis structure (CI / unit tests)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = scaled_mesh_dims(devices, multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def _largest_factor_leq(n: int, k: int) -> int:
    for f in range(min(k, n), 0, -1):
        if n % f == 0:
            return f
    return 1


def make_device_hierarchy(global_window=None, capacity: int = 256, devices=None):
    """Two-level window over the process's cards (DESIGN.md Sec. 14).

    The hierarchy follows the mesh axis convention: the *global* level
    spans devices (super-chunk claims cross the interconnect, default a
    host ``ThreadWindow`` -- on a cluster pass the KV store), while each
    node-local level is a ``DeviceWindow`` whose counter slab lives in
    that device's own memory -- within a device, claims are the
    window kernel's atomic counter.  Feed the result to
    ``dls.loop(runtime="hierarchical", nodes=<n_devices>, window=...)``.

    ``devices`` defaults to every ``torch.cuda`` device, and raises where
    there is none; pass ``devices=["cpu"]`` for the window's plain
    version.
    """
    import torch

    from repro_torch.core.rma import HierarchicalWindow, ThreadWindow
    from repro_torch.device.window import DeviceWindow

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_device_hierarchy: no CUDA device "
                               "(torch.cuda.is_available() is false); pass devices=['cpu']")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    locals_ = [DeviceWindow(capacity=capacity, device=d) for d in devices]
    return HierarchicalWindow(
        len(locals_),
        global_window=global_window or ThreadWindow(),
        local_windows=locals_,
    )
