"""repro_torch.device -- the paper's protocol on the card.

Port of ``repro.device``.  The RMA window lives in device memory and the
claim loop runs inside a CUDA kernel:

  window.py         ``DeviceWindow``: the protocol counters in an int32
                    ``torch`` slab behind the ordinary ``Window`` contract
                    (tiers: ``atomics`` on CUDA, ``interpret`` on the CPU).
  chunk_calculus.py the closed forms as plain tensor code, index for index
                    equal to ``core.chunk_calculus`` (the kernel's copy is
                    ``csrc/chunk_calculus.cuh``).
  persistent.py     the protocol kernel: one launch walks Step 1-3 of the
                    paper against the slab and emits the full
                    (step, worker, start, size) schedule; behind it the
                    table kernels build the compute kernels' per-worker
                    claim tables on the card (``persistent_tables``).
  runtime.py        ``DeviceRuntime`` -- ``OneSidedRuntime`` over a
                    ``DeviceWindow`` (``dls.loop(runtime="device")``).
  executor.py       ``executor="device"``: run the protocol kernel, adopt
                    the final counters, replay the device-made schedule
                    into an ordinary ``SessionReport``.
"""
from .chunk_calculus import (  # noqa: F401
    DEVICE_TECHNIQUES,
    chunk_size_device,
    host_spec,
)
from .executor import execute_device  # noqa: F401
from .persistent import DeviceSchedule, claim_schedule, schedule_timeline  # noqa: F401
from .runtime import DEVICE_SPEC_TECHNIQUES, DeviceRuntime  # noqa: F401
from .window import DeviceWindow, slab_from_numpy, slab_to_numpy  # noqa: F401
