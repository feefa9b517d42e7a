"""The repo's TPU kernels as hand-written CUDA kernels for Hopper.

Port of ``repro.kernels``, all four of its kernel packages:

  mandelbrot      -- paper app 2: escape-time z<-z^4+c (variable-cost loop),
                     static grid and persistent self-scheduled grid
  spin_image      -- paper app 1: PSIA spin images, an exact cheap gate
                     before the full sequence, atomic histogram
  flash_attention -- fused attention (causal/SWA/GQA), static grid and
                     persistent self-scheduled grid over varlen batches
                     (windows, sinks, a v head dim of its own; a hybrid
                     stack of such layers)
  ssd_scan        -- the Mamba2 SSD chunked scan (state carried across
                     chunks), the SSM model's forward and prefill

and one with no counterpart there:

  moe_experts     -- the routed experts of an expert-parallel MoE layer,
                     dropless, as two self-scheduled loops a layer

Each entry point runs on the card unless given CPU tensors or
``device="cpu"``, where the kernel's plain PyTorch version runs.  The CUDA
sources are in ``repro_torch/csrc`` and are built at first use
(``_build``).
"""
from .flash_attention.ops import attention_oracle, flash_attention  # noqa: F401
from .flash_attention.persistent import (  # noqa: F401
    flash_attention_persistent, hybrid_attention_persistent)
from .mandelbrot.ops import mandelbrot, mandelbrot_ref  # noqa: F401
from .mandelbrot.persistent import mandelbrot_persistent  # noqa: F401
from .moe_experts.persistent import moe_experts_persistent  # noqa: F401
from .spin_image.ops import spin_images, spin_images_oracle  # noqa: F401
from .ssd_scan.ops import ssd_scan, ssd_scan_oracle  # noqa: F401
