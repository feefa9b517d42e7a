"""loopbench: time to drain a self-scheduled loop on the card.

The benchmark of the PyTorch/CUDA port (``repro_torch``).  ``run.py`` is the
command; ``harness.py`` says how a run goes and how everything is found by
name.  Nothing here imports JAX or the JAX package.
"""
