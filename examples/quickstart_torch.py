"""Port of ``examples/quickstart.py`` to ``repro_torch``: the same printed
lines and asserts, and ``--device`` (default ``cuda``) for part 3.

Quickstart: the paper's protocol in 60 lines.

1. Chunk calculus: closed forms (Eq. 1-3) == Table-2 recurrences.
2. Distributed claiming: 8 threads self-schedule a loop via two atomic
   fetch-adds each (the One_Sided protocol), no master.
3. The framework plane: a tiny LM trained with a DLS-claimed data pipeline,
   on the card (``--device cpu`` for the CPU; without a card the trainer
   raises, it never falls back).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import dls
from repro_torch.core import LoopSpec, chunk_series_recurrence, plan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -- 1. chunk calculus --------------------------------------------------
    spec = LoopSpec("gss", N=10, P=2)
    sizes, starts = plan(spec)
    print(f"GSS N=10 P=2 (paper Sec.3 example): sizes={list(sizes)} starts={list(starts)}")
    assert list(sizes[:2]) == [5, 3]  # K_0=5, K_1=3, as in the paper

    spec = LoopSpec("fac2", N=100_000, P=16)
    print(f"FAC2 closed-form steps: {len(plan(spec)[0])}, "
          f"recurrence steps: {len(chunk_series_recurrence(spec))}")

    # -- 2. one-sided distributed claiming ----------------------------------
    N = 50_000
    executed = np.zeros(N, np.int32)
    with dls.loop(N, technique="fac2", P=8) as session:
        report = session.execute(
            lambda a, b: executed.__setitem__(slice(a, b), executed[a:b] + 1),
            executor="threads")
    assert (executed == 1).all(), "not a partition!"
    print(f"one-sided threads: {report.steps} claims partition [0,{N}) exactly "
          f"once (cov={report.cov:.2f})")

    # -- 3. train a tiny LM with the DLS data plane --------------------------
    from repro_torch.configs.base import ModelConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = ModelConfig(name="quickstart", family="dense", n_layers=2, d_model=64,
                      n_heads=2, n_kv_heads=2, d_ff=128, vocab=128, dtype="float32")
    trainer = Trainer(cfg, TrainConfig(steps=20, per_host_batch=4, seq_len=32,
                                       n_samples=1_000, technique="fac2",
                                       log_every=5), device=args.device)
    trainer.run()
    print(f"loss: {trainer.history[0]:.3f} -> {trainer.history[-1]:.3f}")
    print("quickstart OK")


if __name__ == "__main__":
    main()
