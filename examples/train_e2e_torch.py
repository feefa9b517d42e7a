"""Port of ``examples/train_e2e.py`` to ``repro_torch``: the same presets,
flags and printed lines, and ``--device`` (default ``cuda``).

End-to-end training example: a ~100M-param LM, a few hundred steps, with
the full substrate engaged -- DLS-claimed data, AdamW, checkpointing +
auto-resume, AWF throughput feedback.

Presets (`small` is the identical code path at a size the CPU runs in
minutes; `100m` is the deliverable scale, for the card):

    PYTHONPATH=src python examples/train_e2e_torch.py --preset small --steps 200 --device cpu
    PYTHONPATH=src python examples/train_e2e_torch.py --preset 100m  --steps 300

Kill it mid-run and re-run: it resumes from the checkpoint, including the
DLS epoch state (the window counters ride in the checkpoint manifest).
The checkpoint layout is the reference's, so a checkpoint of either
package resumes in the other.
"""
import argparse
import os
import tempfile

from repro_torch.configs.base import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer

PRESETS = {
    # ~9M params: CPU-friendly, same code path
    "small": dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2,
                  d_ff=1024, vocab=4096, batch=8, seq=256),
    # ~113M params: the deliverable scale
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=3072, vocab=8192, batch=8, seq=512),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_e2e_ckpt"))
    ap.add_argument("--technique", default="fac2")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    p = PRESETS[args.preset]
    cfg = ModelConfig(
        name=f"e2e-{args.preset}", family="dense", n_layers=p["n_layers"],
        d_model=p["d_model"], n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"],
        d_ff=p["d_ff"], vocab=p["vocab"], dtype="float32")
    print(f"[e2e] {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    tcfg = TrainConfig(
        steps=args.steps, per_host_batch=p["batch"], seq_len=p["seq"],
        n_samples=50_000, technique=args.technique,
        ckpt_dir=args.ckpt, ckpt_every=25, log_every=10)
    trainer = Trainer(cfg, tcfg, AdamWConfig(lr=3e-4, total_steps=args.steps,
                                             warmup_steps=20), device=args.device)
    trainer.run()
    print(f"[e2e] loss {trainer.history[0]:.4f} -> {trainer.history[-1]:.4f} "
          f"over {len(trainer.history)} steps this run")
    return trainer


if __name__ == "__main__":
    main()
