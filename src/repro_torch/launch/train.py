"""Training driver (port of ``repro.launch.train``).

On the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt <dir>

On the CPU, add ``--device cpu``; without it the driver runs on
``"cuda"`` and raises where there is no card.  As the reference's, the
driver trains one host unsharded; ``Trainer(ctx=)`` runs the step over a
mesh.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--samples", type=int, default=100_000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--technique", default="fac2",
                    help="DLS technique for the data sampler")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda raises without a card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    tcfg = TrainConfig(
        steps=args.steps, per_host_batch=args.batch, seq_len=args.seq,
        n_samples=args.samples, n_hosts=args.hosts, host_id=args.host_id,
        technique=args.technique, microbatches=args.microbatches,
        remat=args.remat, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        seed=args.seed,
    )
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps)
    trainer = Trainer(cfg, tcfg, opt, device=args.device)
    name = (torch.cuda.get_device_name(trainer.device) if trainer.device.type == "cuda"
            else str(trainer.device))
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, on {name}")
    trainer.run()
    print(f"[train] done: final loss {trainer.history[-1]:.4f} "
          f"(first {trainer.history[0]:.4f})")


if __name__ == "__main__":
    main()
