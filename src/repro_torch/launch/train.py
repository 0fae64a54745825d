"""Training launcher, the counterpart of ``repro.launch.train``.

On the card:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m

On the CPU, at a reduced same-family size:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --tiny --device cpu --steps 30
"""

from __future__ import annotations

import argparse

from repro_torch.configs.base import get_config
from repro_torch.training.loop import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default=None, help="optional text file")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (cpu: plain path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, tiny=args.tiny)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params "
          f"(analytic), steps={args.steps} batch={args.batch} seq={args.seq}")
    out = train(cfg, steps=args.steps, batch_size=args.batch,
                seq_len=args.seq, lr=args.lr, seed=args.seed,
                data_path=args.data, ckpt_path=args.ckpt,
                ckpt_every=args.ckpt_every, device=args.device)
    print(f"done: {out['n_params']:,} params, final loss "
          f"{out['final_loss']:.4f}, wall {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
