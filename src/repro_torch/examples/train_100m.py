"""End-to-end training example: a ~100M-parameter llama-family model trained
for a few hundred steps on the synthetic Markov-Zipf corpus, with AdamW,
checkpointing, and live loss logging; the counterpart of the reference's
``examples/train_100m.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_100m [--steps 300] \\
        [--quick] [--device cpu]
"""

import argparse

from repro_torch.configs.base import get_config
from repro_torch.training.loop import train


def config_100m():
    """SmolLM-family scaled to ~100M params (12L, d=640, 32k vocab)."""
    return get_config("smollm-360m").replace(
        name="smollm-100m",
        num_layers=12,
        d_model=640,
        num_heads=10,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=32768,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--quick", action="store_true",
                    help="tiny config + 40 steps (CI-speed)")
    ap.add_argument("--ckpt", default="experiments/train100m_ckpt.npz")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (cpu: plain path)")
    args = ap.parse_args(argv)

    if args.quick:
        cfg = get_config("smollm-360m", tiny=True)
        args.steps = min(args.steps, 40)
    else:
        cfg = config_100m()
    print(f"config {cfg.name}: ~{cfg.param_count() / 1e6:.0f}M params "
          f"(analytic); {args.steps} steps, batch {args.batch}, seq {args.seq}")
    out = train(cfg, steps=args.steps, batch_size=args.batch,
                seq_len=args.seq, lr=args.lr, log_every=10,
                ckpt_path=args.ckpt, ckpt_every=max(args.steps // 3, 1),
                device=args.device)
    print(f"\nfinal: {out['n_params']:,} params | loss "
          f"{out['losses'][0]:.3f} -> {out['final_loss']:.3f} | "
          f"{out['wall_s']:.0f}s wall | checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
