"""Training launcher of the PyTorch port:
``python -m repro_torch.launch.train --arch <id> [...]``.

By default it trains the REDUCED config (vocab capped at 512); ``--full``
takes the full config.  It runs on the card unless ``--device cpu`` is
given, and raises without one."""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import all_configs
from repro_torch.training.train_loop import TrainConfig, train


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(all_configs()))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not reduced) config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = all_configs()[args.arch]
    if not args.full:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, vocab_size=min(cfg.vocab_size, 512))
    tcfg = TrainConfig(steps=args.steps, batch=args.batch,
                       seq_len=args.seq_len, ckpt_dir=args.ckpt_dir)
    out = train(cfg, tcfg, device=args.device)
    print(f"final loss {out['losses'][-1][1]:.4f} "
          f"in {out['wall_s']:.1f}s")
    return out


if __name__ == "__main__":
    main()
