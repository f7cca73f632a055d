"""End-to-end training on the PyTorch port: train a small decoder
on the synthetic bigram-structured stream for a few hundred steps, verify
the loss drops well below the uniform baseline, and round-trip a
checkpoint.

Run:  PYTHONPATH=src python examples/torch_train_small.py [--steps 200]
      [--device cpu]
(the card by default; without one it raises unless ``--device cpu``).
"""
import argparse
import dataclasses
import math
import tempfile

import torch

from repro_torch.configs import all_configs
from repro_torch.device import resolve_device
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.train_loop import TrainConfig, train
from repro_torch.tree import leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        all_configs()[args.arch].reduced(),
        vocab_size=64, num_layers=2, d_model=128, d_ff=256,
        name=args.arch + "-train-demo")
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(steps=args.steps, batch=8, seq_len=64,
                           ckpt_dir=tmp, log_every=max(args.steps // 10, 1))
        out = train(cfg, tcfg, device=dev)
        first, last = out["losses"][0][1], out["losses"][-1][1]
        uniform = math.log(cfg.padded_vocab)
        print(f"\nloss: {first:.3f} -> {last:.3f} "
              f"(uniform over padded vocab = {uniform:.3f})")
        assert last < first - 0.5, "training did not learn"

        # checkpoint round-trip
        step, restored = ckpt.restore(
            tmp, {"params": out["params"], "opt_state": out["opt_state"]})
        for a, b in zip(leaves(out["params"]), leaves(restored["params"]),
                        strict=True):
            assert torch.equal(a, b)
        print(f"checkpoint at step {step} restored bit-exact: OK")


if __name__ == "__main__":
    main()
