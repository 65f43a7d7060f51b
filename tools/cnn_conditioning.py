#!/usr/bin/env python3
"""How well conditioned a random-init OVSF CNN's ``cnn_loss`` gradients
are: the relative L2 move of all its gradients (every float leaf at once)
under an image move of 1e-6, in train and eval mode, on the draws
``chip_smoke.cnn_train_phase`` makes (``chip_smoke.cnn_inputs``).

  PYTHONPATH=src python3 tools/cnn_conditioning.py --arch resnet18 \\
      --side 64 --batch 8 --seed 0 1 2 [--width 1.0] [--device cpu]

Every combination of ``--side``, ``--batch`` and ``--seed`` is one case
(matrix mode, fp32, unplanned: ``materialize``). A comparison of two
devices or packages can hold the gradients no tighter than this move: in
train mode BN divides by each channel's batch std, and a channel of large
mean and small std turns rounding into gradient. Prints a line a case,
with the three leaves that move most.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="resnet18")
    ap.add_argument("--side", type=int, nargs="+", default=[64])
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    for side, batch, seed in itertools.product(args.side, args.batch,
                                               args.seed):
        t0 = time.perf_counter()
        base, _cpu, (p, st), x, labels, noise = cs.cnn_inputs(
            args.arch, side, seed, dev, batch=batch, width=args.width)
        x, labels, noise = x.to(dev), labels.to(dev), noise.to(dev)
        moves = {}
        for mode in ("train", "eval"):
            train = mode == "train"
            _l, g, _s = cs.cnn_grads(p, st, base, x, labels, train)
            _l, g2, _s = cs.cnn_grads(p, st, base, x + noise, labels, train)
            moves[mode] = cs.grads_rel(g2, g)
            if train:
                worst = sorted(((cs.rel_l2(g2[k], g[k]), ".".join(k))
                                for k in g), reverse=True)[:3]
        print(f"{args.arch} width {args.width} side {side} batch {batch} "
              f"seed {seed} on {args.device}: an image move of 1e-6 moves "
              f"the gradients {moves['train']:.2e} in train mode, "
              f"{moves['eval']:.2e} in eval mode; most: "
              + ", ".join(f"{n} {e:.2e}" for e, n in worst)
              + f" ({time.perf_counter() - t0:.1f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
