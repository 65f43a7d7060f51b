#!/usr/bin/env python3
"""The unplanned TinyLlama-1.1B step of two source trees, on one GPU.

  python3 tools/seg_step_compare.py --trees A,B [--order 0,1,1,0]
                                    [--alpha-dtypes ,int8] [--seed 0]

Each tree is a checkout of this repository (``A`` and ``B`` relative to the
root, e.g. ``.`` and a ``git archive`` of another commit unpacked under the
git-ignored ``build/``). For each entry of ``--order`` and each alpha
storage it starts a fresh process that puts that tree's ``src`` and root
first on ``sys.path``, builds its kernels and runs its own
``chip_smoke.mat_serve``: full-width TinyLlama-1.1B, bf16, 22 layers,
unplanned (``materialize``: every OVSF linear's W from the segmented
``ovsf_decompress`` kernel, then one product), paged packed, chunk 64, the
8 requests of ``chip_smoke.py``'s serve phases, eager and replayed, with
that script's gates. The replayed chunk-free step's wall, device busy,
idle share and the segmented kernel's device ms are printed per run, and
busy less the kernel's ms (the products that consume W and the rest of the
step) beside them, so that two kernels writing W in different layouts are
compared on what the layout costs downstream. Prints the card's name and
power limit; writes ``chiprun_out/seg_step_compare.json``. Exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tree: str, alpha_dtype: str, seed: int) -> int:
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("seg_step_compare: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(("ovsf_decompress", "paged_decode_attn"))
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    none = dict(step_ms=float("nan"), busy_ms=None, idle_share=None)
    run = cs.mat_serve(seed, card, dev, alpha_dtype, none)
    pm = run["decode_profile"]
    print("RESULT " + json.dumps(dict(
        step_ms=pm["step_ms"], busy_ms=pm["busy_ms"],
        idle_share=pm["idle_share"], replay_ms=run["replay_ms"],
        seg_ms=run["ovsf_decompress_ms"], layers=run["layers"])),
        flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", required=True)
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--alpha-dtypes", default=",int8")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", default="")
    ap.add_argument("--alpha-dtype", default="")
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.alpha_dtype, args.seed)
    trees = [os.path.abspath(os.path.join(ROOT, t))
             for t in args.trees.split(",")]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    runs = []
    for adt in args.alpha_dtypes.split(","):
        for k in map(int, args.order.split(",")):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--trees",
                 args.trees, "--child", trees[k], "--alpha-dtype", adt,
                 "--seed", str(args.seed)], capture_output=True, text=True,
                cwd=trees[k])
            res = [ln for ln in proc.stdout.splitlines()
                   if ln.startswith("RESULT ")]
            if proc.returncode or not res:
                print(proc.stdout[-4000:], proc.stderr[-4000:], flush=True)
                raise RuntimeError(f"tree {trees[k]} alpha {adt!r}: exit "
                                   f"{proc.returncode}")
            r = dict(json.loads(res[0][7:]), tree=args.trees.split(",")[k],
                     alpha_dtype=adt or "bf16")
            r["rest_ms"] = (r["busy_ms"] - r["seg_ms"]
                            if r["busy_ms"] is not None else None)
            runs.append(r)
            print(f"[step] tree {r['tree']} {r['alpha_dtype']} alphas, "
                  f"{r['layers']} layers: replayed chunk-free step wall "
                  f"{r['step_ms']:.3f} ms, replay {r['replay_ms']:.3f} ms, "
                  f"busy {r['busy_ms']} ms, idle {r['idle_share']}, "
                  f"segmented ovsf_decompress {r['seg_ms']:.3f} ms, busy "
                  f"less it {r['rest_ms']} ms", flush=True)
    for adt in args.alpha_dtypes.split(","):
        for t in args.trees.split(","):
            mine = [r for r in runs if r["tree"] == t
                    and r["alpha_dtype"] == (adt or "bf16")]
            print(f"[summary] tree {t} {adt or 'bf16'}: median of "
                  f"{len(mine)}: busy "
                  f"{statistics.median(r['busy_ms'] for r in mine):.3f} ms, "
                  f"kernel {statistics.median(r['seg_ms'] for r in mine):.3f}"
                  f" ms, busy less the kernel "
                  f"{statistics.median(r['rest_ms'] for r in mine):.3f} ms, "
                  f"replay "
                  f"{statistics.median(r['replay_ms'] for r in mine):.3f} ms",
                  flush=True)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "seg_step_compare.json"), "w") as f:
        json.dump(dict(card=card, runs=runs), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
