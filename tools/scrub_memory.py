#!/usr/bin/env python3
"""``chip_smoke.py`` phase 9's flip + scrub memory gate alone, on one GPU,
under a chosen repair order (ROADMAP C.1).

  python3 tools/scrub_memory.py [--orders group,member,group-nogc]

For each order a fresh registry of the full-width fp32 TinyLlama-1.1B pair
serves under 4 flip + scrub repairs (``chip_smoke.gateway_memory_gate``),
which prints ``memory_reserved`` split by pool after every repair and holds
it, and the live bytes, within 2 MiB of the first repair's. Orders:

* ``group``: ``ModelRegistry.repair_group`` as it is: every member of the
  group dropped, reference cycles collected, the cache emptied, then each
  member reloaded in registration order;
* ``member``: each member dropped and reloaded in turn, beside the other
  member's live copy (the order before C.1 was closed);
* ``group-nogc``: ``group`` without collecting reference cycles before the
  reload.

Each order's result (or the gate's failure) goes to
``chiprun_out/scrub_memory.json``; the script exits 1 if the ``group``
order fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def member_order(self, group: str) -> list:
    done = []
    for n in self.group_members(group):
        if self.entries[n].resident:
            self.repair(n)
            done.append(n)
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--orders", default="group,member,group-nogc")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scrub_memory: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.serving import model_registry as mr
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = cs.card_line()
    print(f"[card] {card} | torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f}s", flush=True)
    group, gc_mod = mr.ModelRegistry.repair_group, mr.gc
    out, ok = {}, True
    for order in args.orders.split(","):
        mr.ModelRegistry.repair_group = (member_order if order == "member"
                                         else group)
        mr.gc = (types.SimpleNamespace(collect=lambda: 0)
                 if order == "group-nogc" else gc_mod)
        reg = cs.gateway_registry(0, dev, "float32", cs.GATEWAY_MODELS[:2],
                                  cs.QWEN_LAYERS)
        try:
            out[order] = cs.gateway_memory_gate(reg, 0, dev, card)
            print(f"[scrub memory] order {order}: passed", flush=True)
        except RuntimeError as exc:
            out[order] = dict(failed=str(exc))
            ok = ok and order != "group"
            print(f"[scrub memory] order {order}: FAILED: {exc}", flush=True)
        del reg
        torch.cuda.empty_cache()
    mr.ModelRegistry.repair_group, mr.gc = group, gc_mod
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "scrub_memory.json"),
              "w") as f:
        json.dump(dict(card=card, orders=out), f, indent=1, default=str)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
