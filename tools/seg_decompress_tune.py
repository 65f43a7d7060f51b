#!/usr/bin/env python3
"""The segmented ``ovsf_decompress`` kernel's grid and W's layout, on one GPU.

  python3 tools/seg_decompress_tune.py

Builds ``src/repro_torch/kernels/csrc/ovsf_decompress.cu`` once with
``-Xptxas -v`` (the segmented kernel's registers, spills and stack printed)
and loads that library in place of the wrapper's. Then, at TinyLlama-1.1B's
five W of a layer (L0 16, 8 kept a segment) in bf16, fp32, int8 and int4
alphas, and at OLMoE-1B-7B's three expert banks of a layer (64 experts,
bf16 and fp32), it checks the kernel against its plain version (fp32 and
quantised W bit for bit; bf16 W the fp32 sums rounded once) and times it by
CUDA-graph replay, inputs rotated past the 50 MB L2, under persistent grids
of 1, 2 and 4 blocks an SM (``ovsf_gemm.SEG_BLOCKS_PER_SM``) and under a
grid of one item a warp, beside its byte bound and ``torch.bmm`` of
prebuilt (n_seg, L0, n_keep) signs by the alphas. Last, the product that
consumes W (``x @ W.to(x.dtype)`` of ``kernels.ops.ovsf_matmul``) at the
five shapes, M 4 and 64, bf16 x, over W row-major (this kernel's layout)
and over the transposed view of a contiguous W^T (the layout of the
kernel before it), W bf16 and fp32 (int8 / int4 alphas' W). Prints the
card's name and power limit; writes
``chiprun_out/seg_decompress_tune.json``. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
L2_BYTES = 50 * 2**20
L0, KEEP = 16, 8
# TinyLlama-1.1B's five OVSF projections (d_in, d_out): q, o, gate, up, down
LAYER = ((2048, 2048), (2048, 2048), (2048, 5632), (2048, 5632),
         (5632, 2048))
# OLMoE-1B-7B's expert banks (E, d_in, d_out): gate, up, down
BANKS = ((64, 2048, 1024), (64, 2048, 1024), (64, 1024, 2048))
GRIDS = (1, 2, 4, 0)                # blocks an SM; 0: one item a warp


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def graph_ms(calls, iters: int) -> float:
    """Device ms a call: ``iters`` calls (cycling through ``calls``) in one
    CUDA graph, replayed between two events (warmed up eagerly first)."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            calls[i % len(calls)]()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / iters


def copies(bytes_per_call: float) -> int:
    return max(1, min(16, math.ceil(2.4 * L2_BYTES / max(bytes_per_call, 1))))


def build_verbose(out_dir: str) -> str:
    """The source built with ``-Xptxas -v``; returns the library's path,
    prints what ptxas says of the segmented kernel."""
    from repro_torch.kernels import build
    lib = os.path.join(out_dir, "libovsf_decompress_tune.so")
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
           str(build.CSRC / "ovsf_decompress.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode:
        raise RuntimeError(f"nvcc failed:\n{log.stdout}{log.stderr}")
    lines = (log.stdout + log.stderr).splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and "seg_kernel" in line:
            # <T, Q, LOG_L0, KMAX> from the mangled name, then the spills
            # and the registers
            args = re.search(r"seg_kernelI(.*?)EEvPKv", line)
            info = " ".join(s.strip() for s in lines[n + 1:n + 4])
            nums = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads|Used (\d+) "
                              r"registers", info)
            print("[ptxas] seg kernel", args.group(1) if args else "?",
                  "stack/spill st/spill ld/regs",
                  [x for t in nums for x in t if x], flush=True)
    build._LIBS["ovsf_decompress"] = ctypes.CDLL(lib)
    return lib


def case(rng, E: int, d_in: int, N: int, storage: str, dev):
    """(stored alphas, kwargs, idx, fp32 alphas): one id set, distinct ids
    a segment, E alpha sets (E = 0: a plain (J, N) matrix)."""
    from repro_torch.core.ovsf import quantize_alphas
    ns = d_in // L0
    idx = np.stack([np.sort(rng.choice(L0, KEEP, replace=False))
                    for _ in range(ns)]).astype(np.int32)
    shape = ((E,) if E else ()) + (ns * KEEP, N)
    al = torch.randn(shape, device=dev) / math.sqrt(KEEP)
    kw, stored = {}, al
    if storage == "bf16":
        stored = al.bfloat16()
    elif storage in ("int8", "int4"):
        stored, sc = quantize_alphas(al, ns, storage)
        kw = dict(alpha_scale=sc, alpha_dtype=storage)
    return stored, kw, torch.from_numpy(idx).to(dev), al


def kernel_row(rng, dev, E: int, d_in: int, N: int, storage: str) -> dict:
    from repro_torch.core.ovsf import dequantize_alphas, hadamard_matrix
    from repro_torch.kernels import ovsf_gemm as G
    a, kw, idx, _al = case(rng, E, d_in, N, storage, dev)
    ns = d_in // L0
    w_dt = torch.bfloat16 if storage == "bf16" else torch.float32
    want = G.ovsf_decompress_plain(a if storage != "bf16" else a.float(),
                                   idx, d_in, **kw).to(w_dt)
    w_bytes = (max(E, 1) * d_in * N * (2 if w_dt == torch.bfloat16 else 4))
    bytes_ = (a.numel() * a.element_size() + idx.numel() * 4
              + (ns * 4 if kw else 0) + w_bytes)
    bound = bytes_ / HBM_BYTES_PER_S * 1e3
    cps = [a.clone() for _ in range(copies(bytes_))]
    row = dict(E=E, d_in=d_in, N=N, storage=storage, bound_ms=bound)
    for per_sm in GRIDS:
        G.SEG_BLOCKS_PER_SM = per_sm or 10**6
        got = G.ovsf_decompress(a, idx, d_in, **kw)
        again = G.ovsf_decompress(a, idx, d_in, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)
                and got.is_contiguous()):
            err = float((got.float() - want.float()).abs().max())
            raise RuntimeError(f"E={E} {d_in}->{N} {storage} grid {per_sm}:"
                               f" max abs err {err:.3e} vs the plain version"
                               " (fp32 sums rounded once), or a second "
                               "launch differs")
        ms = graph_ms([lambda c=c: G.ovsf_decompress(c, idx, d_in, **kw)
                       for c in cps], 40)
        row[f"grid_{per_sm or 'items'}_ms"] = ms
    G.SEG_BLOCKS_PER_SM = 2
    St = hadamard_matrix(L0, w_dt, dev)[idx.long()].transpose(1, 2)
    lib_in = [(dequantize_alphas(c, kw["alpha_scale"], storage) if kw
               else c).reshape(-1, KEEP, N) for c in cps]
    St = St.repeat(max(E, 1), 1, 1).contiguous()
    row["bmm_ms"] = graph_ms([lambda b=b: torch.bmm(St, b) for b in lib_in],
                             40)
    print(f"[seg] E={E} {d_in}->{N} {storage}: "
          + ", ".join(f"{k[:-3]} {v:.4f}" for k, v in row.items()
                      if k.startswith("grid_"))
          + f" ms; bound {bound:.4f} ms (bytes); bmm {row['bmm_ms']:.4f} ms",
          flush=True)
    return row


# shapes off the main path, checked only: (d_in, N, L0, n_keep, repeated
# ids): ragged N (a byte at a time), L0 8 and 32, n_keep 5 and L0
RAGGED = ((1000, 77, 8, 5, False), (2048, 100, 32, 5, False),
          (512, 40, 16, 8, True), (256, 34, 32, 32, True))


def ragged_checks(rng, dev) -> int:
    """Each ``RAGGED`` shape in every storage (int4 on even N) and as a
    bank of 3: W equal to the plain version's (bf16: its fp32 sums rounded
    once); repeated ids within 2e-3 of it (the plain version's atomic
    scatter on the card sums them in any order)."""
    from repro_torch.core.ovsf import quantize_alphas
    from repro_torch.kernels import ovsf_gemm as G
    n = 0
    for d_in, N, l0, nk, repeat in RAGGED:
        ns = d_in // l0
        for st in ("fp32", "bf16", "int8", "int4", "bank"):
            if st == "int4" and N % 2:
                continue
            idx = np.stack([np.sort(rng.choice(l0, nk, replace=repeat))
                            for _ in range(ns)]).astype(np.int32)
            if repeat:
                idx[0, :2] = idx[0, 0]
            idx = torch.from_numpy(idx).to(dev)
            shape = ((3,) if st == "bank" else ()) + (ns * nk, N)
            al = torch.randn(shape, device=dev)
            a, kw = (al.bfloat16() if st == "bf16" else al), {}
            if st in ("int8", "int4"):
                a, sc = quantize_alphas(al, ns, st)
                kw = dict(alpha_scale=sc, alpha_dtype=st)
            got = G.ovsf_decompress(a, idx, d_in, **kw)
            want = G.ovsf_decompress_plain(
                a.float() if st == "bf16" else a, idx, d_in, **kw).to(
                got.dtype)
            torch.cuda.synchronize()
            tol = 2e-2 if st == "bf16" else 2e-3
            ok = (torch.allclose(got.float(), want.float(), tol, tol)
                  if repeat else torch.equal(got, want))
            if not ok or tuple(got.shape) != tuple(want.shape):
                raise RuntimeError(f"ragged {d_in}->{N} L0 {l0} n_keep {nk}"
                                   f" {st}: max abs err "
                                   f"{float((got.float() - want.float()).abs().max()):.3e}")
            n += 1
    print(f"[seg] {n} ragged cases equal to the plain version", flush=True)
    return n


def layout_row(dev, d_in: int, N: int, M: int, w_dt) -> dict:
    """x @ W.to(bf16) over W row-major and over W^T's transposed view."""
    x = [torch.randn((M, d_in), device=dev).bfloat16() for _ in range(4)]
    n = copies(d_in * N * 4)
    rows = [torch.randn((d_in, N), device=dev).to(w_dt) for _ in range(n)]
    views = [torch.randn((N, d_in), device=dev).to(w_dt).t()
             for _ in range(n)]
    out = {}
    for name, ws in (("row_major", rows), ("transposed_view", views)):
        out[name] = graph_ms([lambda i=i, w=w: x[i % 4] @ w.to(torch.bfloat16)
                              for i, w in enumerate(ws)], 40)
    print(f"[layout] x ({M}, {d_in}) @ W {d_in}->{N} {w_dt}: W row-major "
          f"{out['row_major']:.4f} ms, W^T's view "
          f"{out['transposed_view']:.4f} ms", flush=True)
    return dict(d_in=d_in, N=N, M=M, w_dtype=str(w_dt), **out)


def main() -> int:
    if not torch.cuda.is_available():
        print("seg_decompress_tune: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"[card] {card}", flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        build_verbose(tmp)
        rng = np.random.default_rng(0)
        ragged_checks(rng, dev)
        shapes = sorted(set(LAYER))
        rows = [kernel_row(rng, dev, 0, d_in, N, st) for d_in, N in shapes
                for st in ("bf16", "fp32", "int8", "int4")]
        banks = [kernel_row(rng, dev, E, d_in, N, st)
                 for E, d_in, N in sorted(set(BANKS))
                 for st in ("bf16", "fp32")]
    summary = {}
    for st in ("bf16", "fp32", "int8", "int4"):
        pick = {(r["d_in"], r["N"]): r for r in rows if r["storage"] == st}
        summary[st] = {k: sum(pick[s][k] for s in LAYER)
                       for k in pick[shapes[0]] if k.endswith("ms")}
    for st in ("bf16", "fp32"):
        pick = {(r["E"], r["d_in"], r["N"]): r for r in banks
                if r["storage"] == st}
        summary[f"bank {st}"] = {k: sum(pick[s][k] for s in BANKS)
                                 for k in pick[BANKS[0]] if k.endswith("ms")}
    for name, s in summary.items():
        print(f"[seg summary] {name}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in s.items()), flush=True)
    layouts = [layout_row(dev, d_in, N, M, w_dt) for d_in, N in shapes
               for M in (4, 64) for w_dt in (torch.bfloat16, torch.float32)]
    with open(os.path.join(out_dir, "seg_decompress_tune.json"), "w") as f:
        json.dump(dict(card=card, rows=rows, banks=banks, summary=summary,
                       layouts=layouts), f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
