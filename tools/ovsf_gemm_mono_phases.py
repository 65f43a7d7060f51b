#!/usr/bin/env python3
"""Where the monolithic tensor-core ``ovsf_gemm`` spends its time, on one GPU.

  python3 tools/ovsf_gemm_mono_phases.py

Builds variants of ``src/repro_torch/kernels/csrc/ovsf_gemm.cu`` by text
substitution (each into its own library under the git-ignored
``src/repro_torch/kernels/_build/variants/``) and, at the six CNN conv shapes
(ResNet-50 s1 / s2 / s3, SqueezeNet-1.1 fires 2-3 / 4-5 / 6-7; M, K -> N at
batch 8, J = L / 2 distinct code ids, fp32), times each by CUDA-graph replay
beside ``torch.matmul`` on the dense W:

* ``base``: the source as it is, under the wrapper's plan (``mono_plan``:
  clusters of two sharing a stripe's generation), and with clusters of one
  and of four (30 clusters: what the card holds at these shared-memory
  sizes), the cluster size being a launch argument;
* ``narrow off``: the narrow-stripe branch (three accumulators for a stripe
  of at most 16 columns) disabled, the plan's clusters;
* ``timed``: ``%globaltimer`` read by thread 0 of every block at the phase
  boundaries (stash, generation batches, zero rows and the cluster copy,
  product), y's stores disabled so the block's four numbers land in y; the
  mean and max over blocks are printed.

Every variant's output of ``base`` is checked against the plain version
(fp32 tolerance 2e-3). Prints the card's name and power limit; writes
``chiprun_out/ovsf_gemm_mono_phases.json``. Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("s1", 6272, 1152, 128), ("s2", 1568, 2304, 256),
          ("s3", 392, 4608, 512), ("f2-3", 6272, 288, 128),
          ("f4-5", 1568, 432, 192), ("f6-7", 1568, 576, 256))
GT = ("__device__ __forceinline__ unsigned long long gtime() {\n"
      "  unsigned long long v;\n"
      "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(v));\n"
      "  return v;\n}\n")


def sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"marker not found once: {old[:60]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    narrow = sub(sub(src, "        if (nt_n <= 2) {\n          // a narrow "
                     "stripe", "        if (false) {\n          // a narrow "
                     "stripe"), "    if (nt_n <= 2) {          // (hi . hi +",
                 "    if (false) {          // (hi . hi +")
    t = sub(src, "template <int LOG_L>\n__global__ void __launch_bounds__"
            "(THREADS, 1)", GT + "template <int LOG_L>\n__global__ void "
            "__launch_bounds__(THREADS, 1)")
    t = sub(t, "  const int t = threadIdx.x;\n  const int stripes",
            "  const int t = threadIdx.x;\n  unsigned long long T0 = gtime(),"
            " T1 = 0, T2 = 0, T3 = 0;\n  const int stripes")
    t = sub(t, "  // 2. The stripe, BATCH columns at a time",
            "  __syncthreads();\n  T1 = gtime();\n  // 2. The stripe, BATCH "
            "columns at a time")
    t = sub(t, "  // rows K..Kp of the stripe are zero",
            "  __syncthreads();\n  T2 = gtime();\n  // rows K..Kp of the "
            "stripe are zero")
    t = sub(t, "  // 3. The product:", "  T3 = gtime();\n  // 3. The product:")
    t = sub(t, "  if (cluster > 1) cluster_wait();   // no block leaves while "
            "a peer reads it\n}",
            "  __syncthreads();\n  const unsigned long long T4 = gtime();\n"
            "  if (cluster > 1) cluster_wait();\n  if (t == 0) {\n"
            "    float* o = out + blockIdx.x * 4;\n    o[0] = T1 - T0; "
            "o[1] = T2 - T1; o[2] = T3 - T2; o[3] = T4 - T3;\n  }\n}")
    t = sub(t, "          *reinterpret_cast<float2*>(yr + col) = "
            "make_float2(a, b2);", "          if (a == 1234.5f) *reinterpret"
            "_cast<float2*>(yr + col) = make_float2(a, b2);")
    return {"base": src, "narrow off": narrow, "timed": t}


def build_all(texts: dict, G, build) -> dict:
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu = os.path.join(out_dir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"v{i}.so")
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        fn = ctypes.CDLL(so).ovsf_gemm_mono_launch
        fn.argtypes = G._MONO_ARGTYPES
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def graph_us(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("ovsf_gemm_mono_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import ovsf_gemm as G
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with open(os.path.join(build.CSRC, "ovsf_gemm.cu")) as f:
        src = f.read()
    t0 = time.perf_counter()
    libs = build_all(variants(src), G, build)
    print(f"built {list(libs)} in {time.perf_counter() - t0:.0f}s",
          flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, M, K, N in SHAPES:
        L = 1 << (K - 1).bit_length()
        J = L // 2
        idx = torch.from_numpy(np.sort(rng.choice(L, J, replace=False))
                               .astype(np.int32)).to(dev)
        x = torch.randn(M, K, device=dev)
        al = torch.randn(J, N, device=dev) / math.sqrt(J)
        out = torch.empty(M, N, device=dev)
        plan = G.mono_plan(M, K, N, J, n_sms)
        want = G.ovsf_gemm_plain(x, al, idx)
        row = dict(shape=name, M=M, K=K, N=N, J=J, plan=plan)

        def launcher(fn, cluster, blocks):
            return lambda: fn(
                x.data_ptr(), al.data_ptr(), idx.data_ptr(), out.data_ptr(),
                M, K, N, J, plan["L"], plan["bn"], plan["pitch"], blocks,
                plan["smem"], cluster, *G._stages(plan["L"]), 1,
                torch.cuda.current_stream().cuda_stream)
        runs = [("base", plan["cluster"], plan["blocks"]), ("base", 1, n_sms),
                ("narrow off", plan["cluster"], plan["blocks"])]
        if plan["stripes"] <= 30:
            runs.append(("base", 4, 120))
        for vn, cluster, blocks in runs:
            call = launcher(libs[vn], cluster, blocks)
            err = call()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name} {vn} cluster {cluster}: "
                                   f"cudaError {err}")
            e = float((out - want).abs().max())
            if not (out - want).abs().le(2e-3 + 2e-3 * want.abs()).all():
                raise RuntimeError(f"{name} {vn}: max abs err {e:.3e}")
            row[f"{vn} cluster {cluster} x {blocks // cluster}"] = (
                graph_us(call))
        call = launcher(libs["timed"], plan["cluster"], plan["blocks"])
        call()
        torch.cuda.synchronize()
        ph = out.flatten()[:4 * plan["blocks"]].view(-1, 4).cpu().numpy()
        ph = ph / 1e3                     # ns -> us
        row["phases_us_mean"] = ph.mean(0).tolist()
        row["phases_us_max"] = ph.max(0).tolist()
        W = G.ovsf_decompress(al, idx, K)
        row["matmul_us"] = graph_us(lambda: torch.matmul(x, W))
        rows.append(row)
        print(f"{name} M={M} {K}->{N} J={J} bn {plan['bn']}: "
              + ", ".join(f"{k} {v:.1f} us" for k, v in row.items()
                          if k.startswith(("base", "narrow")))
              + f", matmul on dense W {row['matmul_us']:.1f} us; phases "
              "(stash, batches, zero rows + cluster copy, product) mean "
              + " / ".join(f"{v:.2f}" for v in row["phases_us_mean"])
              + " us, max " + " / ".join(f"{v:.2f}"
                                          for v in row["phases_us_max"]),
              flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "ovsf_gemm_mono_phases.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
