"""Serving launcher for the port: batched requests through ``LLMEngine``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama_1_1b \
      [--no-bucketing | --chunk-size 64 [--packed] [--paged]] \
      [--smoke] [--device cpu] \
      [--alpha-dtype int8|int4] [--calibrate [--calibration-out F]] \
      [--admission reject|truncate|preempt] [--inject KIND:K=V,...] \
      [--max-waiting N] [--step-timeout S] [--deadline S] \
      [--journal DIR [--supervise]] [--dtype float32]

Runs on the GPU unless ``--device cpu`` is given (it raises when no GPU is
present). ``--arch`` (or ``--model``) names a config of
``repro_torch.configs``, dense
(``tinyllama_1_1b``, ``qwen2_5_14b``, ``qwen1_5_32b``, ``starcoder2_15b``),
MoE (``olmoe_1b_7b``; ``kimi_k2_1t_a32b``, about 1T parameters, with
``--smoke`` only), SSM (``falcon_mamba_7b``), hybrid (``zamba2_1_2b``),
encoder-decoder (``whisper_tiny``) or VLM (``llava_next_34b``); the last
two are served from tokens alone, as the reference's launcher serves them
(no frames: the cross caches stay zero; no image embeds: text only).
The recurrent families (SSM, hybrid) are served by the legacy path with
exact per-request prefill only: given ``--chunk-size`` (and ``--packed`` /
``--paged``) the engine warns and falls back to it, as the reference's
does. Parameters are initialised natively from ``--seed``;
``--alpha-dtype`` stores the OVSF alphas as int8 or nibble-packed int4 with
per-segment fp32 scales. The engine's mapper plans each OVSF weight type,
as the reference engine does, against the device's target (``h100`` on the
GPU, ``cpu`` on the CPU); the plan is printed. Without ``--chunk-size`` the
engine runs the legacy phase-based path, as the reference's launcher does:
whole prompts prefill in length-bucketed groups (``--no-bucketing``: each
at its native length), then decode. ``--chunk-size N`` switches to
step-based serving (prompt chunks of N tokens beside the decodes);
``--packed`` picks the packed step over the (B, W) window, ``--paged`` the
paged KV cache over the contiguous one (both need ``--chunk-size``).
``--calibrate`` records measured-vs-modeled step times
(``runtime.calibrate``) and prints the table's keys and relative factors
and the layers the calibrated re-plan would re-map, saving the table to
``--calibration-out`` when given. On the GPU every step replays a CUDA
graph, one per step shape (and one per prefill key in legacy mode); the
launcher prints the step shapes run and the graphs captured (none on the
CPU, where steps run eagerly).

Chaos flags, as the reference's: ``--inject`` arms deterministic faults
(repeatable: ``nan:step=3``, ``fail:step=7``, ``delay:step=5,s=0.2``,
``die:step=3``; ``flip`` is refused, it needs the gateway's resident
banks: ``repro_torch.launch.gateway``), ``--admission preempt`` lets a more urgent request evict a running
one (recomputed), ``--max-waiting`` bounds the queue (load shedding),
``--deadline`` bounds each request's life, ``--step-timeout`` arms the
stall watchdog (a step's wall less the first step of each shape on a core:
its warm-up and CUDA-graph capture). ``--journal DIR`` arms the write-ahead request journal: a
restarted launcher pointed at DIR recovers every live request instead of
submitting it again. ``--supervise`` (with ``--journal``) runs the launcher
as a child under a restart loop (``launch.supervise``), so ``--inject
die:step=N`` is a real process death that must still finish every request
exactly once.

Exit contract (the reference's): every request must be terminal, and a
finish reason other than ``eos``, ``length`` or ``rejected`` must come
from a degradation this run configured (``nan`` -> ``error``,
``--deadline`` -> ``timeout``, ``--max-waiting`` or ``--admission
preempt`` -> ``shed``/``preempted``); a request the journal shows
finished before a crash counts once. Otherwise the launcher exits
non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import registry as R
from repro_torch.runtime.faults import FaultPlan
from repro_torch.serving import (LLMEngine, Request, RequestJournal,
                                 SamplingParams)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--model", dest="arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--buffer", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="", choices=["", "bfloat16", "float32"],
                    help="model dtype (default: the config's); in float32 "
                         "a recomputed context rounds as the first pass "
                         "did, so recovered streams can be held equal")
    ap.add_argument("--alpha-dtype", default="", choices=["", "int8", "int4"],
                    help="quantised alpha storage: int8 halves / int4 "
                         "quarters the streamed alpha bytes (dequantised "
                         "in-kernel by the fused generator)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples with per-request seeds")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--no-bucketing", action="store_true",
                    help="legacy path: prefill each prompt at its native "
                         "length")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="step-based serving: interleave N-token prompt "
                         "chunks with decode (None = phase-based prefill)")
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (must divide --buffer)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="page-pool size (default slots*buffer/page_size)")
    ap.add_argument("--calibrate", action="store_true",
                    help="record measured-vs-modeled step times and report "
                         "the calibrated re-plan")
    ap.add_argument("--calibration-out", default="",
                    help="write the calibration table JSON here")
    ap.add_argument("--admission", default="reject",
                    choices=["reject", "truncate", "preempt"])
    ap.add_argument("--inject", action="append", default=[],
                    metavar="KIND:KEY=V,...",
                    help="deterministic fault injection, repeatable: "
                         "nan:step=3,slot=0 | fail:step=7 | "
                         "delay:p=0.1,s=0.002 | die:step=3 (seed-driven)")
    ap.add_argument("--max-waiting", type=int, default=None,
                    help="bound the waiting queue; overloads load-shed the "
                         "least urgent request (FINISH_SHED)")
    ap.add_argument("--step-timeout", type=float, default=None,
                    help="soft per-step watchdog: a slower step counts a "
                         "stall and triggers a core rebuild + recompute")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline in seconds (FINISH_TIMEOUT "
                         "past it)")
    ap.add_argument("--journal", default="",
                    help="write-ahead request journal directory; on start "
                         "its live requests are recovered mid-stream")
    ap.add_argument("--supervise", action="store_true",
                    help="run this launcher as a supervised child process "
                         "that is restarted after an injected die fault "
                         "(requires --journal)")
    args = ap.parse_args(argv)

    if args.supervise:
        from repro_torch.launch.supervise import supervise
        raw = list(sys.argv[1:] if argv is None else argv)
        if not args.journal:
            raise SystemExit("--supervise requires --journal: a crash "
                             "without a journal loses every live request")
        supervise("repro_torch.launch.serve",
                  [a for a in raw if a != "--supervise"])
        return
    if args.packed and args.chunk_size is None:
        raise SystemExit("--packed requires --chunk-size")
    if args.paged and args.chunk_size is None:
        raise SystemExit("--paged requires --chunk-size")

    plan = FaultPlan.parse(args.inject, seed=args.seed)
    if any(f.kind == "flip" for f in plan.faults):
        raise SystemExit(
            "--inject flip:... corrupts a RESIDENT registry bank, which a "
            "single-engine launcher does not have (run it through "
            "repro_torch.launch.gateway)")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf,
                                               alpha_dtype=args.alpha_dtype))
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    params = R.model_init(cfg, args.seed, device)
    print(f"[serve] {cfg.name}: {R.param_count(params)/1e6:.1f}M params "
          f"on {device}"
          + (f" (alphas={args.alpha_dtype})" if args.alpha_dtype else ""))
    if plan:
        print(f"[serve] chaos: {len(plan.faults)} injector(s) armed "
              f"(seed={args.seed}): "
              + ", ".join(f.kind for f in plan.faults))
    journal = RequestJournal(args.journal) if args.journal else None
    eng = LLMEngine(params, cfg, batch_slots=args.slots,
                    buffer_len=args.buffer,
                    bucketed_prefill=not args.no_bucketing,
                    admission=args.admission, chunk_size=args.chunk_size,
                    packed=args.packed, paged=args.paged,
                    page_size=args.page_size,
                    kv_pages=args.kv_pages, calibrate=args.calibrate,
                    max_waiting=args.max_waiting,
                    step_timeout_s=args.step_timeout,
                    faults=plan if plan else None, journal=journal,
                    device=device)
    if eng.cfg.exec_plan is not None:
        print(f"[serve] plan ({eng.cfg.exec_plan.hw_label}): " + ", ".join(
            f"{n}={p.path}" for n, p in eng.cfg.exec_plan.entries))
    if journal is not None and journal.entries:
        recovered = eng.recover_from_journal()
        ndone = sum(1 for e in journal.entries.values() if e.done)
        print(f"[serve] journal: {len(recovered)} live request(s) recovered "
              f"mid-stream, {ndone} already terminal (replayed, not re-run)")
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, args.buffer // 4))
        prompt = rng.integers(0, cfg.vocab, plen, dtype=np.int32)
        if journal is not None and rid in journal.entries:
            continue    # journaled before the crash: recovered or terminal
        admitted, bp = eng.add_request(Request(
            rid, prompt, max_new_tokens=args.max_new,
            deadline_s=args.deadline,
            sampling=SamplingParams(temperature=args.temperature,
                                    top_k=args.top_k, seed=rid)))
        if not admitted:
            print(f"[serve] request {rid} not admitted "
                  f"(backpressure={bp:.2f})")
    t0 = time.perf_counter()
    stats = eng.run_until_drained()
    dt = time.perf_counter() - t0
    print(f"[serve] completed={stats.completed} rejected={stats.rejected} "
          f"steps={stats.steps} tokens={stats.tokens_out} "
          f"({stats.tokens_out/dt:.1f} tok/s on {device})")
    if plan or stats.preemptions or stats.timeouts or stats.shed:
        print(f"[serve] faults: errors={stats.errors} "
              f"recoveries={stats.recoveries} stalls={stats.stalls} "
              f"preemptions={stats.preemptions} timeouts={stats.timeouts} "
              f"shed={stats.shed}")
    print(f"[serve] prefill={stats.prefill_s:.2f}s (batches="
          f"{stats.prefill_batches}, compiles={stats.prefill_compiles}) "
          f"decode={stats.decode_s:.2f}s mixed={stats.mixed_s:.2f}s "
          f"step_compiles={stats.step_compiles}")
    print(f"[serve] padding: valid={stats.packed_tokens} "
          f"batch={stats.padded_tokens} "
          f"efficiency={stats.padding_efficiency:.2f}")
    graphs = sorted(eng.core.graphs.keys())
    print(f"[serve] step shapes {sorted(eng.core.step_shapes)}; "
          f"{len(graphs)} CUDA graphs captured {graphs}")
    if eng.paged:
        print(f"[serve] kv_pages: total={stats.kv_pages_total} "
              f"peak_used={stats.kv_pages_used} "
              f"peak_bytes={stats.kv_bytes_used} "
              f"utilization={stats.kv_utilization:.2f}")

    if args.calibrate:
        old = eng.cfg.exec_plan
        new = eng.replan()
        if old is None or not len(eng.calibration):
            print("[serve] calibrate: no OVSF plan / no decode samples "
                  "recorded — nothing to correct")
        else:
            changed = [(n, a.path, b.path)
                       for (n, a), (_n, b) in zip(old.entries, new.entries)
                       if a.path != b.path]
            facs = eng.calibration.factors(eng.hw_label)
            print(f"[serve] calibrate: {len(eng.calibration)} keys, "
                  f"relative factors: "
                  + ", ".join(f"{k}={v:.2f}" for k, v in sorted(facs.items())))
            if changed:
                for n, a, b in changed:
                    print(f"[serve] calibrate: {n}: {a} -> {b}")
            else:
                print("[serve] calibrate: measured factors keep every "
                      "layer on its modeled path")
        if args.calibration_out:
            eng.calibration.save(args.calibration_out)
            print(f"[serve] calibrate: table -> {args.calibration_out}")

    outs = {o.rid: o for o in eng.outputs()}
    if journal is not None:
        # requests that went terminal before a crash live only in the
        # journal; they count as finished, once
        for rid, e in journal.entries.items():
            if e.done and rid not in outs:
                outs[rid] = e
        journal.close()
    allowed = {"eos", "length", "rejected"}
    if any(f.kind == "nan" for f in plan.faults):
        allowed.add("error")
    if args.deadline is not None:
        allowed.add("timeout")
    if args.max_waiting is not None or args.admission == "preempt":
        allowed.update(("shed", "preempted"))
    missing = [r for r in range(args.requests) if r not in outs]
    bad = [(r, o.finish_reason) for r, o in outs.items()
           if o.finish_reason not in allowed]
    if missing or bad:
        raise SystemExit(f"[serve] FAILED: unfinished={missing} "
                         f"unexpected={bad}")


if __name__ == "__main__":
    main()
