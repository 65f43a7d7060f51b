#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

  python3 chip_smoke.py [--seed N]

Phases, each of which fails the run (non-zero exit, no result line):
  1. card:   require CUDA; print ``nvidia-smi`` name and power limit.
  2. build:  compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, in parallel) and print the build time.
  3. kernels: hold ``ovsf_gemm`` with bf16/fp32, int8 and nibble-packed
             int4 alphas (segmented at the TinyLlama-1.1B layer shapes for M
             in {4, 128} and, bf16 x, 256, plus monolithic and ragged cases;
             fp32 x also at M 64, a layer summary of the CUDA-core kernel
             at M 4 and 64; each case prints the kernel it ran,
             tensor-core or CUDA-core, and each M a layer summary against
             matmul on the dense W) and
             ``paged_flash_decode`` (T in {4, 128}, H 32, Hkv 4, hd 64,
             page 16, padding tokens and sentinel pages) and
             ``flash_decode_attn`` (B 4, H 32, Hkv 4, hd 64, T 320 with
             per-row positions (1, 77, 256, 320), the same with one row at
             0, the packed gather shape B 128, T 256, and a ragged hd 80,
             T 33; the library yardstick is SDPA with a boolean mask; the
             packed path's (T, Tbuf) row gather is timed beside it; each
             attention case prints the split count and block count it ran
             with, and both attention kernels are also checked, untimed,
             at shapes that take their other code paths, each launched
             twice with outputs equal bit for bit; and both over int8 K/V
             (the int8 KV cache: paged T 4 and 128, the window decode and
             packed gather shapes, bf16 and fp32 q) against their int8
             plain versions, a second launch equal to the first, with the
             bound over the int8 bytes, SDPA over the K/V dequantised
             beforehand as the library call and the ratio to the same case
             over a cache of q's type; ``ovsf_gemm`` with bf16 alphas also
             at M = 1024, the legacy prefill's 256 bucket at 4 slots) and
             ``ovsf_decompress`` (the ResNet-50 and SqueezeNet-1.1 shapes, a
             ragged shape, repeated code ids; and its int8 / int4 epilogue
             at TinyLlama-1.1B's converted shapes, phase 14's model: 2048
             -> 2048, 2048 -> 5632, 5632 -> 2048 at L 8192, J = L / 2, the
             ragged 1000 -> 40 and repeated ids, W fp32; and its segmented
             layout, phase 17's: TinyLlama-1.1B's five W, L0 16, 8 kept,
             and ragged cases (L0 8 and 32, n_keep 5 and 32, repeated ids,
             d_out off the tile) with fp32, bf16, int8 and int4 alphas,
             and phase 10's: OLMoE-1B-7B's three expert banks (64 experts,
             one launch a bank), bf16 and fp32, W row-major; within 2e-3
             (fp32 W, bit for bit on distinct ids) or 2e-2 relative L2
             (bf16 W, which also equals the plain version's fp32 sums
             rounded once), the library call ``torch.bmm`` of prebuilt
             signs by the alphas (over a bank's batch);
             ``OvsfDecompressFn``'s dA and d scale over segmented ids
             against autograd through the plain version) and ``fwht``
             (the (M, L) of the planned ResNet-50 and SqueezeNet-1.1
             forwards at batch 8,
             ragged (37, 1024), (5, 2) and the limit (3, 32768)) against
             their plain versions on the card, in bf16 and fp32; print each
             error against its tolerance, the kernel's device time
             (CUDA-graph replay), its bound, the plain version's time and
             one library call's (the port never calls it). The two WHT
             kernels must equal their plain versions bit for bit (fp32;
             bf16 one rounding of the same fp32 value; repeated ids keep the
             tolerance: atomics sum them in any order), a second launch must
             equal the first, and each case prints its share of the bound
             and its ratio to the library call. ``fwht`` must
             refuse a length that is not a power of two and L = 65536
             before any launch. The monolithic tensor-core ``ovsf_gemm``
             (fp32 x and alphas over monolithic codes) is also checked at
             ragged shapes and with repeated code ids (a second launch equal
             to the first where no id repeats). Then the quantised wrapper
             must refuse
             what it does not take (bf16 or CPU scales, CPU alphas, float
             alphas, scales that do not tile J), and ``ovsf_matmul`` must
             run ``materialize`` of segmented codes, bf16 or int4, through
             one segmented ``ovsf_decompress`` launch (y the product with
             its W), ``materialize`` of monolithic int8 / int4 alphas
             through one ``ovsf_decompress`` launch equal to the plain
             version, and run
             ``spectral`` of segmented codes (plain tensor code, as the
             reference's jnp) there, equal to the CPU's.
             Last, one ResNet-50 s2 conv's GEMM (M
             1568, 2304 -> 256, rho 0.5, integer-valued inputs) under
             ``materialize``, ``fused`` and ``spectral`` plans: the three
             outputs must be equal, each through its own kernel (``fused``
             on the monolithic tensor-core ``ovsf_gemm``).
  4. serve:  full-width TinyLlama-1.1B (22 layers, d 2048, bf16, random
             weights from --seed) through ``LLMEngine(paged=True,
             packed=True, chunk_size=64, batch_slots=4, buffer_len=256)``,
             once with bf16 alphas and once each with int8 and int4 alphas:
             the engine's mapper plan (target ``h100``, the reference's
             candidates ``materialize`` and ``fused``) must be ``fused`` for every
             OVSF weight type, 8 requests (6 greedy, 2 sampled)
             must all finish, and the kernel launch counters, zeroed just
             before, must read 5 * 22 ``ovsf_gemm`` launches of that alpha
             storage and 22 ``paged_flash_decode`` launches per step. Then,
             bf16 alphas, the same 8 requests in the other engine styles
             (``chunk_size=64``): contiguous window (22
             ``flash_decode_attn`` launches per chunk-free step, counted
             here, none on steps that carry chunks), contiguous packed (22
             ``flash_decode_attn`` per step) and paged window (22
             ``paged_flash_decode`` per step, no ``flash_decode_attn``);
             110 ``ovsf_gemm`` launches per step in every style, every
             one of them on the tensor-core kernel (bf16 x). The bf16
             paged packed run calibrates (``calibrate=True``): its table
             must hold plan entries x chunk-free steps samples, every
             relative factor 1.0 within 1e-9 (a step's wall is split in
             proportion to the modeled II), and ``replan()`` must equal the
             engine's plan; ``suggest_rhos`` at the decode shape on h100
             prints its raises. Every serve run above, and the same four
             styles again in fp32 (fp32 alphas; ``ovsf_gemm`` on its CUDA-core
             kernel; full width, depth cut to ``SERVE_FP32_LAYERS``, 6 of
             22; the int8 / int4 alpha runs and the bf16 contiguous packed
             and paged window styles at ``SERVE_CUT_LAYERS``, 6 of 22), runs
             twice on the same params and requests: eagerly
             (``LLMEngine(capture=False)``) and replaying the engine's CUDA
             graphs (its default, one graph per step shape). The two must
             give the same token streams (greedy and sampled), every
             chunk-free step's logits bit for bit (mixed steps counted), the
             same launch counters; over 8 profiled chunk-free steps (the
             most that any window recorded, eager and graph in turn until
             their counts agree, 2 to 6 windows each: ``agreed_windows``)
             the profiler's launches of each hand-written kernel, by name,
             must be equal in the two and equal to the wrappers' counters,
             and all kernels per step equal (the names that differ are
             printed);
             the graph run holds at most 3 packed and 2 window graphs, keyed
             as ``step_shapes``, and its chunk-free step wall (host clock)
             must be below eager's; both print wall, device busy and idle
             share.
  4b. legacy: the legacy phase-based path (``LLMEngine(chunk_size=None)``,
             the launcher's default) at full width in bf16, 4 slots, buffer
             256, the same 8 requests, bucketed and unbucketed
             (``bucketed_prefill=False``), eagerly and replayed: every
             request finishes, streams, every step's logits and the launch
             counters equal in the two; every step launches 110
             ``ovsf_gemm`` (all tensor-core) for each prefill call and for
             the decode, 22 ``flash_decode_attn`` for the decode and no
             attention kernel in a prefill (its S > 1 attention is plain
             ``sdpa``, as the reference's); the graphs are the bucketed
             prefill keys (at most 6 buckets) and ``("decode", 1)`` (exact
             prefills run eagerly); it prints the host ms a prefill call,
             the device ms of one replay of each bucket and, bucketed, the
             decode step's wall, replay span, busy time and idle share
             (profiled as phase 4's, eager against graph). The replayed
             run's reserved memory (K/V cache and peak above the run's
             start) must stay within ``LEGACY_MEMORY`` x the contiguous
             window run's of phase 4 (5x bucketed, 1x unbucketed), each
             bucket's graph must hold K/V Lb columns deep, and 8 more
             requests of new prompt lengths (in the captured buckets, or
             new exact lengths) must capture nothing and leave
             ``memory_reserved`` within 2 MiB; the MiB its graphs hold is
             printed. Then the int8
             KV cache, replayed, in the legacy path and the paged packed
             engine: every request finishes with the bf16 cache's launch
             counts, the cache's K/V bytes half the bf16 cache's, and the
             legacy decode step profiled (the int8 instances of
             ``flash_decode_kernel`` counted by name among the hand-written
             kernels). Then fp32: at one slot the legacy streams equal the
             packed engine's (the reference's single-slot anchor); card vs
             CPU ``serve_prefill_ragged`` logits at a (4, 64) bucket
             within 1e-3 relative L2, over an fp32 cache and over an int8
             cache with the CPU fed the card's int8 K/V layer by layer (the
             CPU's own int8 prefill's error printed beside the count of
             cache entries its quantisation puts one step from the card's,
             each at most one); and card vs CPU
             ``serve_step`` and a paged decode step over the same int8
             caches (22 launches of the int8 ``flash_decode_attn`` and
             ``paged_flash_decode`` instances) within 1e-3.
  5. parity: one full-width packed paged step in fp32 on the card vs the
             same step with the same parameters on the CPU (plain versions),
             with fp32 and with int8 alphas, planned as the engine plans on
             the card; then one fp32 ``serve_step`` (the contiguous window
             engine's decode, a row at pos 0 and an idle row past the
             buffer) and one fp32 ``serve_step_packed`` (chunks and decodes
             mixed) over random caches; relative L2 error of the logits
             <= 1e-3.
  6. cnn:    full-width ResNet-50 and SqueezeNet-1.1 in matrix mode
             (fp32, 224x224, batch 8, 1000 classes, random weights from
             --seed) through ``cnn_apply``: with no plan (13 and 6
             ``ovsf_decompress`` launches per forward and nothing else),
             then the registered ResNet-50 config (spatial mode, no
             kernel), then planned by ``plan_cnn(cfg, batch=8, hw="h100",
             paths=ALL_PATHS)`` (ResNet-50 and SqueezeNet-1.1), by
             ``paths=("fused",)`` (both: every OVSF conv ``fused``) and by the
             default paths (ResNet-50). A planned phase prints the plan's
             path counts, and the launch counters, zeroed just before one
             forward, must equal them: ``fwht`` the ``spectral`` entries,
             ``ovsf_decompress`` the ``materialize`` ones, ``ovsf_gemm``
             the ``fused`` ones, and every ``ovsf_gemm`` launch of a CNN
             phase must be on the monolithic tensor-core kernel
             (``launches_by_kernel``). Each phase: card vs CPU logits (TF32 off
             for cuDNN and matmul, here and in every phase) within 1e-3
             relative L2 error; images/s, device ms per forward,
             ``ovsf_decompress`` and ``fwht`` ms per forward and the idle
             share. SqueezeNet-1.1 also runs under the default paths. Every
             phase then replays the same forward from a CUDA graph
             (``cnn.CapturedForward``, one per (arch, batch, plan)): its
             logits must equal the eager forward's bit for bit and its
             launch counters the plan's; over the profiled forwards the
             hand-written kernels' launches by name must equal eager's and
             the wrappers' counters, and all kernels per forward eager's; a
             second batch's graph (one image) must
             give its eager logits and leave the first batch's intact, and
             the reverse; it prints its wall, device busy, idle share and
             kernels per forward beside eager's.
  7. calibrate: every OVSF conv of full-width ResNet-50 (13) and
             SqueezeNet-1.1 (6), matrix mode, fp32, batch 8, at its real
             im2col shape (``hwmodel.cnn_workload``), through
             ``ops.ovsf_matmul`` under its ``plan_cnn`` entry with the path
             replaced by each of ``materialize`` (``ovsf_decompress`` +
             GEMM), ``fused`` (the monolithic tensor-core ``ovsf_gemm``, a
             second launch equal to the first) and
             ``spectral`` (pad, ``fwht``, ``index_select``, GEMM): one
             launch of the path's kernel a call, the output within the fp32
             tolerance of the plain version, device ms from CUDA-graph
             replay recorded into an h100 ``CalibrationTable`` against
             ``classify_gemm``'s modeled II for that path (saved to
             ``chiprun_out/calibration_h100.json``). The ``fused`` rows also
             time the plain version and matmul on the dense W, and print the
             kernel's share of two bounds: the work as the card does it at
             best (three bf16 products on the tensor cores and one WHT a
             column on the fp32 cores, or the bytes) and the old count (one
             fp32 product on the CUDA cores). Then both
             CNNs run as in phase 6 under their calibrated ``ALL_PATHS``
             plans (``classify_gemm(..., calibration=table)`` per conv),
             with the paths per conv and device ms per forward printed
             beside the plans phase 6 ran. Last, the default, the
             uncalibrated ``ALL_PATHS`` and the calibrated ResNet-50 plans
             replay their captured forwards in turn (9 rounds of 20, the
             order rotated, CUDA events): the calibrated plan's median must
             be at most 1.01x the default plan's and below the uncalibrated
             ``ALL_PATHS`` plan's.
  8. chaos:  the fault paths of ``LLMEngine`` on full-width TinyLlama-1.1B
             (OVSF rho 0.5 on q, o, gate, up, down, planned ``fused``;
             every step replayed from CUDA graphs), no kernel of its own:
             (1) the CI chaos lines (``ci.yml:68-69``: 6 requests, max-new
             8, chunk 8, ``nan:step=3`` and ``fail:step=7``) in the
             contiguous and the paged window, fp32 and bf16, each beside
             the same run without faults: exactly the request in slot 0 at
             step 3 ends ``error``, one recovery, the graphs after it the
             fault-free step shapes; fp32: every other stream equal; bf16:
             the count that agree printed. (2) ``nan:step=3`` alone: the
             same graphs and captures as without it, and over replayed
             decode steps whose poison row is live the profiler's kernels
             by name and the wrappers' counters equal, no new capture. (3)
             ``fail:step=5,every=10`` over at least 3 recoveries: each one's
             rebuild and re-capture ms (the engine's counters) and
             ``memory_reserved`` after it, equal after every rebuild within
             2 MiB. (4) fp32: a step body that raises on its first call under
             capture; the engine recovers, no stream is left capturing, the
             streams equal the fault-free run's; then the stall watchdog
             with ``step_timeout_s`` between a replayed step and a first
             step of a shape, and a ``delay`` fault: the delayed step
             stalls, every stall recovers once, first steps of a shape
             longer than the timeout (the rebuilt core's captures) do not
             stall, the streams equal. (5) fp32 paged packed, page
             gate (8 pages) and ``admission="preempt"`` with a priority-5
             late arrival: greedy and sampled streams equal the runs never
             preempted, with the recompute's extra prompt tokens. (6) bf16:
             ``max_waiting=2`` sheds, a deadline expires a running request,
             ``cancel()`` frees a slot and its pages; each request finishes
             once, with its reason. (7) the CI kill-9 line in a subprocess,
             started after (4)'s timed steps and run beside the rest but (8)
             (``python -m repro_torch.launch.serve ... --journal DIR
             --supervise --inject die:step=3``), bf16 and ``--dtype
             float32``: exit 0, one terminal record a request in the
             journal; fp32 streams equal the run without the kill, bf16's
             agreement printed. (8) the replayed bf16 paged packed
             chunk-free step wall with the journal and without, in turns.
             Every chaos run must recover exactly as often as its faults
             ask, and every serve run of phase 4 not at all.
  9. gateway: the multi-model gateway (``serving.gateway``) at full
             width. (1) ``ovsf_gemm`` (bf16, 16-long segments) at
             qwen2_5_14b's projection shapes (5120 -> 5120, 1024, 13824 and
             13824 -> 5120; M 4 and 64), each on the tensor-core kernel, and
             ``flash_decode_attn`` at its heads (H 40, Hkv 8, hd 128; bf16
             and fp32), against their plain versions with device ms, bound
             and library ms; ``ovsf_matmul_multi`` over 2 variants equal to
             ``spectral_matmul`` bit for bit at TinyLlama-1.1B's q and down
             shapes (T 8 and 64, bf16 and fp32). (2) A ``ServingGateway``
             (4 slots, buffer 128, chunk 8, every step replayed) over a
             registry of tl-a and tl-b (full-width TinyLlama-1.1B and its
             ``make_alpha_variant``, stacked into one engine) and qw
             (qwen2_5_14b at its published widths, ``QWEN_LAYERS`` = 6
             of its 48 layers), bf16, 12 requests round-robin (greedy and sampled): each
             finishes once; the stacked engine launches 22
             ``flash_decode_attn`` a step and no ``ovsf_gemm``, qw's 7 x
             layers ``ovsf_gemm`` a step (tensor-core) and its layers'
             ``flash_decode_attn`` a chunk-free step; each engine's graphs
             are its step shapes (at most 2); the pair's resident bytes
             below one dense-fp32 TinyLlama, the pool's below one dense-fp32
             qwen2_5_14b. Re-routing the stacked engine's slots to the
             other variants captures nothing; its replayed chunk-free step
             prints wall, device busy and idle share beside phase 4's
             contiguous packed step, its profiled hand-written launches
             equal to the wrappers' counters. bf16 streams vs dedicated
             spectral engines: agreement printed; in fp32 (the pair at
             ``GATEWAY_FP32_LAYERS``, 2 replicas, packed; reserved KV and
             graph MiB printed per replica) equal.
             ``flip`` + scrub repair 4 times under traffic (fp32 pair,
             packed): after each, ``memory_reserved`` split by pool (the
             allocator's default pool and each graph's: segments, reserved
             and live bytes) is printed, and the live bytes
             (``memory_allocated``) and ``memory_reserved`` must each stay
             within 2 MiB of the first repair's; the streams equal a run
             without flips. (3) The CI gateway lines
             (``ci.yml:80``, ``:81``, ``:99``, ``:113``, the last in
             ``--dtype bfloat16`` and ``float32``) through ``python -m
             repro_torch.launch.gateway --smoke`` in subprocesses started
             together: each exits 0, its wall printed; fp32 kill-9 streams
             byte-identical to the fault-free re-run.
  10. moe:   the MoE family: ``olmoe_1b_7b`` at its published widths
             (d 2048, 16/16 heads of 128, vocab 50304, 64 experts top-8 of
             d_ff 1024, OVSF rho 0.5 on attention and experts, 16-long
             segments), its depth cut to ``MOE_LAYERS`` (2 of 16), bf16,
             random weights from --seed.
             (1) ``paged_flash_decode`` (T 4 and 128, page 16) and
             ``flash_decode_attn`` (window decode B 4, T 128) at its heads
             (H 16, Hkv 16, hd 128), bf16 and fp32, against their plain
             versions with device ms, bound and SDPA's ms. (2) The 8
             requests of phase 4 through ``LLMEngine`` paged packed (chunk
             64, 4 slots, buffer 256), eager and replayed: every request
             finishes; the plan is the reference's, ``fused`` for
             ``attn_q/k/v/o`` and ``e`` (the three expert weight types
             share that one entry, as the reference's mapper names it);
             every step launches 4 ``ovsf_gemm`` a layer (all tensor-core),
             3 segmented ``ovsf_decompress`` a layer (the expert banks,
             regenerated under every plan but ``spectral`` as the
             reference's vmap of ``decompress`` does, one launch of the
             segmented kernel over a bank's 64 experts; the plain segmented
             decompress never runs on the card) and one
             ``paged_flash_decode`` a layer and nothing else of ours;
             streams,
             every chunk-free step's logits, launches and profiled kernels
             equal between the runs; at most 3 packed graphs; the
             profiler's launches equal to the wrappers' counters. Printed
             only: wall, replay span, device busy, idle share, the MoE
             blocks' device ms a step and their share of the replay (also
             recorded), the segmented kernel's ms a step, each graph's
             MiB. (3) The same through the legacy path, bucketed, eager
             and replayed: streams and every step's logits equal, 4
             ``ovsf_gemm`` and 3 segmented ``ovsf_decompress`` a layer a
             prefill call and a decode, one ``flash_decode_attn`` a layer
             a decode.
             (4) Card vs CPU in fp32 at full width but 2 layers
             (``MOE_PARITY_LAYERS``), a paged packed step and a decode
             step: the routing first (a flip whose k-th/(k+1)-th
             probability gap exceeds 1e-5 fails; a step must match some
             slot), then every matched slot's logits within 1e-3 relative
             L2. (5) The expert alphas' bytes on the card at most 0.55x
             the dense bf16 banks'. No host clock, idle share or reserved
             memory is gated here.
  11. ssm:   the recurrent families at their published widths:
             ``falcon_mamba_7b`` (``SSM_LAYERS``: 8 of its 64 Mamba-1
             layers, d 4096, d_inner 8192,
             N 16, vocab 65024) and ``zamba2_1_2b`` (12 of its 38 Mamba-2
             layers, d
             2048, N 64, heads of 64, a weight-shared attention + MLP block
             after every 6th: 32/32 heads of 64, d_ff 8192), bf16, OVSF
             rho 0.5 on the Mamba in/out projections and the shared block.
             (1) ``ovsf_gemm`` (M 4, bf16) at their projections and at
             StarCoder2-15B's six (d 6144, d_ff 24576, ungated), each on
             the tensor-core kernel; ``flash_decode_attn`` (window decode B
             4, T 128) at Zamba2's and StarCoder2's heads and
             ``paged_flash_decode`` (T 4 and 128) at StarCoder2's (H 48, Hkv
             4, hd 128), bf16 and fp32, against their plain versions with
             device ms, bound and the library call's ms. (2) Each model
             through ``LLMEngine(chunk_size=64, paged=True, packed=True)``,
             as the main path's launcher asks: the engine must warn and
             fall back to the legacy engine with exact per-request prefill
             (no chunks, pages, packing or bucketing); phase 4's 8 requests
             (16 new tokens each, 4 slots, buffer 256), eager and replayed:
             every request finishes; the plan ``fused`` at every entry and
             for ``mlp_in`` / ``mlp_out`` (and the shared block's seven);
             every step launches 2 ``ovsf_gemm`` a Mamba block and 7 a
             shared-block application for each prefill call and for the
             decode (all tensor-core; at 16 / 12 layers Falcon 32, Zamba2
             24 + 14 = 38),
             one ``flash_decode_attn`` an application a decode (Zamba2 6)
             and nothing else of ours; streams, every step's logits,
             launch counters and profiled kernels equal between the runs;
             one graph, ``("decode", 1)``; the profiler's launches equal
             to the wrappers' counters; the ``conv`` / ``ssm`` state and
             K/V keep their addresses through the runs and the profiled
             replays. Printed: the replayed decode step's wall, replay
             span, device busy and idle share, the graph's MiB, the
             state's bytes, the alphas' bytes against dense bf16 (at most
             0.55x). (3) Card vs CPU in fp32 at full width but 2 (Falcon) /
             6 (Zamba2: one shared-attention application) layers: three
             exact prefills and two all-slot decode steps, logits within
             1e-3 relative L2, the state after them too. (4) StarCoder2-15B
             at full width but 2 layers, bf16, replayed, paged packed and
             legacy: every request finishes with 6 ``ovsf_gemm`` and one
             attention kernel a layer a step (the launch counts of its
             kernel rows).
  12. encdec/vlm: the encoder-decoder and VLM families at their published
             widths: ``whisper_tiny`` uncut (4 + 4 layers, d 384, 6 heads
             of 64, Te 1500, vocab 51865; no OVSF layer at this width) and
             ``llava_next_34b`` (``LLAVA_LAYERS`` of 60 layers, d 7168,
             56/8 heads of 128, d_ff 20480, vocab 64000, OVSF rho 0.5 on
             its seven projections), bf16. (1) ``ovsf_gemm`` at LLaVA's
             projections, M 4 and 1024, each on the tensor-core kernel;
             ``flash_decode_attn`` at LLaVA's heads (a GQA group of 7),
             Whisper's self heads, Whisper's cross read (B 4, T 1500, pos
             1500 on every row) and the packed cross read (B 128);
             ``paged_flash_decode`` (T 4 and 128) at LLaVA's and Whisper's
             heads; bf16 and fp32, each against its plain version with
             device ms, bound and the library call's ms; the packed cross
             gather timed. (2) Whisper: ``serve_prefill`` with frames (4 x
             1500 x 384 from the seed) and 16 greedy steps (two
             ``flash_decode_attn`` a layer a step, none in the prefill),
             the frames moving the prefill logits; fp32 card vs CPU within
             1e-3 relative L2 at every call; then the main path's engine
             (chunk 64, paged, packed) and the legacy engine, eager and
             replayed: every request finishes, replayed streams and logits
             equal eager's, launches a step as the path gives them, the
             cross caches zero (the engine passes tokens only) and no
             prefill graph holding one; kernels a step, device busy and
             idle share printed. (3) LLaVA: the alphas at most 0.55x the
             dense bf16 bytes; the plan ``fused`` at its seven entries;
             ``serve_prefill`` with the config's 1024 image positions and
             32-64 text tokens, then 16 decode steps (7 ``ovsf_gemm`` a
             layer a call, one ``flash_decode_attn`` a layer a step); the
             two engines as Whisper's; the replayed decode step's device
             ms and ``ovsf_gemm`` share against the byte bound of the
             alphas and ``lm_head``. (4) LLaVA at full width but 2 layers,
             fp32, 8 image positions: card vs CPU within 1e-3.
  13. train: training on the card, TF32 off, under
             ``torch.use_deterministic_algorithms`` only where said
             (``CUBLAS_WORKSPACE_CONFIG`` is set at the start for it). (1)
             Each OVSF autograd wrapper (``kernels.ops``: ``ovsf_gemm``,
             ``ovsf_decompress``, ``fwht``) against autograd through its
             kernel's plain version: TinyLlama-1.1B's five projections at
             M 1024 in bf16 (tensor-core forward), one fp32 projection
             (CUDA-core), ResNet-50's conv GEMMs at batch 8 in fp32 under
             ``materialize``, ``fused`` and ``spectral``; y, dx and dA
             within 2e-3 (fp32) / 2e-2 (bf16) relative L2, ``fwht``'s
             backward the plain transform bit for bit; forward + backward
             device ms beside ``torch.matmul`` on a dense W, and the
             forward alone. (2) ResNet-50 and ResNet-18 in matrix mode,
             fp32: ``cnn_loss`` forward + backward at batch 8 under the
             default, ``("fused",)`` and ``ALL_PATHS`` h100 plans, each
             kernel's launches a step equal to the plan's, against the CPU
             port: the loss, each BN layer's new statistics, ResNet-50's
             eval-mode and ResNet-18's train-mode gradients (ResNet-50's
             train-mode ones are ill-conditioned: ``cnn_train_phase``). (3) One fp32 train step of TinyLlama at full
             width, ``TRAIN_PARITY_LAYERS`` layers, card vs CPU, both under
             the config's ``materialize`` and the card again under an
             explicit ``fused`` plan: loss within
             1e-5, gradients and updated params within 1e-3 relative L2. (4)
             ``runtime.supervisor.run`` at full width, ``TRAIN_FAULT_LAYERS``
             layers, ``materialize``, with a ``FaultPlan`` ``fail`` between checkpoints: one
             failure, a restore, the replayed losses equal the
             uninterrupted run's bit for bit; the final checkpoint restores
             bit for bit and a flipped byte is refused, naming its leaf. (5)
             ``python -m repro_torch.launch.train --arch tinyllama_1_1b``
             at full width and depth (``main`` in this process), so under
             the config's ``materialize``: 12 steps
             of B 8, S 128, one checkpoint, at the end; finite losses, the last
             below the first, 220 segmented ``ovsf_decompress`` launches a
             step (remat recomputes each block's forward) and no
             ``ovsf_gemm``; step wall, device busy, idle share, peak
             ``memory_allocated`` and each save's seconds printed; then one
             step of the trained state under an explicit ``fused`` plan,
             profiled: 220 ``ovsf_gemm``, all tensor-core. (6) The
             trained params served by ``LLMEngine`` paged packed, eager and
             replayed: streams equal, logits finite.
  14. convert: the paper's Converter on the card (its kernel rows in phase
             3). (1) Full-width TinyLlama-1.1B built dense in fp32
             from --seed and converted by ``layers.linear_convert_to_ovsf``
             (monolithic codes, rho 0.5, iterative) on its q, o, gate, up
             and down: to int8 and int4 at
             ``SERVE_CUT_LAYERS``; the conversion's wall and each weight
             type's relative error of W printed. (2) The first 2 layers
             converted on the card and on the CPU: equal kept code ids (a
             flip only at a cut gap within 1e-5 relative), alphas within
             1e-6 (fp32) or one quantum (int8); the converted int8 and int4
             models' fp32 packed paged step, card vs CPU, within 1e-3
             relative L2. (3) The dense model freed, the int8 and int4
             models, bf16, through ``LLMEngine(chunk_size=64,
             paged=True, packed=True, use_mapper=False)``, so every OVSF
             layer runs ``materialize``: eager and replayed, every request
             finishes, every step launches 5 ``ovsf_decompress`` a layer
             and one ``paged_flash_decode`` a layer and nothing else of
             ours; streams, chunk-free logits, launches and profiled
             kernels equal between the runs; the step's wall, device busy
             and idle share printed.
  15. family train: the MoE, SSM, hybrid, encoder-decoder and VLM
             families' training on the card, bf16, B 8, S 128, remat,
             under each config's ``materialize`` unless a ``fused`` plan is
             named (TF32 off). (1) ``ovsf_gemm`` forward +
             backward at each family's projections (``FAMILY_TRAIN_GEMMS``,
             M 1024): dx and dA against autograd through the plain version,
             device ms beside matmul on a dense W and the bound, a summary
             a family. (2) One fp32 step of OLMoE-1B-7B, Falcon-Mamba-7B,
             Zamba2-1.2B, Whisper-tiny and LLaVA-NeXT-34B at full width and
             ``FAMILY_PARITY_LAYERS``, card (an explicit ``fused`` plan) vs
             CPU (``spectral`` on the CPU): MoE routing first (a
             flip passes only at a near-tie, ``FAMILY_FLIP_GAP``, and
             waives that step's gradient gate, its loss held to 1e-4);
             loss within 1e-5, gradients and updated params within 1e-3
             relative L2. (3) ``runtime.supervisor.run`` of OLMoE-1B-7B at
             1 layer with a ``fail`` between checkpoints, under
             ``torch.use_deterministic_algorithms``: the replay bit for
             bit (the ops that warn printed). (4) ``python -m
             repro_torch.launch.train --arch zamba2_1_2b`` at full width
             and depth (``launcher_run``): 4 steps at ``FAMILY_LR``, one
             checkpoint, finite losses, the first batch's loss lower
             under the trained params (the last and a held-out one
             printed), 194 segmented ``ovsf_decompress`` launches a step
             (38 Mamba-2 blocks x 2 projections x 2 under remat, and the
             shared block's 7 x 6 applications, which remat does not
             recompute), then as many ``ovsf_gemm`` a step, all
             tensor-core, under an explicit ``fused`` plan; a profiled
             step's wall, device busy, idle share under each, peak memory
             and the save's seconds. (5) OLMoE-1B-7B,
             Falcon-Mamba-7B, LLaVA-NeXT-34B at ``FAMILY_LAYERS`` and
             Whisper-tiny uncut (1500 zero frames, no OVSF layer: every
             side is 384) through ``make_train_step``: the first batch's
             loss lower after the steps, the segmented ``ovsf_decompress``
             launches a step as the params give them (OLMoE's expert banks:
             3 a layer a forward, twice under remat, beside its linears'),
             then one step under an explicit ``fused`` plan (as many
             ``ovsf_gemm``, all tensor-core, and the banks' segmented
             launches), peak memory. No plain segmented decompress runs
             on the card in (2)-(5).
  16. quant train: training with int8 / int4 alphas, and stacked
             encoder-decoder variants (TF32 off). (1) ``OvsfGemmFn`` over
             int8 and int4 alphas at TinyLlama-1.1B's five projections, M
             1024: y, dx and the scales' gradient against autograd through
             the plain version, fp32 (CUDA-core kernel, 2e-3) and bf16
             (the tensor-core kernel's ``QUANT`` epilogue, 2e-2), bf16
             timed beside matmul on the dequantised dense W and the bound;
             ``OvsfDecompressFn`` over them at the converted layer's
             shapes (monolithic codes, L up to 8192). (2) Full-width,
             full-depth TinyLlama-1.1B with int8 alphas, bf16, B 8, S 128,
             remat, ``materialize``, through ``make_train_step`` under
             ``supervisor.run`` for 12 steps, deterministic: a ``fail``
             after the checkpoint at 10 restores it, the replayed step's
             loss bit for bit the first pass's; 220 segmented
             ``ovsf_decompress`` a step (the int8 epilogue), then one step
             under an explicit ``fused`` plan: 220 ``ovsf_gemm``, all int8
             on the tensor-core kernel; the integers unchanged;
             the first batch's loss lower under the trained params (last
             and held-out printed); each step's wall, device busy and idle
             share, peak memory and saves printed. (3) The int4 steps at 4
             layers, the same way. (4) A converted (monolithic int8 / int4) TinyLlama at
             2 layers trained under a ``materialize`` plan: per OVSF linear 2
             ``ovsf_decompress`` (epilogue) and 1 ``fwht`` a step. (5) One
             fp32 step card (an explicit ``fused`` plan) vs CPU
             (``spectral``): TinyLlama at 2 layers, int8 and int4,
             and Zamba2-1.2B at 6, int8: loss 1e-5, gradients and updated
             params 1e-3, integers unchanged. (6) Uncut Whisper-tiny (its
             projections made OVSF, ``WHISPER_STACK_MIN_DIM``) as two
             variants in the gateway's stacked engine (contiguous packed,
             chunk 64), phase 4's 8 requests split between them: fp32
             streams equal dedicated spectral engines'; the bf16 streams,
             step time and ``flash_decode_attn`` launches a step (self
             and cross reads) printed.
  17. materialize: the reference's own ``materialize`` path for the LMs,
             every OVSF layer through the segmented ``ovsf_decompress``
             kernel then one product (its kernel rows in phase 3). (1)
             Full-width TinyLlama-1.1B, bf16, unplanned
             (``LLMEngine(..., use_mapper=False)``: the config's own
             ``exec_path``) in the main path's style (paged, packed, chunk
             64, 4 slots, buffer 256, phase 4's 8 requests), eager and
             replayed: 110 segmented ``ovsf_decompress`` and 22
             ``paged_flash_decode`` a step at 22 layers, no ``ovsf_gemm``;
             streams, chunk-free logits bit for bit, launches and profiled
             kernels equal between the runs; the replayed step's wall,
             busy and idle share beside phase 4's fused step. The same with
             int8 alphas at 22 layers and int4 at ``SERVE_CUT_LAYERS``. (2)
             fp32 at ``MAT_FP32_LAYERS`` layers, replayed: the greedy
             streams equal the planned (``fused``) engine's. (3) One fp32
             packed paged step at ``MAT_PARITY_LAYERS`` layers, card vs CPU
             (the plain version): logits within 1e-3 relative L2.
Before the kernels line it prints each phase's seconds (``[timing]``).
Then it prints the ``kernels`` JSON line, the card line and, last,
``{"ok": true, "device": {...}}``. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # fp32 outside the tensor cores
TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}   # rtol = atol
SPIN_HZ = 2.0e9          # cycles a second at most (H100 SXM boost 1.98 GHz)
FP32_CUDA_CORE_FLOPS = 67e12                     # the WHT's adds
L2_BYTES = 50e6
ALPHA_DTYPES = ("", "int8", "int4")         # bf16/fp32, int8, packed int4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(calls, iters: int) -> float:
    """Mean CUDA-event milliseconds per call, cycling through ``calls``
    (each bound to its own copy of the inputs, so that the copies together
    exceed the L2 cache, as consecutive layers' weights do)."""
    for c in calls[:2]:
        c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        calls[i % len(calls)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, iters: int) -> float:
    """Device milliseconds per call: ``iters`` calls (cycling through
    ``calls``) captured in one CUDA graph and replayed between two events,
    so the host's launch overhead is not in the number. Run ``time_ms``
    first: it warms every call up outside the capture."""
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


def timings(calls, iters: int) -> tuple[float, float]:
    """(device ms per call from graph replay, ms per back-to-back call from
    Python, host overhead included)."""
    call = time_ms(calls, iters)
    return graph_ms(calls, iters), call


def n_copies(bytes_per_call: float) -> int:
    return max(1, min(16, math.ceil(2.4 * L2_BYTES / max(bytes_per_call, 1))))


def bound(bytes_: float, flops: float, dtype) -> tuple[float, str]:
    t_mem = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def check(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs "
                           f"{tuple(w.shape)} or non-finite output")
    err = (g - w).abs()
    tol = TOL[dtype]
    if bool((err > tol + tol * w.abs()).any()):
        raise RuntimeError(f"{name}: max abs err {float(err.max()):.3e} "
                           f"beyond rtol = atol = {tol}")
    return float(err.max())


def exact_and_repeatable(name: str, got: torch.Tensor, err: float,
                         again: torch.Tensor) -> None:
    """The WHT kernels take the plain version's fp32 adds in its order, so
    they must equal it (bf16: one rounding of the same fp32 value), and a
    second launch must equal the first, bit for bit."""
    torch.cuda.synchronize()
    if err != 0.0:
        raise RuntimeError(f"{name}: max abs err {err:.3e}, not 0 (the "
                           "kernel must equal its plain version)")
    if not torch.equal(got, again):
        raise RuntimeError(f"{name}: a second launch differs from the first")


# -- phase 3: kernels --------------------------------------------------------

def gemm_case(rng, seg: int, M: int, K: int, N: int, dtype, dev):
    """Inputs of one ``ovsf_gemm`` call at rho 0.5; segmented code ids differ
    per segment (the init schedule repeats one row in every segment and
    would hide a segment-indexing fault)."""
    L = seg or 1 << (K - 1).bit_length()
    nk = L // 2
    ns = K // seg if seg else 1
    if seg:
        idx = np.stack([np.sort(rng.choice(seg, nk, replace=False))
                        for _ in range(ns)])
    else:
        idx = np.sort(rng.choice(L, nk, replace=False))
    J = ns * nk
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32))
    al = torch.from_numpy(rng.standard_normal((J, N), np.float32))
    al /= math.sqrt(K * nk)
    return (x.to(dev, dtype), al.to(dev, dtype),
            torch.from_numpy(idx.astype(np.int32)).to(dev), nk)


def gemm_row(rng, dev, seg: int, M: int, K: int, N: int, dt,
             alpha_dtype: str, name: str) -> dict:
    """One ``ovsf_gemm`` case held against its plain version: the kernel it
    ran, its error, device and call ms, bound, the plain version's and
    matmul on the dense W's ms."""
    from repro_torch.core.ovsf import quantize_alphas
    from repro_torch.kernels.ovsf_gemm import ovsf_gemm, ovsf_gemm_plain
    from repro_torch.kernels.ref import ovsf_decompress_ref
    x, al, idx, nk = gemm_case(rng, seg, M, K, N, dt, dev)
    scale = None
    if alpha_dtype:
        al, scale = quantize_alphas(al.float(), idx.shape[0] if seg else 1,
                                    alpha_dtype)
    kw = dict(alpha_scale=scale, alpha_dtype=alpha_dtype)
    label = (f"{name} {'seg' if seg else 'mono'} M={M} {K}->{N} "
             f"{str(dt).split('.')[-1]}")
    before = dict(ovsf_gemm.launches_by_kernel)
    got = ovsf_gemm(x, al, idx, **kw)
    kernel = next(k for k, n in ovsf_gemm.launches_by_kernel.items()
                  if n != before[k])
    err = check(label, got, ovsf_gemm_plain(x, al, idx, **kw), dt)
    es = x.element_size()
    bytes_ = ((x.numel() + M * N) * es + al.numel() * al.element_size()
              + idx.numel() * 4 + (scale.numel() * 4 if alpha_dtype else 0))
    gen_macs = K * N * (nk if seg else al.shape[0])
    flops = 2 * M * K * N + 2 * gen_macs
    t_bound, by = bound(bytes_, flops, dt)
    copies = [(torch.randn_like(x), al.clone()) for _ in
              range(n_copies(bytes_))]
    ms, call_ms = timings([lambda a=a, b=b: ovsf_gemm(a, b, idx, **kw)
                           for a, b in copies], 40)
    plain_ms, _ = timings([lambda a=a, b=b: ovsf_gemm_plain(a, b, idx, **kw)
                           for a, b in copies[:2]], 4)
    W = ovsf_decompress_ref(al if alpha_dtype else al.float(), idx, K,
                            **kw).to(dt)
    lib_err = float((torch.matmul(x, W).float()
                     - ovsf_gemm_plain(x, al, idx, **kw).float())
                    .abs().max())
    wcopies = [(a, W.clone()) for a, _ in copies[:n_copies(W.numel() * es)]]
    lib_ms, _ = timings([lambda a=a, w=w: torch.matmul(a, w)
                         for a, w in wcopies], 40)
    del copies, wcopies, W
    row = dict(case=label, seg=seg, M=M, K=K, N=N, dtype=str(dt),
               alpha_dtype=alpha_dtype or "fp", kernel=kernel,
               max_abs_err=err, tol=TOL[dt], ms=ms, call_ms=call_ms,
               plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
               bound_ms=t_bound, bound_by=by)
    print(f"[kernel] {label} ({kernel}): max_abs_err={err:.3e} "
          f"(tol {TOL[dt]}) "
          f"kernel={ms:.4f}ms (per Python call {call_ms:.4f}ms) "
          f"bound={t_bound:.4f}ms ({by}) "
          f"plain={plain_ms:.4f}ms library(matmul, dense W)="
          f"{lib_ms:.4f}ms (its err {lib_err:.1e})", flush=True)
    return row


def run_gemm_checks(rng, dev, alpha_dtype: str = ""):
    """``ovsf_gemm`` with alphas in x's type (``alpha_dtype=""``) or stored
    as int8 / packed int4 with per-segment fp32 scales. The byte bound
    counts the stored alpha bytes (J*N for int8, J*N/2 for int4) plus the
    scales, x, y and idx."""
    layer = {"q": (2048, 2048), "o": (2048, 2048), "gate": (2048, 5632),
             "up": (2048, 5632), "down": (5632, 2048)}
    cases = [(16, M, K, N, dt) for M in (4, 128)
             for (K, N) in ((2048, 2048), (2048, 5632), (5632, 2048))
             for dt in (torch.bfloat16, torch.float32)]
    # the paged window's step: 4 slots x 64 tokens through every projection;
    # bf16 alphas also the legacy prefill's 256 bucket at 4 slots (M 1024)
    cases += [(16, M, K, N, torch.bfloat16)
              for M in ((256,) if alpha_dtype else (256, 1024))
              for (K, N) in ((2048, 2048), (2048, 5632), (5632, 2048))]
    # fp32 x and alphas (the CUDA-core kernel, the fp32 engines' path): also
    # the M 64 of a chunk-free step's packed tokens
    if not alpha_dtype:
        cases += [(16, 64, K, N, torch.float32)
                  for (K, N) in ((2048, 2048), (2048, 5632), (5632, 2048))]
    cases += [(16, 13, 128, 64, dt) for dt in (torch.bfloat16, torch.float32)]
    cases += [(0, 5, 1000, 1000, dt) for dt in (torch.bfloat16, torch.float32)]
    name = "ovsf_gemm" + (f"_{alpha_dtype}" if alpha_dtype else "")
    rows = [gemm_row(rng, dev, seg, M, K, N, dt, alpha_dtype, name)
            for seg, M, K, N, dt in cases]
    # one decode layer's five projections at M = 4 in bf16 (the summary row
    # of the kernels line), and the same at M = 128, 256 and (bf16 alphas)
    # 1024
    summary = {}
    for M in (4, 128, 256) + (() if alpha_dtype else (1024,)):
        pick = {(r["K"], r["N"]): r for r in rows if r["seg"] and r["M"] == M
                and r["dtype"] == "torch.bfloat16"}
        s = {key: sum(pick[kn][key] for kn in layer.values())
             for key in ("ms", "call_ms", "plain_ms", "library_ms",
                         "bound_ms")}
        s["bound_by"] = ("bytes" if all(pick[kn]["bound_by"] == "bytes"
                                        for kn in layer.values())
                         else "operations")
        s["vs_library"] = s["ms"] / s["library_ms"]
        summary[M] = s
        print(f"[kernel] {name} layer (q, o, gate, up, down) M={M} bf16 x: "
              f"{s['ms']:.4f}ms, matmul on dense W {s['library_ms']:.4f}ms "
              f"(x{s['vs_library']:.2f}), bound {s['bound_ms']:.4f}ms",
              flush=True)
    summary = dict(summary[4], layer_M128=summary[128],
                   layer_M256=summary[256], layer_M1024=summary.get(1024))
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    if not alpha_dtype:
        # the CUDA-core kernel: the layer in fp32 at M 4 and 64
        for M in (4, 64):
            pick = {(r["K"], r["N"]): r for r in rows if r["seg"]
                    and r["M"] == M and r["dtype"] == "torch.float32"}
            layer_rows = [pick[kn] for kn in layer.values()]
            if {r["kernel"] for r in layer_rows} != {"cuda_core"}:
                raise RuntimeError(f"{name} fp32 M={M}: kernels "
                                   f"{[r['kernel'] for r in layer_rows]}")
            s = {key: sum(r[key] for r in layer_rows)
                 for key in ("ms", "call_ms", "plain_ms", "library_ms",
                             "bound_ms")}
            s["bound_by"] = max(layer_rows, key=lambda r: r["bound_ms"])[
                "bound_by"]
            s["max_abs_err"] = max(r["max_abs_err"] for r in layer_rows)
            summary[f"fp32_M{M}"] = s
            print(f"[kernel] {name} layer (q, o, gate, up, down) M={M} fp32 "
                  f"x (cuda_core): {s['ms']:.4f}ms, matmul on dense W "
                  f"{s['library_ms']:.4f}ms (x{s['ms'] / s['library_ms']:.2f}"
                  f"), bound {s['bound_ms']:.4f}ms ({s['bound_by']}; "
                  f"{s['bound_ms'] / s['ms']:.0%} of it)", flush=True)
    return rows, summary


def check_quant_contract(dev) -> list:
    """The quantised wrapper refuses, before any launch, what the kernel does
    not take; a refusal must not count as a launch. ``materialize`` of
    segmented codes, bf16 or int4 alphas, runs through the segmented
    ``ovsf_decompress`` kernel: one launch, y the product with the W a
    second launch gives, W within tolerance of the plain version's.
    ``materialize`` of monolithic codes with
    int8 / int4 alphas runs through ``ovsf_decompress``'s epilogue: one
    launch, W equal to the plain version's. ``spectral`` of segmented
    codes is plain tensor code on every device (the multi-model path's
    product, as the reference's jnp): it runs here and must equal the same
    call on the CPU."""
    from repro_torch.core.ovsf import quantize_alphas
    from repro_torch.kernels.ops import ovsf_matmul
    from repro_torch.kernels.ovsf_gemm import (ovsf_decompress,
                                               ovsf_decompress_plain,
                                               ovsf_gemm)
    x = torch.randn((4, 128), device=dev, dtype=torch.bfloat16)
    idx = torch.arange(8, dtype=torch.int32, device=dev).repeat(8, 1)
    q, s = quantize_alphas(torch.randn((64, 64), device=dev), 8, "int4")
    before = ovsf_gemm.launches
    bad = {"bf16 scales": dict(alpha_scale=s.bfloat16()),
           "scales on the CPU": dict(alpha_scale=s.cpu()),
           "alphas on the CPU": dict(alpha_scale=s, alphas=q.cpu()),
           "float alphas": dict(alpha_scale=s, alphas=q.float()),
           "scales that do not tile J": dict(alpha_scale=s[:3].contiguous()),
           "no scales": dict(alpha_scale=None)}
    refused = []
    for what, kw in bad.items():
        alphas = kw.pop("alphas", q)
        try:
            ovsf_gemm(x, alphas, idx, alpha_dtype="int4", **kw)
        except ValueError as e:
            refused.append(f"{what}: {e}")
            continue
        raise RuntimeError(f"ovsf_gemm took {what} without raising")
    if ovsf_gemm.launches != before:
        raise RuntimeError("a refused ovsf_gemm call counted a launch")
    ran = []
    fp_alphas = (torch.randn((64, 64), device=dev) / math.sqrt(8)).bfloat16()
    for what, a, kw in (("int4 alphas over segmented codes", q,
                         dict(alpha_scale=s, alpha_dtype="int4")),
                        ("bf16 alphas over segmented codes", fp_alphas, {})):
        n0 = ovsf_decompress.launches_by_layout["seg"]
        y = ovsf_matmul(x, a, idx, path="materialize", **kw)
        W = ovsf_decompress(a, idx, 128, **kw)
        rel = rel_l2(W, ovsf_decompress_plain(a, idx, 128, **kw))
        torch.cuda.synchronize()
        if (ovsf_decompress.launches_by_layout["seg"] != n0 + 2
                or not torch.equal(y, x @ W.to(x.dtype))
                or not rel <= TOL[W.dtype]):
            raise RuntimeError(f"materialize of {what} on the card: not one "
                               "segmented launch, y not the product with "
                               f"its W, or W {rel:.2e} from the plain "
                               "version")
        ran.append(f"materialize of {what}")
    # monolithic codes with quantised alphas have the decompress kernel's
    # epilogue: they run, W equal to the plain version's, y to the product
    # with it
    mono = torch.from_numpy(np.sort(np.random.default_rng(0).choice(
        128, 64, replace=False)).astype(np.int32)).to(dev)
    for adt in ("int8", "int4"):
        qm, sm = quantize_alphas(torch.randn((64, 64), device=dev), 1, adt)
        n0 = ovsf_decompress.launches
        y = ovsf_matmul(x, qm, mono, path="materialize", alpha_scale=sm,
                        alpha_dtype=adt)
        W = ovsf_decompress_plain(qm, mono, 128, alpha_scale=sm,
                                  alpha_dtype=adt)
        torch.cuda.synchronize()
        if ovsf_decompress.launches != n0 + 1 or not torch.equal(
                y, x @ W.to(x.dtype)) or not torch.equal(
                ovsf_decompress(qm, mono, 128, alpha_scale=sm,
                                alpha_dtype=adt), W):
            raise RuntimeError(f"materialize of monolithic {adt} alphas on "
                               "the card: not one kernel launch equal to "
                               "the plain version")
        ran.append(f"materialize of monolithic {adt} alphas")
    got = ovsf_matmul(x, q, idx, path="spectral", alpha_scale=s,
                      alpha_dtype="int4")
    want = ovsf_matmul(x.cpu(), q.cpu(), idx.cpu(), path="spectral",
                       alpha_scale=s.cpu(), alpha_dtype="int4")
    err = check("spectral of segmented codes on the card", got.cpu(), want,
                torch.bfloat16)
    print(f"[kernel] ovsf_gemm's int4 wrapper refuses: "
          + "; ".join(r.split(":")[0] for r in refused)
          + "; run on the card through ovsf_decompress: " + ", ".join(ran)
          + f"; spectral of segmented codes runs on the card (plain tensor "
          f"code), max_abs_err vs the CPU {err:.3e}", flush=True)
    return refused


def paged_case(rng, T: int, dtype, dev, H=32, Hkv=4, hd=64, ps=16,
               n_slots=4, buffer_len=256):
    """A main-path step: T = 4 is pure decode (one token per slot); T = 128
    mixes two decodes, a 64-token chunk, a 50-token chunk and padding
    tokens. Slots own shuffled pages; ungranted entries and the padding row
    carry the sentinel P."""
    npg = buffer_len // ps
    P = n_slots * npg
    if T == 4:
        segs = [(s, int(rng.integers(0, buffer_len)), 1) for s in range(4)]
    else:
        segs = [(0, 120, 1), (1, 255, 1), (2, 0, 64), (3, 100, 50)]
    sids, poss = [], []
    for s, start, n in segs:
        sids += [s] * n
        poss += list(range(start, start + n))
    n_pad = T - len(sids)
    sids += [n_slots] * n_pad
    poss += [0] * n_pad
    table = np.full((n_slots + 1, npg), P, np.int32)
    perm = rng.permutation(P)
    for s in range(n_slots):
        top = max(p for sid, p in zip(sids, poss) if sid == s)
        granted = top // ps + 1
        table[s, :granted] = perm[s * npg:s * npg + granted]
    q = torch.randn((T, H, hd), device=dev).to(dtype)
    kp = torch.randn((P, ps, Hkv, hd), device=dev).to(dtype)
    vp = torch.randn((P, ps, Hkv, hd), device=dev).to(dtype)
    ints = [torch.tensor(a, dtype=torch.int32, device=dev)
            for a in (table, sids, poss)]
    # what this step's data needs: every (slot, page) some token reads once
    pages = {(s, j) for s, p in zip(sids, poss) if s < n_slots
             for j in range(p // ps + 1)}
    es = q.element_size()
    bytes_ = (2 * len(pages) * ps * Hkv * hd + 2 * q.numel()) * es
    flops = sum(4 * H * hd * (p + 1) for s, p in zip(sids, poss)
                if s < n_slots)
    return (q, kp, vp, *ints), bytes_, flops


def sdpa_inputs(q, kp, vp, table, sids, poss):
    """Pages gathered densely, GQA heads repeated, boolean mask: the inputs
    of the library yardstick (prepared outside its timed region)."""
    T, H, hd = q.shape
    P, ps, Hkv, _ = kp.shape
    pages = table.long()[sids.long()].clamp(0, P - 1)
    S = pages.shape[1] * ps
    k = kp[pages].reshape(T, S, Hkv, hd).transpose(1, 2)
    v = vp[pages].reshape(T, S, Hkv, hd).transpose(1, 2)
    k = k.repeat_interleave(H // Hkv, dim=1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    mask = (torch.arange(S, device=q.device)[None, :]
            <= poss.long()[:, None])[:, None, None, :]
    return q[:, :, None, :], k.contiguous(), v.contiguous(), mask


def run_paged_checks(rng, dev, heads: tuple = (32, 4, 64), name: str = ""):
    """``paged_flash_decode`` vs its plain version at T 4 and 128, bf16 and
    fp32, with ``heads`` = (H, Hkv, hd) (TinyLlama-1.1B's by default;
    ``name`` prefixes the case labels)."""
    from repro_torch.kernels.decode_attn import (paged_flash_decode,
                                                 paged_flash_decode_plain,
                                                 paged_plan, sm_count)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    H, Hkv, hd = heads
    rows = []
    for T in (4, 128):
        for dt in (torch.bfloat16, torch.float32):
            args, bytes_, flops = paged_case(rng, T, dt, dev, H, Hkv, hd)
            label = (f"paged_flash_decode {name}T={T} "
                     + (f"H={H} Hkv={Hkv} hd={hd} " if name else "")
                     + str(dt).split('.')[-1])
            _P, ps, Hkv, _hd = args[1].shape
            _c, splits, blocks = paged_plan(T, args[0].shape[1], Hkv,
                                            args[3].shape[1], ps,
                                            sm_count(dev))
            err = check(label, paged_flash_decode(*args),
                        paged_flash_decode_plain(*args), dt)
            t_bound, by = bound(bytes_, flops, dt)
            pool_bytes = 2 * args[1].numel() * args[1].element_size()
            copies = [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                      for _ in range(n_copies(pool_bytes))]
            ms, call_ms = timings([lambda a=a: paged_flash_decode(*a)
                                   for a in copies], 50)
            plain_ms, _ = timings([lambda a=a: paged_flash_decode_plain(*a)
                                   for a in copies[:2]], 4)
            lib_in = [sdpa_inputs(*a) for a in copies[:2]]
            lib_err = float((sdpa(*lib_in[0][:3], attn_mask=lib_in[0][3])
                             [:, :, 0].float()
                             - paged_flash_decode_plain(*args).float())
                            .abs().max())
            lib_ms, _ = timings([lambda a=a: sdpa(a[0], a[1], a[2],
                                                  attn_mask=a[3])
                                 for a in lib_in], 50)
            del copies, lib_in
            rows.append(dict(case=label, T=T, dtype=str(dt),
                             splits=splits, blocks=blocks,
                             max_abs_err=err, tol=TOL[dt], ms=ms,
                             call_ms=call_ms, plain_ms=plain_ms,
                             library_ms=lib_ms,
                             library_err=lib_err, bound_ms=t_bound,
                             bound_by=by))
            print(f"[kernel] {label}: {splits} splits, {blocks} blocks: "
                  f"max_abs_err={err:.3e} (tol {TOL[dt]}) "
                  f"kernel={ms:.4f}ms (per Python call {call_ms:.4f}ms) "
                  f"bound={t_bound:.4f}ms ({by}) "
                  f"plain={plain_ms:.4f}ms library(SDPA, gathered pages)="
                  f"{lib_ms:.4f}ms (its err {lib_err:.1e})", flush=True)
    summary = dict(next(r for r in rows if r["T"] == 4
                        and r["dtype"] == "torch.bfloat16"))
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return rows, summary


# (label, B, H, Hkv, hd, T, per-row positions; None: drawn in [1, T])
FLASH_CASES = (
    ("window decode", 4, 32, 4, 64, 320, (1, 77, 256, 320)),
    ("window decode, a row at pos 0", 4, 32, 4, 64, 320, (0, 77, 256, 320)),
    ("packed gather", 128, 32, 4, 64, 256, None),
    ("ragged hd 80", 4, 32, 4, 80, 33, (5, 33, 17, 40)))


def flash_case(rng, B, H, Hkv, hd, T, pos, dtype, dev):
    """Inputs of one ``flash_decode_attn`` call, and the bytes and
    operations this call's data needs: q and out once, and for each row
    the K/V rows below its position (all T rows at pos <= 0)."""
    if pos is None:
        pos = rng.integers(1, T + 1, B)
    pos = torch.tensor(np.asarray(pos), dtype=torch.int32, device=dev)
    q = torch.randn((B, H, hd), device=dev).to(dtype)
    k = torch.randn((B, T, Hkv, hd), device=dev).to(dtype)
    v = torch.randn((B, T, Hkv, hd), device=dev).to(dtype)
    rows = sum(T if p <= 0 else min(p, T) for p in pos.tolist())
    es = q.element_size()
    bytes_ = 2 * q.numel() * es + 2 * rows * Hkv * hd * es + 4 * B
    return (q, k, v, pos), bytes_, 4 * rows * H * hd


def flash_sdpa_inputs(q, k, v, pos):
    """GQA heads repeated and the exclusive mask as a boolean: the library
    yardstick's inputs, prepared outside its timed region. A row at pos <= 0
    attends every column (the kernel weighs them all alike; a boolean mask
    cannot say that), so the yardstick's error is taken over rows with
    pos > 0 only."""
    B, H, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kk = k.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    vv = v.transpose(1, 2).repeat_interleave(H // Hkv, dim=1).contiguous()
    p = pos.long()[:, None]
    mask = (torch.arange(T, device=q.device)[None, :] < p) | (p <= 0)
    return q[:, :, None, :], kk, vv, mask[:, None, None, :]


def flash_row(rng, dev, label0: str, B: int, H: int, Hkv: int, hd: int,
              T: int, pos, dt) -> dict:
    """One ``flash_decode_attn`` case held against its plain version: its
    split and block counts, error, device and call ms, bound, the plain
    version's and SDPA's ms."""
    from repro_torch.kernels.decode_attn import (flash_decode_attn,
                                                 flash_decode_attn_plain,
                                                 flash_plan, sm_count)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    args, bytes_, flops = flash_case(rng, B, H, Hkv, hd, T, pos, dt, dev)
    label = (f"flash_decode_attn {label0} B={B} H={H} Hkv={Hkv} "
             f"hd={hd} T={T} {str(dt).split('.')[-1]}")
    _r, splits, blocks = flash_plan(B, H, Hkv, T, sm_count(dev))
    err = check(label, flash_decode_attn(*args),
                flash_decode_attn_plain(*args), dt)
    t_bound, by = bound(bytes_, flops, dt)
    kv_bytes = 2 * args[1].numel() * args[1].element_size()
    copies = [(args[0], args[1].clone(), args[2].clone(), args[3])
              for _ in range(n_copies(kv_bytes))]
    ms, call_ms = timings([lambda a=a: flash_decode_attn(*a)
                           for a in copies], 50)
    plain_ms, _ = timings([lambda a=a: flash_decode_attn_plain(*a)
                           for a in copies[:2]], 4)
    lib_in = [flash_sdpa_inputs(*a) for a in copies[:2]]
    live = args[3] > 0      # see flash_sdpa_inputs
    lib_err = float((sdpa(*lib_in[0][:3], attn_mask=lib_in[0][3])
                     [:, :, 0].float()
                     - flash_decode_attn_plain(*args).float())
                    [live].abs().max())
    lib_ms, _ = timings([lambda a=a: sdpa(a[0], a[1], a[2], attn_mask=a[3])
                         for a in lib_in], 50)
    del copies, lib_in
    print(f"[kernel] {label}: {splits} splits, {blocks} blocks: "
          f"max_abs_err={err:.3e} (tol {TOL[dt]}) "
          f"kernel={ms:.4f}ms (per Python call {call_ms:.4f}ms) "
          f"bound={t_bound:.5f}ms ({by}) "
          f"plain={plain_ms:.4f}ms library(SDPA, boolean mask)="
          f"{lib_ms:.4f}ms (its err {lib_err:.1e})", flush=True)
    return dict(case=label, B=B, H=H, Hkv=Hkv, hd=hd, T=T,
                pos=args[3].tolist(), dtype=str(dt), splits=splits,
                blocks=blocks, max_abs_err=err, tol=TOL[dt], ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_err=lib_err, bound_ms=t_bound, bound_by=by)


def run_flash_checks(rng, dev):
    """``flash_decode_attn`` vs its plain version; the packed path's row
    gather (``cache[slot_ids]`` of K and V, T 128 from B 4, Tbuf 256) timed
    at the mixed bucket."""
    rows = []
    for label0, B, H, Hkv, hd, T, pos in FLASH_CASES:
        for dt in (torch.bfloat16, torch.float32):
            rows.append(flash_row(rng, dev, label0, B, H, Hkv, hd, T, pos,
                                  dt))
        torch.cuda.empty_cache()
    gathers = []
    for dt in (torch.bfloat16, torch.float32):
        ck = torch.randn((4, 256, 4, 64), device=dev).to(dt)
        cv = torch.randn((4, 256, 4, 64), device=dev).to(dt)
        sid = torch.from_numpy(rng.integers(0, 4, 128)).to(dev)
        g_ms, _ = timings([lambda: (ck[sid], cv[sid])], 50)
        # the 4 slots' rows read once, the (128, 256) copy written once
        g_bytes = 2 * (4 + 128) * 256 * 4 * 64 * ck.element_size()
        gathers.append(dict(T=128, Tbuf=256, Hkv=4, hd=64, dtype=str(dt),
                            ms=g_ms, bytes=g_bytes,
                            bound_ms=g_bytes / HBM_BYTES_PER_S * 1e3))
        print(f"[kernel] packed path's K/V row gather T=128 Tbuf=256 "
              f"{str(dt).split('.')[-1]}: {g_ms:.4f}ms per layer "
              f"({g_bytes / 1e6:.1f} MB read once and written, bound "
              f"{g_bytes / HBM_BYTES_PER_S * 1e3:.4f}ms)", flush=True)
    summary = dict(next(r for r in rows if r["case"].startswith(
        "flash_decode_attn window decode B") and "bfloat16" in r["dtype"]))
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return rows, summary, gathers


# shapes that take the attention kernels' other code paths, checked only:
# (T, H, Hkv, hd, page size, pages a slot) paged and (label, B, H, Hkv, hd,
# T, positions) contiguous: G = 3 and G = 1 (idle lanes), G = 18 (three head
# chunks), hd 36 / 20 (rows not whole 16-byte words in bf16: the scalar
# copy), hd 256 (fp32: 128 KB of shared memory), 34-40 splits of one pair
PAGED_SHAPE_CHECKS = ((5, 12, 4, 36, 8, 7), (3, 36, 2, 128, 16, 9),
                      (2, 8, 1, 256, 16, 40), (3, 8, 8, 80, 4, 33),
                      (2, 4, 1, 20, 2, 200))
FLASH_SHAPE_CHECKS = (("every row at pos 0", 4, 32, 4, 64, 320, (0, 0, 0, 0)),
                      ("G 12 hd 20", 3, 48, 4, 20, 100, (100, 3, 0)),
                      ("T 1", 2, 8, 2, 64, 1, (1, 5)),
                      ("one pair, hd 256", 1, 8, 1, 256, 4000, (3999,)),
                      ("hd 36", 2, 16, 2, 36, 50, (50, 9)))


def paged_shape_case(rng, T, H, Hkv, hd, ps, npg, dtype, dev, n_slots=3):
    """Slots own every page of their list; tokens of random slots (padding
    included, at position 0) at random positions."""
    P = n_slots * npg
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[:n_slots] = rng.permutation(P).reshape(n_slots, npg)
    sids = rng.integers(0, n_slots + 1, T).astype(np.int32)
    poss = np.where(sids < n_slots, rng.integers(0, npg * ps, T),
                    0).astype(np.int32)
    q = torch.randn((T, H, hd), device=dev).to(dtype)
    kp = torch.randn((P, ps, Hkv, hd), device=dev).to(dtype)
    vp = torch.randn((P, ps, Hkv, hd), device=dev).to(dtype)
    return (q, kp, vp, *[torch.tensor(a, dtype=torch.int32, device=dev)
                         for a in (table, sids, poss)])


def run_attn_shape_checks(rng, dev) -> list:
    """Both attention kernels against their plain versions at
    ``PAGED_SHAPE_CHECKS`` / ``FLASH_SHAPE_CHECKS``, bf16 and fp32, each
    run twice: the two outputs must be equal bit for bit (the splits merge
    in a fixed order)."""
    from repro_torch.kernels import decode_attn as da
    rows = []
    cases = [("paged_flash_decode", f"T={c[0]} H={c[1]} Hkv={c[2]} hd={c[3]} "
              f"ps={c[4]} npg={c[5]}", c, da.paged_flash_decode,
              da.paged_flash_decode_plain) for c in PAGED_SHAPE_CHECKS]
    cases += [("flash_decode_attn", f"{c[0]} B={c[1]} H={c[2]} Hkv={c[3]} "
               f"hd={c[4]} T={c[5]}", c, da.flash_decode_attn,
               da.flash_decode_attn_plain) for c in FLASH_SHAPE_CHECKS]
    for name, shape, c, fn, plain in cases:
        if name == "paged_flash_decode":
            T, H, Hkv, hd, ps, npg = c
            _c, splits, blocks = da.paged_plan(T, H, Hkv, npg, ps,
                                               da.sm_count(dev))
        else:
            _l, B, H, Hkv, hd, T, pos = c
            _r, splits, blocks = da.flash_plan(B, H, Hkv, T,
                                               da.sm_count(dev))
        for dt in (torch.bfloat16, torch.float32):
            args = (paged_shape_case(rng, *c, dt, dev)
                    if name == "paged_flash_decode"
                    else flash_case(rng, *c[1:], dt, dev)[0])
            label = f"{name} {shape} {str(dt).split('.')[-1]}"
            got = fn(*args)
            err = check(label, got, plain(*args), dt)
            if not torch.equal(got, fn(*args)):
                raise RuntimeError(f"{label}: a second launch differs")
            rows.append(dict(case=label, splits=splits, blocks=blocks,
                             max_abs_err=err, tol=TOL[dt]))
            print(f"[kernel] {label}: {splits} splits, {blocks} blocks: "
                  f"max_abs_err={err:.3e} (tol {TOL[dt]}), a second launch "
                  "equal bit for bit", flush=True)
    return rows


def int8_kv(x: torch.Tensor) -> torch.Tensor:
    """An int8 cache of ``x`` (the reference's static-scale quantiser)."""
    from repro_torch.kernels.ref import quant_like
    return quant_like(x, torch.int8)


def run_int8_attn_checks(rng, dev, paged_rows: list, flash_rows: list):
    """Both attention kernels over int8 K/V (the int8 KV cache) with bf16
    and fp32 q, at the paged T = 4 and 128 shapes and the contiguous window
    decode and packed gather shapes: against the int8 plain version
    (``dequant`` and then the float one), a second launch equal to the
    first; device time, the bound over the int8 bytes, the plain version's
    time, the library call's (SDPA over the K/V dequantised beforehand) and
    the ratio to the same case over a cache of q's type (``paged_rows`` /
    ``flash_rows``, the float checks above)."""
    from repro_torch.kernels import decode_attn as da
    from repro_torch.kernels.ref import dequant
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [("paged_flash_decode", f"T={T}", T) for T in (4, 128)]
    cases += [("flash_decode_attn", c[0], c) for c in FLASH_CASES
              if c[0] in ("window decode", "packed gather")]
    rows = []
    for name, shape, c in cases:
        for dt in (torch.bfloat16, torch.float32):
            if name == "paged_flash_decode":
                args, bytes_, flops = paged_case(rng, c, dt, dev)
                fn, plain = da.paged_flash_decode, \
                    da.paged_flash_decode_int8_plain
                args = (args[0], int8_kv(args[1]), int8_kv(args[2]),
                        *args[3:])
                lib_of = sdpa_inputs
                float_row = next(r for r in paged_rows if r["T"] == c
                                 and r["dtype"] == str(dt))
            else:
                args, bytes_, flops = flash_case(rng, *c[1:], dt, dev)
                fn, plain = da.flash_decode_attn, \
                    da.flash_decode_attn_int8_plain
                args = (args[0], int8_kv(args[1]), int8_kv(args[2]),
                        args[3])
                lib_of = flash_sdpa_inputs
                float_row = next(r for r in flash_rows if r["case"]
                                 .startswith(f"flash_decode_attn {c[0]} B")
                                 and r["dtype"] == str(dt))
            # the float case's bytes with its K/V elements at one byte each:
            # q and out in q's type, pos (contiguous) int32
            es = args[0].element_size()
            q_bytes = 2 * args[0].numel() * es
            pos_bytes = 4 * c[1] if name == "flash_decode_attn" else 0
            bytes8 = q_bytes + pos_bytes + (bytes_ - q_bytes - pos_bytes) // es
            label = f"{name} int8 K/V {shape} {str(dt).split('.')[-1]}"
            got = fn(*args)
            err = check(label, got, plain(*args), dt)
            if not torch.equal(got, fn(*args)):
                raise RuntimeError(f"{label}: a second launch differs")
            t_bound, by = bound(bytes8, flops, dt)
            copies = [(args[0], args[1].clone(), args[2].clone(), *args[3:])
                      for _ in range(n_copies(2 * args[1].numel()))]
            ms, call_ms = timings([lambda a=a: fn(*a) for a in copies], 50)
            plain_ms, _ = timings([lambda a=a: plain(*a)
                                   for a in copies[:2]], 4)
            deq = [(a[0], dequant(a[1], dt), dequant(a[2], dt), *a[3:])
                   for a in copies[:2]]
            lib_in = [lib_of(*a) for a in deq]
            lib_ms, _ = timings([lambda a=a: sdpa(a[0], a[1], a[2],
                                                  attn_mask=a[3])
                                 for a in lib_in], 50)
            del copies, deq, lib_in
            ratio = ms / float_row["ms"]
            rows.append(dict(case=label, dtype=str(dt), max_abs_err=err,
                             tol=TOL[dt], ms=ms, call_ms=call_ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=t_bound, bound_by=by,
                             float_cache_ms=float_row["ms"],
                             vs_float_cache=ratio))
            print(f"[kernel] {label}: max_abs_err={err:.3e} (tol {TOL[dt]}), "
                  f"a second launch equal bit for bit; kernel={ms:.4f}ms "
                  f"(per Python call {call_ms:.4f}ms) bound={t_bound:.5f}ms "
                  f"({by}, int8 K/V bytes) plain={plain_ms:.4f}ms "
                  f"library(SDPA, K/V dequantised beforehand)={lib_ms:.4f}ms;"
                  f" x{ratio:.2f} the {str(dt).split('.')[-1]}-cache kernel "
                  f"({float_row['ms']:.4f}ms)", flush=True)
        torch.cuda.empty_cache()
    pick = lambda n: dict(next(r for r in rows if r["case"].startswith(n)
                               and "bfloat16" in r["dtype"]))
    summaries = {"paged_flash_decode": pick("paged_flash_decode int8 K/V "
                                            "T=4"),
                 "flash_decode_attn": pick("flash_decode_attn int8 K/V "
                                           "window decode")}
    for s in summaries.values():
        s["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return rows, summaries


# -- phase 4: serve ----------------------------------------------------------

# engine style -> LLMEngine arguments besides chunk_size
STYLES = {"paged packed": dict(paged=True, packed=True),
          "contiguous window": dict(),
          "contiguous packed": dict(packed=True),
          "paged window": dict(paged=True)}

def check_fault_free(eng, tag: str, core) -> None:
    """A run that injects no fault must not have recovered: ``LLMEngine``
    turns a step's exception into a core rebuild, so an error that failed
    the run before the watchdog existed would now be retried silently. The
    engine must still hold ``core``, the one the caller set up."""
    st = eng.stats
    if st.recoveries or st.stalls or st.errors or eng.core is not core:
        raise RuntimeError(f"{tag} recoveries={st.recoveries} stalls="
                           f"{st.stalls} errors={st.errors}, core "
                           f"{'kept' if eng.core is core else 'rebuilt'} in "
                           "a run without faults")


def serve_run(params, cfg, dev, style: str, reqs: list, tag: str,
              capture: bool, calibrate: bool, engine_kw=None) -> tuple:
    """One engine in ``style`` (``engine_kw``: the engine's arguments
    besides slots and buffer instead, e.g. the legacy path's) over
    ``reqs``, replaying its step graphs (``capture``) or eager: (engine,
    dict of stats, launch counters zeroed just before, chunk-free step
    count, token streams, each step's (chunk-free, fp32 logits on the host),
    each step's (prefill keys, decoded, launch counters' increase), the
    ``flash_decode_attn`` launches that read every column (cross reads), the
    K/V bytes of the engine's cache and the peak memory the run reserved
    above what was reserved at its start (the params, another engine))."""
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.kernels.decode_attn import (flash_decode_attn,
                                                 paged_flash_decode)
    from repro_torch.serving import LLMEngine
    kw = engine_kw if engine_kw is not None else dict(chunk_size=64,
                                                       **STYLES[style])
    eng = LLMEngine(params, cfg, batch_slots=4, buffer_len=256,
                    calibrate=calibrate, device=dev, capture=capture, **kw)
    steps, per_step = [], []
    core = eng.core
    core_step = core.step

    def recording_step(so, last=None):
        before = wrapper_counts()
        out = core_step(so, last)
        if so.decode_slots or so.chunks or so.prefill_groups:
            steps.append((bool(not so.chunks),
                          eng.core.logits.to("cpu", copy=True)))
        calls = [("prefill_exact", r.prompt_len) if pg.exact
                 else ("prefill", min(pg.bucket, core.T))
                 for pg in so.prefill_groups
                 for _i, r in (pg.slot_reqs if pg.exact
                               else pg.slot_reqs[:1])]
        after = wrapper_counts()
        per_step.append((calls, bool(so.decode_slots or so.chunks),
                         {k: after[k] - before[k] for k in after}))
        return out

    core.step = recording_step
    ptrs = {n: t.data_ptr() for n, t in core.caches.items()}
    G.reset_launches()
    paged_flash_decode.launches = 0
    flash_decode_attn.launches = flash_decode_attn.launches_unmasked = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_reserved(dev)     # params, the other engine
    t0 = time.perf_counter()
    for r in reqs:
        if not eng.submit(r):
            raise RuntimeError(f"{tag} request {r.rid} was rejected")
    stats = eng.run_until_drained(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_fault_free(eng, tag, core)    # every step's logits recorded
    core.step = core_step
    launches = {"ovsf_gemm": G.ovsf_gemm.launches,
                "paged_flash_decode": paged_flash_decode.launches,
                "flash_decode_attn": flash_decode_attn.launches}
    outs = eng.outputs()
    bad = [(o.rid, o.finish_reason) for o in outs
           if o.finish_reason not in ("eos", "length")]
    if len(outs) != len(reqs) or bad:
        raise RuntimeError(f"{tag} {len(outs)} of {len(reqs)} finished; "
                           f"bad={bad}")
    for o in outs:
        if not o.tokens or not all(0 <= t < cfg.vocab for t in o.tokens):
            raise RuntimeError(f"{tag} request {o.rid} tokens {o.tokens}")
    return eng, dict(
        stats=dataclasses.replace(stats), wall=wall, launches=launches,
        by_alpha=dict(G.ovsf_gemm.launches_by_alpha),
        by_kernel=dict(G.ovsf_gemm.launches_by_kernel),
        flash_unmasked=flash_decode_attn.launches_unmasked,
        chunk_free=sum(cf for cf, _l in steps), steps=steps,
        per_step=per_step, tokens={o.rid: list(o.tokens) for o in outs},
        step_shapes=sorted(eng.core.step_shapes),
        graphs=sorted(eng.core.graphs.keys()), core=core,
        kv_bytes=cache_bytes(core.caches),
        moved=[n for n, t in core.caches.items() if t.data_ptr() != ptrs[n]],
        peak_mib=(torch.cuda.max_memory_reserved(dev) - base) / 2**20)


def cache_bytes(caches: dict) -> int:
    """Bytes of an engine's serving cache: the K/V buffers (scratch rows
    included), the recurrent ``conv`` / ``ssm`` states and the cross caches
    ``xk`` / ``xv``, where held."""
    return sum(caches[n].nbytes for n in ("k_rows", "v_rows", "conv", "ssm",
                                          "xk", "xv") if n in caches)


def serve_specs(cfg, seed: int) -> list:
    """The serve phases' 8 requests, (rid, prompt of 8-149 tokens, sampling
    kw): requests 2 and 5 sampled."""
    rng = np.random.default_rng(seed)
    specs = []
    for rid in range(8):
        sp = (dict(temperature=0.8, top_k=40, seed=rid) if rid in (2, 5)
              else {})
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(8, 150)),
                              dtype=np.int32)
        specs.append((rid, prompt, sp))
    return specs


def serve_requests(specs) -> list:
    from repro_torch.serving import Request, SamplingParams
    return [Request(rid, prompt, max_new_tokens=16,
                    sampling=SamplingParams(**sp))
            for rid, prompt, sp in specs]


# the depth the four fp32 style runs serve TinyLlama-1.1B at (full width),
# so that the script with phase 11 stays inside its time limit; their
# checks hold at any depth
SERVE_FP32_LAYERS = 6
# the depth of the bf16 runs with int8 / int4 alphas and of the bf16
# contiguous packed and paged window styles (full width; cut when phase 13
# came): the paged packed run (the main path) and the contiguous window
# (phase 4b's memory yardstick) stay at 22
SERVE_CUT_LAYERS = 6


def serve_phase(seed: int, card: str, dev, alpha_dtype: str = "",
                style: str = "paged packed", dtype: str = "bfloat16",
                n_layers: int = 0):
    """Serve 8 requests at full width (model ``dtype``; ``n_layers`` cuts
    the depth, 0 keeps the config's) with alphas in the
    model's type (``""``), int8 or int4, in one engine style (``STYLES``);
    the engine plans its OVSF layers with the mapper (target h100). The
    same params and requests run twice: eagerly (``capture=False``) and
    replaying the step graphs (the engine's default). Both must give the
    same token streams, every chunk-free step's logits bit for bit, the
    same launch counts (counters over the run, profiler kernels per
    chunk-free step); the graph run holds at most 3 packed and 2 window
    graphs, keyed as ``step_shapes``, and its chunk-free step wall must be
    below eager's."""
    from repro_torch.configs import get_config
    from repro_torch.core.ovsf import alpha_params
    from repro_torch.models import registry as R
    adt = alpha_dtype or "fp"
    kw = STYLES[style]
    x_name = "bf16" if dtype == "bfloat16" else "fp32"
    tag = (f"[serve {alpha_dtype or x_name}"
           + ("]" if style == "paged packed" and dtype == "bfloat16"
              else f" {style}]"))
    cfg = get_config("tinyllama_1_1b").replace(dtype=dtype)
    cfg = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf,
                                               alpha_dtype=alpha_dtype),
                      n_layers=n_layers or cfg.n_layers)
    t0 = time.perf_counter()
    params = R.model_init(cfg, seed, dev)
    torch.cuda.synchronize()
    print(f"{tag} {cfg.name} {x_name}, {cfg.n_layers} layers, alphas "
          f"{alpha_dtype or x_name}: "
          f"{R.param_count(params)/1e9:.3f}B stored values initialised on "
          f"the card in {time.perf_counter() - t0:.2f}s", flush=True)
    # full width: q, o, gate, up, down are OVSF (k/v, 256 wide, are dense)
    block = params["blocks"][0]
    ovsf_layers = {f"{grp}_{k}": p for grp in ("attn", "mlp")
                   for k, p in block[grp].items() if "idx" in p}
    stored = {alpha_params(p)[2] for p in ovsf_layers.values()}
    if stored != {alpha_dtype}:
        raise RuntimeError(f"serve: OVSF layers store {stored} alphas, "
                           f"expected {adt}")
    specs = serve_specs(cfg, seed)
    # the calibration loop rides the bf16 paged packed run
    calibrate = style == "paged packed" and not alpha_dtype and \
        dtype == "bfloat16"
    # both engines stay alive until their profiled windows agree
    runs, engines, walls = {}, {}, {}
    for mode in ("eager", "graph"):
        reqs = serve_requests(specs)
        eng, run = serve_run(params, cfg, dev, style, reqs, f"{tag} {mode}",
                             mode == "graph", calibrate and mode == "graph")
        if mode == "graph":
            plan = {n: p.path for n, p in eng.cfg.exec_plan.entries}
            print(f"{tag} mapper plan (hw {eng.cfg.exec_plan.hw_label}, "
                  "decode at 4 slots): "
                  + ", ".join(f"{n}={p}" for n, p in plan.items()),
                  flush=True)
            if sorted(plan) != sorted(ovsf_layers) or \
                    set(plan.values()) != {"fused"}:
                raise RuntimeError(f"serve: the plan {plan} is not 'fused' "
                                   f"on every OVSF weight type "
                                   f"{sorted(ovsf_layers)}")
            if calibrate:
                calibration = serve_calibration(eng, cfg, run["chunk_free"],
                                                tag)
        runs[mode], engines[mode] = run, eng
        walls[mode] = decode_ready(eng, cfg, np.random.default_rng(seed + 1))
    windows = agreed_windows({m: e.step for m, e in engines.items()},
                             DECODE_STEPS, tag)
    profiles = {m: decode_profile(e, f"{tag} {m}", walls[m], windows[m])
                for m, e in engines.items()}
    for m, e in engines.items():
        check_fault_free(e, f"{tag} {m}", runs[m].pop("core"))
    graph_eng = engines["graph"]
    profiles["graph"]["replay_ms"] = replay_span(
        graph_eng, tuple(profiles["graph"]["step_shapes"][0]))
    del eng, engines, graph_eng
    eager, graph = runs["eager"], runs["graph"]
    launches, by_kernel = graph["launches"], graph["by_kernel"]
    steps = graph["stats"].steps
    if graph["by_alpha"][adt] != launches["ovsf_gemm"]:
        raise RuntimeError(f"serve: ovsf_gemm launched with other alpha "
                           f"storage than {adt}: {graph['by_alpha']}")
    # bf16 x: every ovsf_gemm launch on the tensor-core kernel; fp32 x
    # (segmented codes) on the CUDA-core one
    kernel = "tensor_core" if dtype == "bfloat16" else "cuda_core"
    if by_kernel[kernel] != launches["ovsf_gemm"]:
        raise RuntimeError(f"serve: ovsf_gemm launches by kernel "
                           f"{by_kernel}, expected all "
                           f"{launches['ovsf_gemm']} on {kernel}")
    # the attention kernel of the style: paged steps run the paged kernel
    # at every step; the contiguous packed step runs flash_decode_attn at
    # every step; the contiguous window runs it on chunk-free steps only
    # (steps with chunks attend through the plain S > 1 product)
    n_layers = cfg.n_layers
    attn = ("paged_flash_decode" if kw.get("paged")
            else "flash_decode_attn")
    attn_steps = (steps if kw.get("paged") or kw.get("packed")
                  else graph["chunk_free"])
    want = {"ovsf_gemm": len(ovsf_layers) * n_layers * steps,
            "paged_flash_decode": 0, "flash_decode_attn": 0}
    want[attn] = n_layers * attn_steps
    if launches != want or not want["ovsf_gemm"] or not want[attn]:
        raise RuntimeError(f"serve: launched {launches} in {steps} steps "
                           f"({graph['chunk_free']} chunk-free), expected "
                           f"{want}")
    compare = graph_vs_eager(tag, eager, graph, profiles)
    stats = graph["stats"]
    wall = graph["wall"]
    tok_s = stats.tokens_out / wall
    print(f"{tag} 8/8 finished: steps={steps} chunk_free_steps="
          f"{graph['chunk_free']} tokens={stats.tokens_out} wall={wall:.3f}s "
          f"({tok_s:.1f} tok/s on {card}; eager {eager['wall']:.3f}s) "
          f"decode_s={stats.decode_s:.3f} (eager "
          f"{eager['stats'].decode_s:.3f}) mixed_s={stats.mixed_s:.3f} "
          f"(eager {eager['stats'].mixed_s:.3f}) launches={launches} "
          f"ovsf_gemm by kernel {by_kernel} "
          f"padding_efficiency={stats.padding_efficiency:.3f}", flush=True)
    result = dict(alpha_dtype=adt, dtype=dtype, style=style, plan=plan,
                  steps=steps, chunk_free_steps=graph["chunk_free"],
                  tokens_out=stats.tokens_out, wall_s=wall, tok_s=tok_s,
                  eager_wall_s=eager["wall"], decode_s=stats.decode_s,
                  eager_decode_s=eager["stats"].decode_s,
                  mixed_s=stats.mixed_s,
                  eager_mixed_s=eager["stats"].mixed_s,
                  launches=launches, ovsf_gemm_by_kernel=by_kernel,
                  padding_efficiency=stats.padding_efficiency,
                  tokens=graph["tokens"], graph_vs_eager=compare,
                  kv_bytes=graph["kv_bytes"],
                  decode_profile=profiles["graph"],
                  eager_decode_profile=profiles["eager"])
    if calibrate:
        result["calibration"] = calibration
    del params
    torch.cuda.empty_cache()
    return result, launches


# the legacy phase-based path's engine arguments besides slots and buffer
LEGACY_STYLES = {"bucketed": dict(chunk_size=None),
                 "unbucketed": dict(chunk_size=None, bucketed_prefill=False)}


def ovsf_per_layer(params) -> int:
    """OVSF projections a block runs through ``ovsf_gemm``: its attention
    and MLP linears (TinyLlama-1.1B at full width: q, o, gate, up, down; k
    and v, 256 wide, are dense. OLMoE-1B-7B: q, k, v, o; its expert banks
    are regenerated whole, ``ovsf_banks``)."""
    block = params["blocks"][0]
    return sum("idx" in p for grp in ("attn", "mlp")
               for p in block.get(grp, {}).values())


def ovsf_banks(tree) -> int:
    """OVSF expert banks in a param tree: dicts with ``idx`` and 3-d
    (E, J, d_out) alphas. Each regenerates its dense W once a forward
    under every plan but ``spectral``: one segmented ``ovsf_decompress``
    launch over its E experts (OLMoE-1B-7B: gate, up, down a block)."""
    if isinstance(tree, list):
        return sum(ovsf_banks(t) for t in tree)
    if not isinstance(tree, dict):
        return 0
    al = tree.get("alphas")
    own = int("idx" in tree and al is not None and al.dim() == 3)
    return own + sum(ovsf_banks(v) for v in tree.values())


def check_legacy_steps(tag: str, run: dict, n_layers: int,
                       n_ovsf: int, flash_per_layer: int = 1,
                       n_banks: int = 0) -> None:
    """Every step of a legacy run launched, by the wrappers' counters,
    ``n_ovsf`` x ``n_layers`` ``ovsf_gemm`` a prefill call and a decode
    (TinyLlama-1.1B: 5 x 22 = 110; OLMoE-1B-7B: 4 x 16 = 64), ``n_banks``
    x ``n_layers`` segmented ``ovsf_decompress`` (expert banks: OLMoE's 3
    a layer), ``flash_per_layer`` ``flash_decode_attn`` a layer a decode
    (one; two for an encoder-decoder: self and cross attention; the
    prefill's S > 1 attention is plain ``sdpa``, as in the reference), and
    nothing else."""
    for calls, decoded, delta in run["per_step"]:
        want = {k: 0 for k in delta}
        want["ovsf_gemm"] = n_ovsf * n_layers * (len(calls) + decoded)
        want["ovsf_decompress"] = n_banks * n_layers * (len(calls)
                                                        + decoded)
        want["flash_decode_attn"] = flash_per_layer * n_layers * decoded
        if delta != want:
            raise RuntimeError(f"{tag} a step with prefill calls {calls} and "
                               f"{'a' if decoded else 'no'} decode launched "
                               f"{delta}, expected {want}")


def legacy_pair(params, cfg, dev, specs, label: str, tag: str,
                flash_per_layer: int = 1) -> tuple:
    """The legacy path in ``label``'s mode, eager and replayed, over the
    same requests: streams, every step's logits (prefill-only steps
    included) bit for bit, launch counters, each step's launches
    (``check_legacy_steps``); ``prefill_compiles`` = the prefill keys run;
    each bucket's graph holds K/V Lb columns deep;
    the graphs = the bucketed prefill keys and ``("decode", 1)`` (an exact
    prefill runs eagerly: a graph per prompt length would grow with the
    traffic)."""
    runs, engines = {}, {}
    for mode in ("eager", "graph"):
        eng, run = serve_run(params, cfg, dev, label, serve_requests(specs),
                             f"{tag} {mode}", mode == "graph", False,
                             engine_kw=LEGACY_STYLES[label])
        check_legacy_steps(f"{tag} {mode}", run, cfg.n_layers,
                           ovsf_per_layer(params), flash_per_layer,
                           ovsf_banks(params["blocks"][0]))
        runs[mode], engines[mode] = run, eng
    eager, graph = runs["eager"], runs["graph"]
    if graph["tokens"] != eager["tokens"]:
        raise RuntimeError(f"{tag} graph streams differ from eager's")
    equal = [torch.equal(g, e) for (_c, g), (_d, e)
             in zip(graph["steps"], eager["steps"])]
    if len(graph["steps"]) != len(eager["steps"]) or not all(equal):
        raise RuntimeError(f"{tag} step logits bit-equal to eager in "
                           f"{sum(equal)} of {len(eager['steps'])} steps")
    tensor_core = graph["by_kernel"]["tensor_core"]
    if graph["launches"] != eager["launches"] or \
            graph["by_kernel"] != eager["by_kernel"] or \
            graph["flash_unmasked"] != eager["flash_unmasked"] or \
            tensor_core != graph["launches"]["ovsf_gemm"]:
        raise RuntimeError(f"{tag} launches: graph {graph['launches']} "
                           f"{graph['by_kernel']}, eager {eager['launches']} "
                           f"{eager['by_kernel']}")
    keys = [tuple(k) for k in graph["graphs"]]
    prefill = sorted({k for calls, _d, _l in graph["per_step"]
                      for k in calls})
    captured = {k for k in prefill if k[0] == "prefill"}
    entries = engines["graph"].core.graphs._entries
    deep = {k: tuple(entries[k].outputs[n].shape[2] for n in (2, 3))
            for k in captured}
    if any(d != (k[1], k[1]) for k, d in deep.items()):
        raise RuntimeError(f"{tag} a bucket's graph holds K/V columns "
                           f"{deep}, not its Lb")
    if set(keys) != captured | {("decode", 1)} or \
            (label == "bucketed") != bool(captured) or \
            graph["step_shapes"] != [("decode", 1)] or \
            graph["stats"].prefill_compiles != len(prefill) or \
            (label == "bucketed" and len(prefill) > 6):
        raise RuntimeError(f"{tag} graphs {keys}, step shapes "
                           f"{graph['step_shapes']}, prefill_compiles "
                           f"{graph['stats'].prefill_compiles}")
    return runs, engines, prefill


def graphs_held_mib(eng, dev) -> float:
    """MiB the engine's graphs hold: ``memory_reserved`` before and after
    dropping every graph with its pool (the engine is discarded next)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    eng.core.graphs.clear()
    return (before - torch.cuda.memory_reserved(dev)) / 2**20


# a legacy run's reserved memory over the contiguous window's (phase 4's,
# same slots, buffer and requests): a bucketed prefill's call is B x 256
# tokens at the 256 bucket where a window step is B x 64 (4x the
# activations), and the buckets' graphs keep their (B, Lb) caches besides
# (sum of Lb = 480 columns: 1.9x the live cache); an unbucketed run holds
# the decode graph only
LEGACY_MEMORY = {"bucketed": 5.0, "unbucketed": 1.0}


def reserved_growth(eng, cfg, dev, lengths: list, seed: int) -> tuple:
    """Serve requests of new prompt lengths (``lengths``, 4 new tokens
    each) on a replayed legacy engine that has served before: (MiB
    ``memory_reserved`` grew by, graphs captured meanwhile). Lengths in
    the buckets already captured, or exact ones (run eagerly), must leave
    both at nothing: what the graphs keep does not grow with traffic."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    keys = set(eng.core.graphs.keys())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(dev)
    for i, n in enumerate(lengths):
        if not eng.submit(Request(100 + i, rng.integers(0, cfg.vocab, n,
                                                         dtype=np.int32),
                                  max_new_tokens=4)):
            raise RuntimeError(f"a request of {n} prompt tokens rejected")
    eng.run_until_drained(max_steps=1000)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ((torch.cuda.memory_reserved(dev) - before) / 2**20,
            sorted(set(eng.core.graphs.keys()) - keys))


def legacy_memory_gate(tag: str, label: str, out: dict, window: dict
                       ) -> dict:
    """The replayed run's reserved memory (its K/V cache and the peak
    reserved above the run's start: graphs' pools, activations) at most
    ``LEGACY_MEMORY[label]`` x the contiguous window run's."""
    win = (window["kv_bytes"] / 2**20
           + window["graph_vs_eager"]["peak_mib"])
    got = out["kv_bytes"] / 2**20 + out["peak_mib"]
    print(f"{tag} reserved memory: K/V {out['kv_bytes'] / 2**20:.1f} MiB + "
          f"peak above the run's start {out['peak_mib']:.1f} MiB (eager "
          f"{out['eager_peak_mib']:.1f}) = {got:.1f} MiB, the graphs hold "
          f"{out['graphs_mib']:.1f} MiB; the contiguous window's "
          f"{win:.1f} MiB (ratio {got / win:.3f}, limit "
          f"{LEGACY_MEMORY[label]})", flush=True)
    if got > LEGACY_MEMORY[label] * win:
        raise RuntimeError(f"{tag} reserves {got:.1f} MiB, more than "
                           f"{LEGACY_MEMORY[label]} x the contiguous "
                           f"window's {win:.1f} MiB")
    return dict(reserved_mib=got, window_reserved_mib=win)


def legacy_phase(seed: int, card: str, dev, paged_bf16: dict,
                 window_bf16: dict) -> dict:
    """Phase 4b (module docstring): the legacy phase-based path at full
    width in bf16, bucketed and unbucketed, eager and replayed, its
    reserved memory held against the contiguous window's (``window_bf16``:
    phase 4's run of that style); then the int8 KV cache in the legacy and
    the paged packed engines (replayed), held against the bf16-cache runs
    (``paged_bf16``: phase 4's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    cfg = get_config("tinyllama_1_1b")
    params = R.model_init(cfg, seed, dev)
    specs = serve_specs(cfg, seed)
    res = {}
    for label in LEGACY_STYLES:
        tag = f"[legacy {label}]"
        runs, engines, prefill = legacy_pair(params, cfg, dev, specs, label,
                                             tag)
        graph, eager = runs["graph"], runs["eager"]
        out = dict(tokens=graph["tokens"], launches=graph["launches"],
                   steps=len(graph["per_step"]),
                   prefill_calls=sum(len(c) for c, _d, _l
                                     in graph["per_step"]),
                   prefill_keys=[list(k) for k in prefill],
                   prefill_s=graph["stats"].prefill_s,
                   eager_prefill_s=eager["stats"].prefill_s,
                   decode_s=graph["stats"].decode_s,
                   eager_decode_s=eager["stats"].decode_s,
                   wall_s=graph["wall"], eager_wall_s=eager["wall"],
                   kv_bytes=graph["kv_bytes"], peak_mib=graph["peak_mib"],
                   eager_peak_mib=eager["peak_mib"])
        if label == "bucketed":
            walls = {m: decode_ready(e, cfg, np.random.default_rng(seed + 1))
                     for m, e in engines.items()}
            windows = agreed_windows({m: e.step for m, e in engines.items()},
                                     DECODE_STEPS, tag)
            profiles = {m: decode_profile(e, f"{tag} {m}", walls[m],
                                          windows[m])
                        for m, e in engines.items()}
            pg, pe = profiles["graph"], profiles["eager"]
            if pg["own"] != pe["own"] or \
                    pg["kernels_per_step"] != pe["kernels_per_step"]:
                diff = ("not measured" if pg["by_name"] is None
                        else count_diff(pg["by_name"], pe["by_name"]))
                raise RuntimeError(f"{tag} profiled decode steps: graph "
                                   f"{pg['own']} {pg['kernels_per_step']}, "
                                   f"eager {pe['own']} "
                                   f"{pe['kernels_per_step']}; kernels "
                                   f"whose counts differ: {diff}")
            out["decode_profile"], out["eager_decode_profile"] = pg, pe
            out["decode_replay_ms"] = replay_span(engines["graph"],
                                                  ("decode", 1))
            prefill = sorted(k for k in engines["graph"].core.graphs.keys()
                             if k[0] == "prefill")
        out["prefill_replay_ms"] = {f"{k[0]} {k[1]}": replay_span(
            engines["graph"], k) for k in prefill if k[0] == "prefill"}
        out["prefill_ms_a_call"] = 1e3 * out["prefill_s"] / \
            out["prefill_calls"]
        first = {len(p) for _r, p, _s in specs}
        buckets = [k[1] for k in engines["graph"].core.graphs.keys()
                   if k[0] == "prefill"]
        # in the buckets captured (bucketed), or new exact lengths
        lengths = sorted({n for n in ([b - 8 for b in buckets]
                                      + [b // 2 + 2 for b in buckets]
                                      if buckets else
                                      [n + 1 for n in first])
                          if n not in first})
        out["growth_mib"], new = reserved_growth(engines["graph"], cfg, dev,
                                                 lengths, seed + 5)
        print(f"{tag} {len(lengths)} more requests of new prompt lengths "
              f"{lengths}: memory_reserved grew {out['growth_mib']:.1f} MiB"
              f" (limit 2), graphs captured {new}", flush=True)
        if abs(out["growth_mib"]) > 2 or new or not lengths:
            raise RuntimeError(f"{tag} reserved memory grew "
                               f"{out['growth_mib']:.1f} MiB over new "
                               f"prompt lengths, graphs {new}")
        for m, e in engines.items():
            check_fault_free(e, f"{tag} {m}", runs[m]["core"])
        out["graphs_mib"] = graphs_held_mib(engines["graph"], dev)
        out.update(legacy_memory_gate(tag, label, out, window_bf16))
        del engines, runs
        torch.cuda.empty_cache()
        print(f"{tag} 8/8 finished, streams, logits ({out['steps']} steps) "
              f"and launches equal eager vs replayed; {out['prefill_calls']} "
              f"prefill calls over {len(out['prefill_keys'])} keys "
              f"{out['prefill_keys']}; launches {out['launches']} (110 "
              "ovsf_gemm a prefill call and a decode, 22 flash_decode_attn "
              f"a decode); wall {out['wall_s']:.3f}s (eager "
              f"{out['eager_wall_s']:.3f}s), prefill_s "
              f"{out['prefill_s']:.3f} (eager {out['eager_prefill_s']:.3f}),"
              f" decode_s {out['decode_s']:.3f} (eager "
              f"{out['eager_decode_s']:.3f}); host ms a prefill call "
              f"{out['prefill_ms_a_call']:.3f}; device ms a prefill replay:"
              f" " + (", ".join(f"{k} {v:.3f}" for k, v in
                                out["prefill_replay_ms"].items())
                      or "none (exact prefills run eagerly)")
              + (f"; decode step: wall {out['decode_profile']['step_ms']:.3f}"
                 f" ms (eager {out['eager_decode_profile']['step_ms']:.3f}), "
                 f"a replay spans {out['decode_replay_ms']:.3f} ms, device "
                 f"busy {out['decode_profile']['busy_ms']}, idle share "
                 f"{out['decode_profile']['idle_share']}"
                 if "decode_profile" in out else "") + f" ({card})",
              flush=True)
        res[label] = out
    res["window_reserved_mib"] = res["bucketed"]["window_reserved_mib"]
    res["int8"] = int8_kv_runs(params, cfg, dev, specs, res["bucketed"],
                               paged_bf16)
    del params
    torch.cuda.empty_cache()
    return res


def int8_kv_runs(params, cfg, dev, specs, legacy_bf16: dict,
                 paged_bf16: dict) -> dict:
    """The int8 KV cache at full width, replayed: the legacy path (bucketed)
    and the paged packed engine, each over the bf16-cache run's requests:
    every request finishes, the launch counters equal the bf16-cache run's,
    the cache's K/V bytes are half of it; the legacy decode step is
    profiled (its own kernels, int8 instances of ``flash_decode_kernel``
    among them, equal to the wrappers' counters)."""
    c8 = cfg.replace(kv_cache_dtype="int8")
    out = {}
    for label, style, kw, bf16 in (
            ("legacy", "bucketed", LEGACY_STYLES["bucketed"], legacy_bf16),
            ("paged packed", "paged packed", None, paged_bf16)):
        tag = f"[int8 kv {label}]"
        eng, run = serve_run(params, c8, dev, style, serve_requests(specs),
                             tag, True, False, engine_kw=kw)
        if eng.core.caches["k"].dtype != torch.int8:
            raise RuntimeError(f"{tag} cache is {eng.core.caches['k'].dtype}")
        if label == "legacy":
            check_legacy_steps(tag, run, cfg.n_layers, ovsf_per_layer(params))
        if run["launches"] != bf16["launches"] or \
                2 * run["kv_bytes"] != bf16["kv_bytes"]:
            raise RuntimeError(f"{tag} launches {run['launches']} and K/V "
                               f"bytes {run['kv_bytes']}; the bf16 cache's "
                               f"{bf16['launches']}, {bf16['kv_bytes']}")
        res = dict(launches=run["launches"], kv_bytes=run["kv_bytes"],
                   bf16_kv_bytes=bf16["kv_bytes"], wall_s=run["wall"],
                   tokens_equal_bf16=sum(run["tokens"][r] == bf16["tokens"][r]
                                         for r in run["tokens"]))
        if label == "legacy":
            wall = decode_ready(eng, c8, np.random.default_rng(7))
            windows = agreed_windows({"graph": eng.step}, DECODE_STEPS, tag,
                                     least=1)
            res["decode_profile"] = decode_profile(eng, tag, wall,
                                                   windows["graph"])
        check_fault_free(eng, tag, run["core"])
        print(f"{tag} 8/8 finished; launches {run['launches']} equal the "
              f"bf16 cache's; K/V {run['kv_bytes'] / 2**20:.1f} MiB, half "
              f"the bf16 cache's {bf16['kv_bytes'] / 2**20:.1f} MiB; "
              f"{res['tokens_equal_bf16']} of 8 streams equal the bf16 "
              f"cache's; wall {run['wall']:.3f}s", flush=True)
        out[label] = res
        del eng, run
        torch.cuda.empty_cache()
    return out


def legacy_fp32_checks(seed: int, dev) -> dict:
    """fp32, full width: the reference's single-slot anchor (at one slot,
    where no slot is reused, the legacy stream equals the packed one); card
    vs CPU ``serve_prefill_ragged`` (``prefill_parity``) and the int8 steps
    (``int8_step_parity``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.serving import LLMEngine, Request, plan_cfg
    cfg = get_config("tinyllama_1_1b").replace(dtype="float32")
    params = R.model_init(cfg, seed + 3, dev)
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab, n, dtype=np.int32)
               for n in (20, 77, 140)]
    streams = {}
    for label, kw in (("legacy", dict()),
                      ("packed", dict(chunk_size=64, packed=True))):
        eng = LLMEngine(params, cfg, batch_slots=1, buffer_len=256,
                        device=dev, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(Request(rid, p, max_new_tokens=6))
        eng.run_until_drained()
        streams[label] = {o.rid: list(o.tokens) for o in eng.outputs()}
        del eng
    if len(streams["legacy"]) != 3 or streams["legacy"] != streams["packed"]:
        raise RuntimeError(f"[legacy fp32] single-slot streams: legacy "
                           f"{streams['legacy']}, packed {streams['packed']}")
    cfg = plan_cfg(cfg, 4, dev)
    cpu_params = R.params_to(params, "cpu")
    res = dict(single_slot_streams_equal=True,
               prefill=prefill_parity(params, cpu_params, cfg, dev, rng),
               int8_steps=int8_step_parity(params, cpu_params, cfg, dev,
                                           rng))
    print(f"[legacy fp32] single slot: legacy streams equal the packed "
          f"engine's for 3 requests (20, 77, 140 prompt tokens)", flush=True)
    del params, cpu_params
    torch.cuda.empty_cache()
    return res


def one_step_apart(a: torch.Tensor, b: torch.Tensor, tag: str) -> int:
    """Entries of two int8 caches that differ: each by one step of the
    quantiser at most (a K or V value on a .5 boundary in one device's fp32
    and not in the other's)."""
    d = (a.cpu().int() - b.cpu().int()).abs()
    if int(d.max()) > 1:
        raise RuntimeError(f"{tag} int8 caches {int(d.max())} steps apart")
    return int((d > 0).sum())


def prefill_parity(params, cpu_params, cfg, dev, rng) -> dict:
    """Card vs CPU ``serve_prefill_ragged`` at a (4, 64) bucket, into a
    cache 64 deep as the engine prefills, logits within 1e-3 relative L2:
    over an fp32 cache; over an int8 cache with the CPU fed the card's
    quantised K/V layer by layer (``fed_quant``), so both read the same
    int8 cache in every layer and the comparison holds the card's int8
    prefill to the limit. Every K/V a prefill writes is quantised and read
    back within the call: a value one fp32 rounding from a .5 boundary
    quantises one step apart on the two devices and moves by 1/15.875, and
    the network would carry that on from layer to layer. Printed beside
    it: the CPU's own prefill (its own quantisation, not gated), and the
    entries where the CPU's quantisation of a layer's K/V, from inputs
    that differ by the card's fp32 rounding alone, is one step from the
    card's (each at most one)."""
    from repro_torch.models import attention as A
    from repro_torch.models import registry as R
    tokens = rng.integers(0, cfg.vocab, (4, 64)).astype(np.int32)
    lengths = np.array([64, 9, 33, 1], np.int32)
    out = {}

    def prefill(p, c, d):
        with torch.no_grad():
            return R.serve_prefill_ragged(
                p, c, torch.from_numpy(tokens).to(d), 64,
                torch.from_numpy(lengths).to(d))

    def rel_err(a, b):
        a, b = a.float().cpu(), b.float()
        return float((a - b).norm() / b.norm())

    for label, c in (("fp32 cache", cfg),
                     ("int8 cache", cfg.replace(kv_cache_dtype="int8"))):
        card = prefill(params, c, dev)
        if not torch.isfinite(card[0]).all():
            raise RuntimeError(f"[legacy fp32] prefill {label}: non-finite")
        if not c.kv_cache_dtype:
            res = dict(rel_err=rel_err(card[0],
                                       prefill(cpu_params, c, "cpu")[0]))
        else:
            own = prefill(cpu_params, c, "cpu")
            fed, apart = fed_quant(card[1]), [0]
            real = A.quant_like

            def quant(x, dtype):
                got = fed(x, dtype)
                apart[0] += one_step_apart(real(x, dtype), got,
                                           "[legacy fp32] prefill")
                return got
            A.quant_like = quant
            try:
                fedl = prefill(cpu_params, c, "cpu")
            finally:
                A.quant_like = real
            if not all(torch.equal(fedl[1][n], card[1][n].cpu())
                       for n in ("k", "v")):
                raise RuntimeError("[legacy fp32] prefill int8 cache: the "
                                   "fed CPU cache differs from the card's")
            res = dict(rel_err=rel_err(card[0], fedl[0]),
                       own_rel_err=rel_err(card[0], own[0]),
                       one_step_apart=apart[0],
                       entries=2 * card[1]["k"].numel())
        out[label] = res
        print(f"[legacy fp32] serve_prefill_ragged (4, 64), {label}: card vs"
              f" CPU logits rel L2 err={res['rel_err']:.3e} (limit 1e-3"
              + (f"; the CPU fed the card's int8 K/V layer by layer; with "
                 f"its own quantisation {res['own_rel_err']:.3e}, not "
                 f"gated: {res['one_step_apart']} of {res['entries']} int8 "
                 "cache entries one quantiser step apart"
                 if c.kv_cache_dtype else "") + ")", flush=True)
        if res["rel_err"] > 1e-3:
            raise RuntimeError(f"[legacy fp32] prefill {label}: card vs CPU "
                               f"rel L2 {res['rel_err']:.3e} > 1e-3")
    return out


def fed_quant(cache: dict):
    """``quant_like`` for a prefill's writes, which come k then v a layer
    (``attention.attn_apply``): each returns the layer's K or V from
    ``cache`` (the card's, on the CPU) in place of its own quantisation."""
    n_layers = cache["k"].shape[0]
    rows = iter([cache[n][li].cpu() for li in range(n_layers)
                 for n in ("k", "v")])

    def quant(x, dtype):
        got = next(rows)
        if got.shape != x.shape or got.dtype != dtype:
            raise RuntimeError(f"[legacy fp32] fed K/V {tuple(got.shape)} "
                               f"{got.dtype} for {tuple(x.shape)} {dtype}")
        return got
    return quant


def int8_step_parity(params, cpu_params, cfg, dev, rng) -> dict:
    """Card vs CPU steps over the same int8 caches (random values, given to
    both devices): the contiguous ``serve_step`` (22 int8
    ``flash_decode_attn`` launches on the card; rows at pos 100, 77, 255
    and an idle row at 300) and a paged decode step (4 tokens at 120, 200,
    64, 255; 22 int8 ``paged_flash_decode`` launches); logits within 1e-3
    relative L2, the rows each writes at most one quantiser step apart
    (counted). Every token attends over a long context: a token at pos 0
    attends its own freshly quantised row alone, so a value one fp32
    rounding from a .5 boundary, quantised one step apart on the two
    devices, moves that token's attention output by a whole step (1/15.875)
    undiluted, and the random-weight network carries it on (the prefill
    above shows how far)."""
    from repro_torch.kernels.decode_attn import (flash_decode_attn,
                                                 paged_flash_decode)
    from repro_torch.kernels.ref import quant_like
    from repro_torch.models import registry as R
    c = cfg.replace(kv_cache_dtype="int8")
    nl, Hkv, hd, B = c.n_layers, c.n_kv_heads, c.hd, 4

    def kv8(shape):
        x = torch.from_numpy(rng.standard_normal(shape, np.float32) * 2)
        return quant_like(x, torch.int8)

    cont = dict(k=kv8((nl, B, 256, Hkv, hd)), v=kv8((nl, B, 256, Hkv, hd)),
                pos=torch.tensor([100, 77, 255, 300], dtype=torch.int32),
                tokens=torch.from_numpy(rng.integers(0, c.vocab, (B, 1))
                                        .astype(np.int32)))
    P, ps, npg = 64, 16, 16
    table = np.full((B + 1, npg), P, np.int32)
    table[:B] = rng.permutation(P).reshape(B, npg)
    poss = np.array([120, 200, 64, 255], np.int32)
    paged = dict(k=kv8((nl, P, ps, Hkv, hd)), v=kv8((nl, P, ps, Hkv, hd)),
                 host=[table, rng.integers(0, c.vocab, B).astype(np.int32),
                       np.arange(B, dtype=np.int32), poss, poss + 1,
                       np.arange(B, dtype=np.int32)])

    def run(p, d):
        put = lambda t: t.clone().to(d)
        with torch.no_grad():
            flash_decode_attn.launches = paged_flash_decode.launches = 0
            cache = {n: put(cont[n]) for n in ("k", "v", "pos")}
            l1, _ = R.serve_step(p, c, cache, put(cont["tokens"]))
            pc = {"k": put(paged["k"]), "v": put(paged["v"]),
                  "pos": torch.zeros(B, dtype=torch.int32, device=d)}
            l2, _ = R.serve_step_paged(
                p, c, pc, *(torch.from_numpy(a).to(d) for a in paged["host"]))
        return ((l1.float().cpu(), l2.float().cpu()), (cache, pc),
                (flash_decode_attn.launches, paged_flash_decode.launches))

    gl, gc, n = run(params, dev)
    hl, hc, _ = run(cpu_params, torch.device("cpu"))
    rel = [float((g - h).norm() / h.norm()) for g, h in zip(gl, hl)]
    print(f"[int8 steps] card vs CPU logits rel L2 err {rel}", flush=True)
    apart = sum(one_step_apart(a[k], b[k], "[int8 steps]")
                for a, b in zip(gc, hc) for k in ("k", "v"))
    print(f"[int8 steps] fp32, full width, the same int8 caches on both "
          f"devices: card vs CPU logits rel L2 err serve_step={rel[0]:.3e}, "
          f"serve_step_paged={rel[1]:.3e} (limit 1e-3); launches on the card"
          f" (flash_decode_attn, paged_flash_decode) {n}; {apart} cache "
          "entries one quantiser step apart", flush=True)
    if max(rel) > 1e-3 or n != (nl, nl) or not all(
            torch.isfinite(g).all() for g in gl):
        raise RuntimeError(f"[int8 steps] rel L2 {rel}, launches {n}")
    return dict(rel_err=rel, launches=list(n), one_step_apart=apart)


def replay_span(eng, key: tuple, n: int = 10) -> float:
    """Device ms of one replay of the chunk-free step's graph ``key``,
    between CUDA events over n back-to-back replays: its kernels and the
    gaps between them, without the step's host work. The replays rerun the
    last step (a window step advances ``pos`` by its n_tok each time, well
    inside the buffer) on an engine about to be discarded."""
    g = eng.core.graphs._entries[key].graph
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_vs_eager(tag: str, eager: dict, graph: dict, profiles: dict,
                   wall_gate: bool = True) -> dict:
    """The graph run against the eager one: token streams equal (greedy
    and sampled), every chunk-free step's logits bit for bit (mixed steps
    counted), launch counters equal, at most 3 packed and 2 window graphs
    keyed as ``step_shapes``, profiler launches of each hand-written kernel
    over the profiled chunk-free steps equal (and equal to the wrappers'
    counters), all kernels per step equal, and (``wall_gate``) the
    chunk-free step wall below eager's (printed only otherwise: a step the
    device holds for most of its wall, as a MoE step, replays in about
    eager's wall, and a host clock then orders the two by chance)."""
    if graph["tokens"] != eager["tokens"]:
        diff = [r for r in eager["tokens"]
                if graph["tokens"].get(r) != eager["tokens"][r]]
        raise RuntimeError(f"{tag} graph streams differ from eager for "
                           f"requests {diff}")
    flags = [cf for cf, _l in graph["steps"]]
    if flags != [cf for cf, _l in eager["steps"]]:
        raise RuntimeError(f"{tag} graph and eager runs took other steps")
    equal = [torch.equal(g, e) for (_c, g), (_d, e)
             in zip(graph["steps"], eager["steps"])]
    free = [eq for cf, eq in zip(flags, equal) if cf]
    mixed = [eq for cf, eq in zip(flags, equal) if not cf]
    if not free or not all(free):
        raise RuntimeError(f"{tag} chunk-free step logits bit-equal to "
                           f"eager in {sum(free)} of {len(free)} steps")
    if graph["launches"] != eager["launches"] or \
            graph["by_kernel"] != eager["by_kernel"]:
        raise RuntimeError(f"{tag} launches: graph {graph['launches']} "
                           f"{graph['by_kernel']}, eager {eager['launches']} "
                           f"{eager['by_kernel']}")
    keys, shapes = graph["graphs"], graph["step_shapes"]
    n_packed = sum(k == "packed" for k, _n in keys)
    if keys != shapes or n_packed > 3 or len(keys) - n_packed > 2:
        raise RuntimeError(f"{tag} graphs {keys}, step_shapes {shapes}: "
                           "at most 3 packed and 2 window graphs, one a "
                           "step shape")
    pg, pe = profiles["graph"], profiles["eager"]
    # the hand-written kernels, by name over the profiled window (each
    # mode's also equal to its wrappers' counters: ``check_own``), and all
    # kernels per step, exactly; the names whose counts differ are printed
    if (pg["own"] is None) != (pe["own"] is None) or pg["own"] != pe["own"] \
            or pg["wrappers"] != pe["wrappers"]:
        raise RuntimeError(f"{tag} profiler launches of the hand-written "
                           f"kernels: graph {pg['own']}, eager {pe['own']};"
                           f" wrappers graph {pg['wrappers']}, eager "
                           f"{pe['wrappers']}")
    diff = ("not measured" if pg["by_name"] is None
            else count_diff(pg["by_name"], pe["by_name"]))
    if pg["kernels_per_step"] != pe["kernels_per_step"]:
        raise RuntimeError(f"{tag} profiler kernels per chunk-free step: "
                           f"graph {pg['kernels_per_step']}, eager "
                           f"{pe['kernels_per_step']}; differing: {diff}")
    if wall_gate and not pg["step_ms"] < pe["step_ms"]:
        raise RuntimeError(f"{tag} chunk-free step wall {pg['step_ms']:.3f}"
                           f" ms replayed, not below eager's "
                           f"{pe['step_ms']:.3f}")
    idle = {m: ("not measured" if p["idle_share"] is None
                else f"{p['idle_share']:.3f}") for m, p in profiles.items()}
    # the replayed step's idle time by cause: gaps inside the graph (its
    # span less the kernels' busy time) and host work (wall less span)
    span = pg["replay_ms"]
    gaps = ("not measured" if pg["busy_ms"] is None
            else f"{span - pg['busy_ms']:.3f} ms")
    print(f"{tag} graph vs eager: token streams equal ({len(eager['tokens'])}"
          f" requests, 2 sampled); logits bit-equal in {sum(free)} of "
          f"{len(free)} chunk-free steps and {sum(mixed)} of {len(mixed)} "
          f"mixed steps; launches equal {graph['launches']}; "
          f"{len(keys)} graphs captured {keys} (step_shapes {shapes}); "
          f"chunk-free step wall {pg['step_ms']:.3f} ms (eager "
          f"{pe['step_ms']:.3f}), idle share {idle['graph']} (eager "
          f"{idle['eager']}), kernels per step {pg['kernels_per_step']} "
          f"(eager {pe['kernels_per_step']}) over {pg['windows']} profiled "
          f"windows each; in {DECODE_STEPS} profiled steps the "
          f"hand-written kernels by name {pg['own']} (eager equal), the "
          f"wrappers' counters {pg['wrappers']} (eager equal), kernels whose "
          f"counts differ: {diff}; peak reserved above the run's start "
          f"{graph['peak_mib']:.0f} MiB (eager {eager['peak_mib']:.0f}); "
          f"a replay spans {span:.3f} ms "
          f"on the device (gaps between kernels {gaps}), host work "
          f"{pg['step_ms'] - span:.3f} ms a step", flush=True)
    return dict(streams_equal=True, chunk_free_bit_equal=sum(free),
                chunk_free_steps=len(free), mixed_bit_equal=sum(mixed),
                mixed_steps=len(mixed), graphs=[list(k) for k in keys],
                step_shapes=[list(k) for k in shapes],
                step_ms=pg["step_ms"], eager_step_ms=pe["step_ms"],
                idle_share=pg["idle_share"],
                eager_idle_share=pe["idle_share"], replay_ms=span,
                kernels_per_step=pg["kernels_per_step"],
                eager_kernels_per_step=pe["kernels_per_step"],
                own_kernels=pg["own"], wrappers=pg["wrappers"],
                kernels_differing=diff, peak_mib=graph["peak_mib"],
                eager_peak_mib=eager["peak_mib"], windows=pg["windows"])


def same_plan(got, want) -> bool:
    """Two ExecutionPlans name the same entries with equal fields, the
    modeled II within 1e-9 relative."""
    return (got.hw_label == want.hw_label and got.names() == want.names()
            and all(dataclasses.replace(g, ii_s=w.ii_s) == w
                    and abs(g.ii_s - w.ii_s) <= 1e-9 * w.ii_s
                    for (_n, g), (_m, w) in zip(got.entries, want.entries)))


def serve_calibration(eng, cfg, chunk_free: int, tag: str) -> dict:
    """The engine's calibration loop over the serve run just ended: one
    sample per plan entry per chunk-free step (each step's host wall split
    in proportion to the modeled II, so every relative factor is 1.0),
    ``replan()`` equal to the engine's plan, and the rho autotuner
    (``mapper.suggest_rhos``) at the engine's decode shape on h100."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import mapper
    plan, table = eng.cfg.exec_plan, eng.calibration
    samples = sum(v["n"] for v in table.to_json().values())
    want = len(plan.entries) * chunk_free
    factors = table.factors(eng.hw_label)
    worst = max(abs(f - 1.0) for f in factors.values()) if factors else None
    new = eng.replan()
    tune = mapper.suggest_rhos(cfg, ShapeConfig("serve_decode", 1, eng.B,
                                                "decode"), hw="h100")
    tuned = sorted({(n.split("/")[-1], r) for n, r in tune.rhos.items()})
    print(f"{tag} calibration (hw {eng.hw_label}): {samples} samples "
          f"({len(plan.entries)} plan entries x {chunk_free} chunk-free "
          f"steps), {len(table)} keys; relative factors "
          + ", ".join(f"{k}={v:.12f}" for k, v in sorted(factors.items()))
          + f" (max |f - 1| {worst}); replan(): "
          + ", ".join(f"{n}={lp.path}" for n, lp in new.entries)
          + f" ({'equal to' if same_plan(new, plan) else 'NOT'} the "
          f"engine's plan); suggest_rhos(h100, decode at {eng.B} slots): "
          f"{len(tune.steps)} raises, rhos {tuned}", flush=True)
    if not chunk_free or samples != want:
        raise RuntimeError(f"serve calibration: {samples} samples, expected "
                           f"{want}")
    if len(factors) != len(plan.entries) or worst > 1e-9:
        raise RuntimeError(f"serve calibration: factors {factors} not all "
                           "1.0 within 1e-9")
    if not same_plan(new, plan):
        raise RuntimeError(f"serve calibration: replan() {new} differs from "
                           f"the engine's plan {plan}")
    return dict(hw=eng.hw_label, samples=samples, keys=len(table),
                factors=factors, max_factor_dev=worst,
                replan={n: lp.path for n, lp in new.entries},
                suggest_rhos=dict(raises=len(tune.steps),
                                  rhos=[list(t) for t in tuned],
                                  baseline_total_s=tune.baseline_total_s,
                                  tuned_total_s=tune.tuned_total_s))


# the hand-written kernels by their names in kernels/csrc: ovsf_gemm's
# three kernels and its split-K sum, ovsf_decompress's two layouts, fwht,
# the two attention kernels; each wrapper launch is one of them
# (``ovsf_gemm``'s split-K calls add one ``sum_splits_kernel``)
OWN_KERNELS = ("ovsf_gemm_kernel", "ovsf_gemm_tc_kernel",
               "ovsf_gemm_mono_kernel", "sum_splits_kernel",
               "ovsf_decompress_kernel", "ovsf_decompress_seg_kernel",
               "fwht_kernel", "paged_decode_kernel", "flash_decode_kernel")
OWN_OF_WRAPPER = {"ovsf_gemm": ("ovsf_gemm_kernel", "ovsf_gemm_tc_kernel",
                                "ovsf_gemm_mono_kernel"),
                  "ovsf_decompress": ("ovsf_decompress_kernel",
                                      "ovsf_decompress_seg_kernel"),
                  "fwht": ("fwht_kernel",),
                  "paged_flash_decode": ("paged_decode_kernel",),
                  "flash_decode_attn": ("flash_decode_kernel",)}


def warm_schedule():
    """A ``torch.profiler`` schedule that traces its first step unrecorded
    and records the second (the profiler's warm-up)."""
    from torch.profiler import schedule
    return schedule(wait=0, warmup=1, active=1, repeat=1)


def device_events(prof) -> list:
    """The device's events in a ``warm_schedule`` profile: kernels, copies
    and memsets, without the ``ProfilerStep#`` range that the schedule
    marks on the device's timeline (it spans the window)."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


MOST_WINDOWS = 6         # profiled windows per route at most (see below)


def agreed_windows(calls: dict, n: int, tag: str, least: int = 2,
                   most: int = MOST_WINDOWS) -> dict:
    """Each route's call (``calls``: route -> call) n times under
    ``torch.profiler``, in windows of the same work, each after one
    unrecorded warm-up call, the routes in turn, window after window: per
    route the first window's device events, each kernel's launches by name
    (the most that any of its windows recorded) and the wrappers' counters
    over a window (equal in every window). The profiler drops a device
    record now and then and never adds one (up to about twenty of ~16000 in
    a window, library and hand-written kernels alike, in both routes), so a
    count is a lower bound that one complete window makes exact. Windows go
    on, ``least`` at the fewest and ``most`` at the most, until the routes'
    counts agree by name and each route's hand-written kernels agree with
    its wrappers' counters (``check_own``). More windows cannot hide a real
    difference: a route that truly launches fewer of a kernel never records
    more of it than it launches. Only the device is traced: host events are
    not read, and parsing them took most of a window's time."""
    from torch.profiler import ProfilerActivity, profile
    got = {r: dict(first=None, counts={}, wrappers=None, each=[])
           for r in calls}
    for w in range(1, most + 1):
        for route, call in calls.items():
            with profile(activities=[ProfilerActivity.CUDA],
                         schedule=warm_schedule()) as prof:
                call()
                torch.cuda.synchronize()
                prof.step()
                reset_wrapper_counts()
                for _ in range(n):
                    call()
                torch.cuda.synchronize()
                prof.step()
            g = got[route]
            wrappers = wrapper_counts()
            if g["wrappers"] not in (None, wrappers):
                raise RuntimeError(f"{tag} {route} profiled windows launched "
                                   f"{g['wrappers']} and {wrappers}: not "
                                   "the same work")
            g["wrappers"] = wrappers
            kern = device_events(prof)
            g["first"] = kern if g["first"] is None else g["first"]
            g["each"].append(kernel_counts(kern))
            for k, c in g["each"][-1].items():
                g["counts"][k] = max(g["counts"].get(k, 0), c)
        counts = [g["counts"] for g in got.values()]
        if w >= least and all(c == counts[0] for c in counts) and all(
                not g["counts"] or own_seen(own_counts(g["counts"]))
                == g["wrappers"] for g in got.values()):
            break
    for g in got.values():
        g["windows"] = w
    return got


def kernel_counts(events) -> dict:
    """Launches by kernel name among the profiler's device events. Copies
    and memsets are not kernels: neither the ``Memcpy``/``Memset`` records
    nor the driver's own kernels that carry out a graph's copy node now and
    then (``memcpy32_post``: one D2D copy a replayed step, recorded so in
    some windows and as ``Memcpy DtoD`` in others, NVIDIA H100 80GB HBM3)."""
    return {e.key: e.count for e in events
            if not e.key.lower().startswith(("memcpy", "memset"))}


def own_counts(counts: dict) -> dict:
    """Launches of each of ``OWN_KERNELS`` in ``kernel_counts``."""
    return {k: sum(c for key, c in counts.items()
                   if re.search(rf"\b{k}\b", key)) for k in OWN_KERNELS}


def reset_wrapper_counts() -> None:
    """Zero every kernel wrapper's launch counter."""
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.kernels.decode_attn import (flash_decode_attn,
                                                 paged_flash_decode)
    from repro_torch.kernels.fwht import fwht
    G.reset_launches()
    paged_flash_decode.launches = flash_decode_attn.launches = 0
    flash_decode_attn.launches_unmasked = fwht.launches = 0


def wrapper_counts() -> dict:
    """Each kernel wrapper's launch counter (a replay adds its graph's)."""
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.kernels.decode_attn import (flash_decode_attn,
                                                 paged_flash_decode)
    from repro_torch.kernels.fwht import fwht
    return {"ovsf_gemm": G.ovsf_gemm.launches,
            "ovsf_decompress": G.ovsf_decompress.launches,
            "fwht": fwht.launches,
            "paged_flash_decode": paged_flash_decode.launches,
            "flash_decode_attn": flash_decode_attn.launches}


def own_seen(own: dict) -> dict:
    """``own_counts`` summed per kernel wrapper (``OWN_OF_WRAPPER``)."""
    return {w: sum(own[k] for k in ks) for w, ks in OWN_OF_WRAPPER.items()}


def check_own(tag: str, own: dict, wrappers: dict) -> None:
    """The wrappers' counters over a profiled window against the profiler's
    launches of their kernels, by name, in the same window: equal."""
    seen = own_seen(own)
    if seen != wrappers:
        raise RuntimeError(f"{tag} the profiler saw {seen} launches of the "
                           f"hand-written kernels ({own}), the wrappers "
                           f"counted {wrappers}")


def count_diff(graph: dict, eager: dict) -> str:
    """The kernels whose profiler counts differ between two routes."""
    names = sorted(set(graph) | set(eager))
    out = [f"{k[:70]} {graph.get(k, 0)} vs {eager.get(k, 0)}" for k in names
           if graph.get(k, 0) != eager.get(k, 0)]
    return "; ".join(out) if out else "none"


DECODE_STEPS = 8         # chunk-free steps a timing or a profiled window


def decode_ready(eng, cfg, rng) -> float:
    """Four requests of 48 prompt tokens into ``eng``, stepped until every
    slot decodes; then the chunk-free step wall (ms, host clock) over
    ``DECODE_STEPS`` steps. Each request asks for enough tokens that
    ``agreed_windows`` can take ``MOST_WINDOWS`` windows of chunk-free steps
    after it."""
    from repro_torch.serving import Request
    for rid in range(100, 104):
        eng.submit(Request(rid, rng.integers(0, cfg.vocab, 48, dtype=np.int32),
                           max_new_tokens=2 * DECODE_STEPS
                           + (DECODE_STEPS + 1) * MOST_WINDOWS))
    for _ in range(3):                  # prompts in; every slot decodes after
        eng.step()
    torch.cuda.synchronize()
    eng.core.step_shapes = set()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / DECODE_STEPS * 1e3


def decode_profile(eng, tag: str, step_ms: float, windows: dict) -> dict:
    """Where a chunk-free step's time goes, from ``eng``'s profiled windows
    (``agreed_windows``, ``DECODE_STEPS`` steps each): the device time by
    kernel (the first window) and the kernels launched per step (copies
    and memsets not counted); idle share = 1 - device busy time /
    unprofiled step wall (``decode_ready``). Drains ``eng``."""
    n = DECODE_STEPS
    kern, by_name, wrappers = (windows["first"], windows["counts"],
                               windows["wrappers"])
    eng.run_until_drained()
    busy_ms = sum(e.self_device_time_total for e in kern) / n / 1e3
    top = sorted(((e.self_device_time_total / n / 1e3, e.count // n, e.key)
                  for e in kern), reverse=True)[:10]
    if not kern or busy_ms <= 0:
        print(f"{tag} torch.profiler recorded no device time: device "
              "busy share not measured", flush=True)
        return dict(step_ms=step_ms, busy_ms=None, idle_share=None,
                    kernels_per_step=None, by_name=None, own=None,
                    wrappers=wrappers, windows=windows["windows"],
                    step_shapes=sorted(eng.core.step_shapes), top=[])
    kernels = sum(by_name.values()) / n
    own = own_counts(by_name)
    check_own(tag, own, wrappers)
    idle = 1.0 - busy_ms / step_ms
    shape = ", ".join(f"{k} {n}" for k, n in sorted(eng.core.step_shapes))
    print(f"{tag} chunk-free step ({shape}): wall {step_ms:.3f}ms, "
          f"device busy {busy_ms:.3f}ms, idle share {idle:.3f}, "
          f"{kernels:g} kernels a step ({windows['windows']} profiled "
          "windows)", flush=True)
    for ms, cnt, key in top:
        print(f"{tag}   {ms:.4f}ms/step x{cnt}/step  {key[:90]}", flush=True)
    return dict(step_ms=step_ms, busy_ms=busy_ms, idle_share=idle,
                kernels_per_step=kernels, by_name=by_name, own=own,
                wrappers=wrappers, windows=windows["windows"],
                step_shapes=sorted(eng.core.step_shapes),
                top=[dict(ms_per_step=ms, launches_per_step=cnt, kernel=key)
                     for ms, cnt, key in top])


# -- phase 5: card vs CPU parity ---------------------------------------------

def paged_step_logits(params, cfg, device, seed: int) -> torch.Tensor:
    """fp32 host logits of one packed paged step on ``device`` from empty
    page pools: slot 0 a 40-token chunk, slot 1 a 20-token chunk, slot 2
    one token, slot 3 idle; 61 valid tokens of T 64."""
    from repro_torch.models import registry as R
    n_slots, ps, npg = 4, 16, 16
    P = n_slots * npg
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[0, :3] = [7, 2, 40]          # slot 0: 40-token chunk at 0..39
    table[1, :2] = [11, 5]             # slot 1: 20-token chunk at 0..19
    table[2, :1] = [63]                # slot 2: one token at position 0
    rng = np.random.default_rng(seed)
    T, n = 64, 61
    tokens = np.zeros(T, np.int32)
    tokens[:n] = rng.integers(0, cfg.vocab, n)
    slot_ids = np.full(T, n_slots, np.int32)
    slot_ids[:n] = [0] * 40 + [1] * 20 + [2]
    positions = np.zeros(T, np.int32)
    positions[:n] = list(range(40)) + list(range(20)) + [0]
    new_pos = np.array([40, 20, 1, 0], np.int32)
    emit_idx = np.array([39, 59, 60, 0], np.int32)
    host = (table, tokens, slot_ids, positions, new_pos, emit_idx)
    cache = R.init_paged_cache(cfg, n_slots, ps, P, device)
    cache["pos"] = torch.zeros(n_slots, dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, _ = R.serve_step_paged(
            params, cfg, cache, *(torch.from_numpy(a).to(device)
                                  for a in host))
    return logits.float().cpu()


def parity_phase(seed: int, dev, alpha_dtype: str = ""):
    """One full-width fp32 packed step (alphas fp32 or ``alpha_dtype``),
    planned by the mapper as the engine plans it on the card, run on the
    card and on the CPU with the same parameters."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.serving import plan_cfg
    cfg = get_config("tinyllama_1_1b")
    cfg = cfg.replace(dtype="float32", ovsf=dataclasses.replace(
        cfg.ovsf, alpha_dtype=alpha_dtype))
    cfg = plan_cfg(cfg, 4, dev)
    if {p.path for _n, p in cfg.exec_plan.entries} != {"fused"}:
        raise RuntimeError(f"parity: plan {cfg.exec_plan} is not fused")
    params = R.model_init(cfg, seed + 1, dev)

    def run(p, device):
        return paged_step_logits(p, cfg, device, seed)

    t0 = time.perf_counter()
    gpu = run(params, dev)
    t_gpu = time.perf_counter() - t0
    cpu_params = R.params_to(params, "cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = run(cpu_params, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    if gpu.shape != (4, cfg.vocab) or not torch.isfinite(gpu).all():
        raise RuntimeError(f"parity: logits {tuple(gpu.shape)} not finite")
    rel = float((gpu - cpu).norm() / cpu.norm())
    print(f"[parity] full-width fp32 packed step, alphas "
          f"{alpha_dtype or 'fp32'} (T=64, 61 valid): card vs CPU logits "
          f"rel L2 err={rel:.3e} (limit 1e-3); card step {t_gpu:.3f}s, CPU "
          f"step {t_cpu:.3f}s", flush=True)
    if not rel <= 1e-3:
        raise RuntimeError(f"parity: relative error {rel:.3e} > 1e-3")
    return dict(alpha_dtype=alpha_dtype or "fp", rel_err=rel,
                gpu_step_s=t_gpu, cpu_step_s=t_cpu)


def parity_contiguous_phase(seed: int, dev):
    """One full-width fp32 ``serve_step`` (the contiguous window engine's
    decode: T_alloc 256 + 64; rows at pos 0, 77, 256 and an idle row at 330,
    past the buffer, whose write clamps) and one ``serve_step_packed``
    (T_alloc 256: a 40-token chunk at 0, a decode at 100, a 20-token chunk
    at 50, a decode at 255, two padding tokens) over random K/V, planned as
    the engine plans on the card, on the card and on the CPU with the same
    parameters and caches. On the card each step must launch
    ``flash_decode_attn`` once per layer."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attn import flash_decode_attn
    from repro_torch.models import registry as R
    from repro_torch.serving import plan_cfg
    cfg = plan_cfg(get_config("tinyllama_1_1b").replace(dtype="float32"), 4,
                   dev)
    params = R.model_init(cfg, seed + 2, dev)
    rng = np.random.default_rng(seed + 2)
    B, nl, Hkv, hd = 4, cfg.n_layers, cfg.n_kv_heads, cfg.hd

    def kv(T):
        return [rng.standard_normal((nl, B, T, Hkv, hd), np.float32)
                for _ in range(2)]

    dec_kv = kv(256 + 64)
    dec = dict(pos=np.array([0, 77, 256, 330], np.int32),
               tokens=rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
    pk_kv = kv(256)
    n_valid, T = 62, 64
    sids = [0] * 40 + [1] + [2] * 20 + [3] + [B] * (T - n_valid)
    poss = list(range(40)) + [100] + list(range(50, 70)) + [255] + [0] * 2
    packed = dict(tokens=rng.integers(0, cfg.vocab, T).astype(np.int32),
                  slot_ids=np.array(sids, np.int32),
                  positions=np.array(poss, np.int32),
                  new_pos=np.array([40, 101, 70, 256], np.int32),
                  emit_idx=np.array([39, 40, 60, 61], np.int32))
    pk_pos = np.array([0, 100, 50, 255], np.int32)

    def run(p, device):
        put = lambda a: torch.from_numpy(np.array(a)).to(device)
        with torch.no_grad():
            flash_decode_attn.launches = 0
            cache = {"k": put(dec_kv[0]), "v": put(dec_kv[1]),
                     "pos": put(dec["pos"])}
            l_dec, _ = R.serve_step(p, cfg, cache, put(dec["tokens"]))
            n_dec = flash_decode_attn.launches
            cache = {"k": put(pk_kv[0]), "v": put(pk_kv[1]),
                     "pos": put(pk_pos)}
            l_pk, _ = R.serve_step_packed(p, cfg, cache,
                                          *(put(packed[k]) for k in (
                                              "tokens", "slot_ids",
                                              "positions", "new_pos",
                                              "emit_idx")))
            n_pk = flash_decode_attn.launches - n_dec
        return l_dec.float().cpu(), l_pk.float().cpu(), (n_dec, n_pk)

    t0 = time.perf_counter()
    gpu_dec, gpu_pk, n = run(params, dev)
    t_gpu = time.perf_counter() - t0
    if n != (nl, nl):
        raise RuntimeError(f"parity: flash_decode_attn launched {n} times in "
                           f"the two steps, expected {nl} each")
    cpu_params = R.params_to(params, "cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_dec, cpu_pk, _ = run(cpu_params, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    out = {}
    for name, g, c in (("serve_step", gpu_dec, cpu_dec),
                       ("serve_step_packed", gpu_pk, cpu_pk)):
        if g.shape != (B, cfg.vocab) or not torch.isfinite(g).all():
            raise RuntimeError(f"parity: {name} logits {tuple(g.shape)} not "
                               "finite")
        out[name] = float((g - c).norm() / c.norm())
    print(f"[parity] full-width fp32 contiguous cache: card vs CPU logits "
          f"rel L2 err serve_step={out['serve_step']:.3e}, "
          f"serve_step_packed={out['serve_step_packed']:.3e} (limit 1e-3); "
          f"flash_decode_attn launches on the card {n}; card steps "
          f"{t_gpu:.3f}s, CPU steps {t_cpu:.3f}s", flush=True)
    if not max(out.values()) <= 1e-3:
        raise RuntimeError(f"parity: relative error {out} > 1e-3")
    return dict(rel_err=out, launches=n, gpu_steps_s=t_gpu,
                cpu_steps_s=t_cpu)


# -- phase 6: CNNs ------------------------------------------------------------

# (d_in, d_out, calls per forward) of ResNet-50's OVSF convs in matrix mode
RESNET50_DECOMPRESS = ((1152, 128, 4), (2304, 256, 6), (4608, 512, 3))


def decompress_case(rng, d_in: int, N: int, dtype, dev, repeat=False):
    """Unit-scale W from J = L/2 sorted code ids (drawn with replacement
    when ``repeat``: the kernel must sum repeated ids)."""
    L = 1 << (d_in - 1).bit_length()
    J = L // 2
    idx = np.sort(rng.choice(L, J, replace=repeat)).astype(np.int32)
    al = torch.from_numpy(rng.standard_normal((J, N), np.float32))
    return (al.div_(math.sqrt(J)).to(dev, dtype),
            torch.from_numpy(idx).to(dev), L)


def decompress_row(rng, dev, d_in: int, N: int, dt, repeat: bool,
                   alpha_dtype: str = "", tag: str = "[kernel]") -> dict:
    """One ``ovsf_decompress`` case (``decompress_case``; with
    ``alpha_dtype`` its alphas quantised to int8 / int4 with one scale, W
    then fp32) against its plain version: equal bit for bit and a second
    launch equal (repeated ids: within the tolerance, atomics sum them in
    any order). Bound: the stored alphas (and scale) and ids read, W written
    once, or the dequantising multiplies and the transform's N L log2 L
    additions at the fp32 rate; library: ``torch.matmul(S.T, alphas)``, S =
    H_L[idx, :d_in] and the dequantised alphas built outside the timed
    region (the port never calls it)."""
    from repro_torch.core.ovsf import (dequantize_alphas, hadamard_matrix,
                                       quantize_alphas)
    from repro_torch.kernels.ovsf_gemm import (ovsf_decompress,
                                               ovsf_decompress_plain)
    al, idx, L = decompress_case(rng, d_in, N, dt, dev, repeat)
    J = L // 2
    kw = {}
    if alpha_dtype:
        al, s = quantize_alphas(al, 1, alpha_dtype)
        kw = dict(alpha_scale=s, alpha_dtype=alpha_dtype)
    w_dt = torch.float32 if alpha_dtype else dt
    label = (f"ovsf_decompress{' ' + alpha_dtype if alpha_dtype else ''} "
             f"d_in={d_in} L={L} J={J} N={N}"
             f"{' repeated ids' if repeat else ''} "
             f"{str(w_dt).split('.')[-1]}")
    got = ovsf_decompress(al, idx, d_in, **kw)
    want = ovsf_decompress_plain(al, idx, d_in, **kw)
    if got.dtype != w_dt:
        raise RuntimeError(f"{label}: W {got.dtype}, expected {w_dt}")
    err = check(label, got, want, w_dt)
    if not repeat:           # repeated ids sum by atomics, in any order
        exact_and_repeatable(label, got, err,
                             ovsf_decompress(al, idx, d_in, **kw))
    bytes_ = (al.numel() * al.element_size() + idx.numel() * 4
              + d_in * N * got.element_size()
              + (4 if alpha_dtype else 0))
    ops = N * L * math.log2(L) + (J * N if alpha_dtype else 0)
    t_bound, by = bound(bytes_, ops, torch.float32)
    copies = [al.clone() for _ in range(n_copies(bytes_))]
    ms, call_ms = timings([lambda a=a: ovsf_decompress(a, idx, d_in, **kw)
                           for a in copies], 40)
    plain_ms, _ = timings([lambda a=a: ovsf_decompress_plain(
        a, idx, d_in, **kw) for a in copies[:2]], 4)
    S = hadamard_matrix(L, w_dt, dev)[idx.long(), :d_in]
    lib_in = ([dequantize_alphas(a, s, alpha_dtype) for a in copies]
              if alpha_dtype else copies)
    lib_err = float((torch.matmul(S.t(), lib_in[0]).float() - want.float())
                    .abs().max())
    lib_ms, _ = timings([lambda a=a: torch.matmul(S.t(), a)
                         for a in lib_in], 20)
    del copies, lib_in, S
    tol = TOL[w_dt] if repeat else 0.0
    print(f"{tag} {label}: max_abs_err={err:.3e} (tol {tol}) "
          f"kernel={ms:.4f}ms (per Python call {call_ms:.4f}ms) "
          f"bound={t_bound:.5f}ms ({by}; {t_bound / ms:.0%} of it) "
          f"plain={plain_ms:.4f}ms "
          f"library(matmul S^T alphas)={lib_ms:.4f}ms (kernel/library "
          f"{ms / lib_ms:.2f}; its err {lib_err:.1e})", flush=True)
    return dict(case=label, d_in=d_in, L=L, J=J, N=N, repeated_ids=repeat,
                dtype=str(dt), alpha_dtype=alpha_dtype or "fp",
                max_abs_err=err, tol=tol, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                bound_ms=t_bound, bound_by=by, bound_share=t_bound / ms,
                vs_library=ms / lib_ms)


def run_decompress_checks(rng, dev):
    """``ovsf_decompress`` over fp32 and bf16 alphas (``decompress_row``)
    at the ResNet-50 shapes, a ragged one and repeated ids."""
    shapes = [(d, n, False) for d, n, _c in RESNET50_DECOMPRESS]
    shapes += [(288, 128, False), (1000, 40, False), (200, 24, True)]
    rows = [decompress_row(rng, dev, d_in, N, dt, repeat)
            for d_in, N, repeat in shapes
            for dt in (torch.float32, torch.bfloat16)]
    # one ResNet-50 forward's 13 calls in fp32 (the kernels line)
    pick = {r["d_in"]: r for r in rows if r["dtype"] == "torch.float32"}
    summary = {key: sum(c * pick[d][key] for d, _n, c in RESNET50_DECOMPRESS)
               for key in ("ms", "call_ms", "plain_ms", "library_ms",
                           "bound_ms")}
    summary["bound_by"] = ("bytes" if all(pick[d]["bound_by"] == "bytes" for
                                          d, _n, _c in RESNET50_DECOMPRESS)
                           else "operations")
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return rows, summary


# (M, L, calls per forward) of the fwht calls of a forward at batch 8 under
# the h100 ALL_PATHS plan: ResNet-50's s1, s2, s3 convs and SqueezeNet-1.1's
# fires 2-3, 4-5, 6-7
RESNET50_FWHT = ((6272, 2048, 4), (1568, 4096, 6), (392, 8192, 3))
SQUEEZENET_FWHT = ((6272, 512, 2), (1568, 512, 2), (1568, 1024, 2))


def hadamard(L: int, dtype, dev) -> torch.Tensor:
    """H_L by Sylvester doubling on the card (the library yardstick's
    operand, built outside its timed region; ``core.ovsf.hadamard_matrix``
    would hold L x L int64 temporaries, 8.6 GB at L = 32768)."""
    H = torch.ones((1, 1), dtype=dtype, device=dev)
    while H.shape[0] < L:
        H = torch.cat([torch.cat([H, H], 1), torch.cat([H, -H], 1)], 0)
    return H


def run_fwht_checks(rng, dev):
    """``fwht`` vs ``fwht_plain`` on rows of unit-scale outputs (x ~ N(0,
    1/L)). Bound: each row read once and written once, or the M L log2 L
    fp32 additions; library: ``torch.matmul(x, H_L)``, H prebuilt (TF32
    off; the port never calls it). Then the wrapper's refusals."""
    from repro_torch.kernels.fwht import MAX_L, fwht, fwht_plain
    shapes = [(m, L) for m, L, _c in RESNET50_FWHT + SQUEEZENET_FWHT]
    shapes += [(37, 1024), (5, 2), (3, MAX_L)]
    rows = []
    for M, L in shapes:
        for dt in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((M, L), np.float32))
            x = x.div_(math.sqrt(L)).to(dev, dt)
            label = f"fwht M={M} L={L} {str(dt).split('.')[-1]}"
            got = fwht(x)
            err = check(label, got, fwht_plain(x), dt)
            exact_and_repeatable(label, got, err, fwht(x))
            bytes_ = 2 * x.numel() * x.element_size()
            t_bound, by = bound(bytes_, M * L * math.log2(L), torch.float32)
            copies = [x.clone() for _ in range(n_copies(bytes_))]
            ms, call_ms = timings([lambda a=a: fwht(a) for a in copies], 40)
            plain_ms, _ = timings([lambda a=a: fwht_plain(a)
                                   for a in copies[:2]], 4)
            H = hadamard(L, dt, dev)
            lib_err = float((torch.matmul(x, H).float()
                             - fwht_plain(x).float()).abs().max())
            lib_ms, _ = timings([lambda a=a: torch.matmul(a, H)
                                 for a in copies], 20)
            del copies, H
            rows.append(dict(case=label, M=M, L=L, dtype=str(dt),
                             max_abs_err=err, tol=0.0, ms=ms,
                             call_ms=call_ms, plain_ms=plain_ms,
                             library_ms=lib_ms, library_err=lib_err,
                             bound_ms=t_bound, bound_by=by,
                             bound_share=t_bound / ms, vs_library=ms / lib_ms))
            print(f"[kernel] {label}: max_abs_err={err:.3e} (tol 0.0) "
                  f"kernel={ms:.4f}ms (per Python call {call_ms:.4f}ms) "
                  f"bound={t_bound:.5f}ms ({by}; {t_bound / ms:.0%} of it) "
                  f"plain={plain_ms:.4f}ms "
                  f"library(matmul x H_L)={lib_ms:.4f}ms (kernel/library "
                  f"{ms / lib_ms:.2f}; its err {lib_err:.1e})", flush=True)
        torch.cuda.empty_cache()
    before = fwht.launches
    refused = []
    for L in (12, 2 * MAX_L):
        try:
            fwht(torch.zeros((4, L), device=dev))
        except ValueError as e:
            refused.append(f"L={L}: {e}")
            continue
        raise RuntimeError(f"fwht took L={L} without raising")
    if fwht.launches != before:
        raise RuntimeError("a refused fwht call counted a launch")
    print("[kernel] fwht refuses: " + "; ".join(refused), flush=True)
    # one ResNet-50 forward's 13 calls in fp32 (the kernels line)
    pick = {(r["M"], r["L"]): r for r in rows
            if r["dtype"] == "torch.float32"}
    summary = {key: sum(c * pick[(m, L)][key] for m, L, c in RESNET50_FWHT)
               for key in ("ms", "call_ms", "plain_ms", "library_ms",
                           "bound_ms")}
    summary["bound_by"] = ("bytes" if all(pick[(m, L)]["bound_by"] == "bytes"
                                          for m, L, _c in RESNET50_FWHT)
                           else "operations")
    summary["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    return rows, summary, refused


def run_mono_checks(rng, dev) -> list:
    """The monolithic tensor-core ``ovsf_gemm`` (fp32 x and alphas over
    monolithic codes) at shapes the CNN convs do not take: ragged M, K and N,
    K below one k16 step, and repeated code ids (summed by the atomic
    scatter, in any order: the tolerance holds, not equality). Where no id
    repeats, a second launch must equal the first bit for bit."""
    from repro_torch.kernels import ovsf_gemm as G
    rows = []
    for M, K, N, repeat in ((37, 1000, 44, False), (5, 13, 9, False),
                            (300, 700, 40, True), (70, 60, 24, False)):
        L = 1 << (K - 1).bit_length()
        J = L // 2
        idx = torch.from_numpy(np.sort(rng.choice(L, J, replace=repeat))
                               .astype(np.int32)).to(dev)
        x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(dev)
        al = torch.from_numpy(rng.standard_normal((J, N), np.float32)
                              / math.sqrt(J)).to(dev)
        label = (f"ovsf_gemm mono M={M} {K}->{N} J={J}"
                 f"{' repeated ids' if repeat else ''} float32")
        G.reset_launches()
        got = G.ovsf_gemm(x, al, idx)
        if G.ovsf_gemm.launches_by_kernel["mono_tc"] != 1:
            raise RuntimeError(f"{label}: ran "
                               f"{G.ovsf_gemm.launches_by_kernel}")
        err = check(label, got, G.ovsf_gemm_plain(x, al, idx), torch.float32)
        if not repeat and not torch.equal(got, G.ovsf_gemm(x, al, idx)):
            raise RuntimeError(f"{label}: a second launch differs")
        plan = G.mono_plan(M, K, N, J, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        rows.append(dict(case=label, M=M, K=K, N=N, J=J, repeated_ids=repeat,
                         max_abs_err=err, tol=TOL[torch.float32], plan=plan))
        print(f"[kernel] {label} (mono_tc, bn {plan['bn']}, {plan['blocks']} "
              f"blocks): max_abs_err={err:.3e} (tol {TOL[torch.float32]})"
              f"{'' if repeat else ', second launch equal'}", flush=True)
    return rows


# the kernel each path of an OVSF conv's GEMM launches, once a call
PATH_KERNEL = {"materialize": "ovsf_decompress", "fused": "ovsf_gemm",
               "spectral": "fwht"}


def path_launches(fn):
    """(fn's result, launches of the three CNN-path kernels in that call),
    the counters zeroed just before it."""
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.kernels.fwht import fwht
    G.reset_launches()
    fwht.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {"ovsf_decompress": G.ovsf_decompress.launches,
                 "ovsf_gemm": G.ovsf_gemm.launches, "fwht": fwht.launches}


def check_path_launches(label: str, path: str, got: dict) -> None:
    if got != {k: int(k == PATH_KERNEL[path]) for k in got}:
        raise RuntimeError(f"{label}: the {path} plan launched {got}")


def run_three_paths(seed: int, dev) -> dict:
    """One ResNet-50 s2 conv's GEMM (M 1568, 2304 -> 256, rho 0.5, the
    conv's code ids from the init schedule) on integer-valued alphas and
    patches in {-1, 0, 1}: every sum is an integer below 2**24, exact in
    fp32, so ``materialize``, ``fused`` and ``spectral`` plans must give
    equal outputs, each through its own kernel."""
    from repro_torch.core import ovsf
    from repro_torch.kernels import ops
    from repro_torch.runtime import mapper
    M, d_in, d_out = 1568, 2304, 256
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    p = ovsf.init_ovsf(gen, ovsf.OVSFSpec(d_in, d_out, rho=0.5,
                                          strategy="iterative"),
                       scale=2.0, device=dev)
    al = torch.randint(-1, 2, tuple(p["alphas"].shape), generator=gen,
                       device=dev).float()
    x = torch.randint(-1, 2, (M, d_in), generator=gen, device=dev).float()
    base = mapper.classify_gemm(M, d_in, d_out, 0.5, seg=0, hw="h100",
                                name="s2b1c2", paths=mapper.ALL_PATHS)
    from repro_torch.kernels.ovsf_gemm import ovsf_gemm
    outs = {}
    for path in ops.EXEC_PATHS:
        outs[path], got = path_launches(lambda: ops.ovsf_matmul(
            x, al, p["idx"], plan=dataclasses.replace(base, path=path,
                                                      cache_weights=False)))
        check_path_launches("three paths", path, got)
        if (path == "fused"
                and ovsf_gemm.launches_by_kernel["mono_tc"] != 1):
            raise RuntimeError("three paths: fused ran "
                               f"{ovsf_gemm.launches_by_kernel}")
    diff = {p: float((outs[p] - outs["materialize"]).abs().max())
            for p in outs}
    print(f"[three paths] ResNet-50 s2 conv GEMM M={M} {d_in}->{d_out} "
          f"rho 0.5, integer inputs: max |y - y_materialize| {diff} "
          f"(must be 0); the h100 plan itself picks {base.path}", flush=True)
    if any(diff.values()) or not torch.isfinite(outs["fused"]).all():
        raise RuntimeError(f"three paths disagree: {diff}")
    return dict(M=M, d_in=d_in, d_out=d_out, max_abs_diff=diff,
                planned_path=base.path)


def conv_gemms(cfg, batch: int) -> list:
    """(name, M as ``plan_cnn`` reckons it, fan-in, c_out, rho, M of the
    forward's im2col) per OVSF conv, in ``plan_cnn``'s order: its specs
    (``mapper._resnet_convs`` / ``_squeezenet_convs``, whose side halves at
    ``proj`` too: ROADMAP C) beside ``hwmodel.cnn_workload``'s layers,
    which track the real side."""
    from repro_torch.hwmodel.cnn_workload import cnn_gemm_layers
    from repro_torch.runtime import mapper
    specs = (mapper._squeezenet_convs(cfg) if cfg.depth == "squeezenet"
             else mapper._resnet_convs(cfg))
    real = {l.name: l for l in cnn_gemm_layers(cfg, batch) if l.ovsf}
    out = []
    for name, c_in, c_out, k, _stride, rho, side in specs:
        if rho >= 1.0 or k < 3:                 # as plan_cnn skips
            continue
        l = real[name]
        if (l.d_in, l.d_out) != (c_in * k * k, c_out):
            raise RuntimeError(f"{name}: workload {l} vs spec {c_in}x{k}x{k}"
                               f" -> {c_out}")
        out.append((name, batch * side * side, c_in * k * k, c_out, rho,
                    l.M))
    if sorted(n for n, *_ in out) != sorted(real):
        raise RuntimeError(f"planned convs {[n for n, *_ in out]} vs OVSF "
                           f"layers {sorted(real)}")
    return out


def classify_conv(name, M_plan, K, N, rho, paths, calibration=None):
    """``classify_gemm`` on exactly the arguments ``plan_cnn`` passes for
    the conv (batch 8, h100)."""
    from repro_torch.runtime import mapper
    return mapper.classify_gemm(M_plan, K, N, rho, seg=0, hw="h100",
                                name=name, weight_reuse=256, paths=paths,
                                calibration=calibration)


def cnn_path_times(seed: int, dev, arch: str, table) -> list:
    """Every OVSF conv of a full-width CNN (matrix mode, fp32, batch 8, TF32
    off) at its real im2col shape, under each of ``materialize``, ``fused``
    and ``spectral``: the conv's ``plan_cnn`` entry with its path replaced,
    through ``ops.ovsf_matmul`` as the forward calls it, on the conv's own
    alphas and code ids and random patches. Each call must launch its
    path's kernel once and nothing else, and equal the plain version
    within the fp32 tolerance. Device ms from CUDA-graph replay go into
    ``table`` as ``(conv, path, "h100")`` against ``classify_gemm``'s
    modeled II for that path alone. The ``fused`` rows also give the
    monolithic tensor-core ``ovsf_gemm`` (fp32 x, monolithic codes; its
    second launch must equal the first) its bound, its plain version's time
    and ``torch.matmul`` on the dense W. The bound is the larger of the bytes
    (x, y, alphas and ids once) over the memory rate and the work as the
    card does it at best: three bf16 products (6 M K N) on the tensor cores
    plus one L-point WHT a column (N L log2 L adds) on the fp32 cores; the
    old bound (2 M K N at the fp32 CUDA-core rate, which a bf16x3 kernel
    may beat) is printed beside it."""
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ovsf_gemm import ovsf_gemm_plain
    from repro_torch.models import cnn
    from repro_torch.runtime import mapper
    B = 8
    cfg = get_config(arch).replace(ovsf_mode="matrix")
    params, _state = cnn.cnn_init(cfg, seed, dev)
    uncal = mapper.plan_cnn(cfg, batch=B, hw="h100", paths=mapper.ALL_PATHS)
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    rows = []
    for name, M_plan, K, N, rho, M in conv_gemms(cfg, B):
        entry = uncal.plan_for(name)
        if classify_conv(name, M_plan, K, N, rho, mapper.ALL_PATHS) != entry:
            raise RuntimeError(f"{name}: classify_gemm's arguments are not "
                               "plan_cnn's")
        al, idx = params[name]["alphas"], params[name]["idx"]
        J = al.shape[0]
        x = torch.randn((M, K), generator=gen, device=dev)
        want = ovsf_gemm_plain(x, al, idx)
        copies = [x] + [torch.randn_like(x)
                        for _ in range(n_copies(M * K * 4) - 1)]
        label = f"[cnn paths {arch}] {name} M={M} {K}->{N} J={J}"
        row = dict(arch=arch, conv=name, M=M, M_plan=M_plan, d_in=K, d_out=N,
                   rho=rho, J=J, plan_path=entry.path)
        for path in mapper.ALL_PATHS:
            # every call generates its W (no weight-stationary cache): what
            # the path costs a forward (``no_cache``)
            lp = dataclasses.replace(entry, path=path, cache_weights=False)
            y, got = path_launches(lambda: ops.ovsf_matmul(x, al, idx,
                                                           plan=lp))
            check_path_launches(label, path, got)
            err = check(f"{label} {path}", y, want, torch.float32)
            if path == "fused":
                if G.ovsf_gemm.launches_by_kernel["mono_tc"] != 1:
                    raise RuntimeError(f"{label} fused ran "
                                       f"{G.ovsf_gemm.launches_by_kernel}")
                if not torch.equal(y, ops.ovsf_matmul(x, al, idx, plan=lp)):
                    raise RuntimeError(f"{label} fused: a second launch "
                                       "differs from the first")
            calls = [lambda a=a: ops.ovsf_matmul(a, al, idx, plan=lp)
                     for a in copies]
            est = time_ms(calls, 2)
            iters = max(3, min(40, int(30.0 / max(est, 1e-3))))
            ms, call_ms = timings(calls, iters)
            modeled = classify_conv(name, M_plan, K, N, rho, (path,)).ii_s
            table.record(name, path, "h100", ms * 1e-3, modeled)
            row[path] = dict(ms=ms, call_ms=call_ms, iters=iters,
                             modeled_ms=modeled * 1e3, max_abs_err=err,
                             launches=got)
        W = ops.decompress(al, idx, K)
        lib_ms, _ = timings([lambda a=a: torch.matmul(a, W) for a in copies],
                            20)
        plain_ms, _ = timings([lambda: ovsf_gemm_plain(x, al, idx)], 3)
        # generation at its cheapest: one L-point WHT per output column (N L
        # log2 L adds, as ovsf_decompress's bound), then the GEMM
        L = 1 << (K - 1).bit_length()
        bytes_ = (M * K + M * N + J * N) * 4 + J * 4
        wht_adds = N * L * math.log2(L)
        old_bound, old_by = bound(bytes_, 2 * M * K * N + wht_adds,
                                  torch.float32)
        t_mem = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = (6 * M * K * N / PEAK_FLOPS[torch.bfloat16]
                 + wht_adds / FP32_CUDA_CORE_FLOPS) * 1e3
        t_bound, by = ((t_mem, "bytes") if t_mem >= t_ops
                       else (t_ops, "operations"))
        f_ms = row["fused"]["ms"]
        row["fused"].update(bound_ms=t_bound, bound_by=by,
                            bound_share=t_bound / f_ms,
                            old_bound_ms=old_bound, old_bound_by=old_by,
                            old_bound_share=old_bound / f_ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            vs_library=f_ms / lib_ms)
        del copies, W
        rows.append(row)
        print(f"{label} (plan M={M_plan}): device ms "
              + ", ".join(f"{p} {row[p]['ms']:.4f} (modeled "
                          f"{row[p]['modeled_ms']:.5f}, err "
                          f"{row[p]['max_abs_err']:.1e})"
                          for p in mapper.ALL_PATHS)
              + f"; ovsf_gemm (monolithic tensor-core, fp32 x) bound "
              f"{t_bound:.4f}ms ({by}; {t_bound / f_ms:.0%} of it), old "
              f"bound {old_bound:.4f}ms ({old_by}; {old_bound / f_ms:.0%}), "
              f"plain {plain_ms:.4f}ms, matmul on dense W {lib_ms:.4f}ms "
              f"(fused/matmul {f_ms / lib_ms:.2f})", flush=True)
    del params
    torch.cuda.empty_cache()
    return rows


def calibrated_cnn_plan(arch: str, table):
    """The ``ALL_PATHS`` plan of a CNN (matrix mode, batch 8, h100) with
    ``table``'s factors: ``classify_gemm(..., calibration=table)`` per conv
    on ``plan_cnn``'s arguments (``plan_cnn`` takes no table, as the
    reference's). Every (conv, path) must have a sample: an unmeasured one
    keeps factor 1.0 and would look cheaper by the whole model's skew."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import mapper
    cfg = get_config(arch).replace(ovsf_mode="matrix")
    missing = [(n, p) for n, *_ in conv_gemms(cfg, 8)
               for p in mapper.ALL_PATHS
               if table.raw_ratio(n, p, "h100") is None]
    if missing:
        raise RuntimeError(f"calibration: no sample for {missing}")
    return mapper.ExecutionPlan(tuple(
        (name, classify_conv(name, M_plan, K, N, rho, mapper.ALL_PATHS,
                             table))
        for name, M_plan, K, N, rho, _M in conv_gemms(cfg, 8)),
        hw_label="h100")


def no_cache(plan):
    """``plan`` with ``cache_weights`` off in every entry. The CNN phases
    count and time forwards that generate their weights at every call (the
    paper's on-the-fly generation); a ``materialize`` entry with the
    mapper's weight-stationary cache would generate once and reuse it in
    eager calls. The cache's own card check: ``run_cache_check``."""
    return dataclasses.replace(plan, entries=tuple(
        (n, dataclasses.replace(lp, cache_weights=False))
        for n, lp in plan.entries))


def cnn_phase(seed: int, card: str, dev, arch: str, mode: str,
              launches_per_forward: int = 0, plan=None,
              label: str = "none") -> dict:
    """One full-width CNN (fp32, 224x224, batch 8, weights from ``seed``)
    through ``cnn_apply`` on the card (``mode`` "" keeps the registered
    config's), with no plan or under the ``ExecutionPlan`` ``plan`` named
    ``label``: launch counts of one forward (without a plan
    ``launches_per_forward`` ``ovsf_decompress``; with one, each kernel as
    many as the plan names its path), logits against the same forward on
    the CPU, then images/s on the host clock and device time by kernel from
    ``torch.profiler``."""
    from collections import Counter
    from repro_torch.configs import get_config
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.kernels.decode_attn import (flash_decode_attn,
                                                 paged_flash_decode)
    from repro_torch.kernels.fwht import fwht
    from repro_torch.models import cnn
    from repro_torch.models.registry import params_to
    B = 8
    cfg = get_config(arch)
    if mode:
        cfg = cfg.replace(ovsf_mode=mode)
    tag = f"[cnn {arch} {cfg.ovsf_mode}]"
    want = {"ovsf_decompress": launches_per_forward, "ovsf_gemm": 0,
            "fwht": 0, "paged_flash_decode": 0, "flash_decode_attn": 0}
    plan_paths_count = None
    if plan is not None:
        cfg = cfg.replace(exec_plan=no_cache(plan))
        tag = f"[cnn {arch} {cfg.ovsf_mode} plan h100 {label}]"
        plan_paths_count = dict(Counter(
            lp.path for _n, lp in cfg.exec_plan.entries))
        want.update(ovsf_decompress=plan_paths_count.get("materialize", 0),
                    ovsf_gemm=plan_paths_count.get("fused", 0),
                    fwht=plan_paths_count.get("spectral", 0))
        print(f"{tag} plan path counts {plan_paths_count}: "
              + ", ".join(f"{n}={lp.path}"
                          for n, lp in cfg.exec_plan.entries), flush=True)
    if (torch.backends.cudnn.allow_tf32
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(f"{tag} TF32 must be off for the parity check")
    params, state = cnn.cnn_init(cfg, seed, dev)
    if plan is not None:
        ovsf_convs = sorted(n for n, p in params.items()
                            if "alphas" in p and "meta" not in p)
        if ovsf_convs != sorted(cfg.exec_plan.names()):
            raise RuntimeError(f"{tag} the plan names "
                               f"{cfg.exec_plan.names()}, the OVSF convs are "
                               f"{ovsf_convs}")
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    x = torch.randn((B, cfg.in_hw, cfg.in_hw, 3), generator=gen, device=dev)

    def forward(p, s, images):
        with torch.no_grad():
            return cnn.cnn_apply(p, s, cfg, images)[0]

    G.reset_launches()
    paged_flash_decode.launches = 0
    flash_decode_attn.launches = 0
    fwht.launches = 0
    logits = forward(params, state, x)
    torch.cuda.synchronize()
    launches = {"ovsf_decompress": G.ovsf_decompress.launches,
                "ovsf_gemm": G.ovsf_gemm.launches, "fwht": fwht.launches,
                "paged_flash_decode": paged_flash_decode.launches,
                "flash_decode_attn": flash_decode_attn.launches}
    if launches != want:
        raise RuntimeError(f"{tag} one forward launched {launches}, expected "
                           f"{want}")
    by_kernel_launches = dict(G.ovsf_gemm.launches_by_kernel)
    if by_kernel_launches["mono_tc"] != launches["ovsf_gemm"]:
        raise RuntimeError(f"{tag} ovsf_gemm ran {by_kernel_launches}: every "
                           "CNN launch must be on the monolithic tensor-core "
                           "kernel")
    if logits.shape != (B, cfg.num_classes) or not torch.isfinite(
            logits).all():
        raise RuntimeError(f"{tag} logits {tuple(logits.shape)} not finite")
    t0 = time.perf_counter()
    cpu = forward(params_to(params, "cpu"), params_to(state, "cpu"), x.cpu())
    t_cpu = time.perf_counter() - t0
    rel = float((logits.float().cpu() - cpu).norm() / cpu.norm())
    print(f"{tag} launches per forward {launches}; card vs CPU logits rel "
          f"L2 err={rel:.3e} (limit 1e-3, TF32 off); CPU forward "
          f"{t_cpu:.2f}s", flush=True)
    if not rel <= 1e-3:
        raise RuntimeError(f"{tag} relative error {rel:.3e} > 1e-3")

    n = 10

    def eager_call():
        return forward(params, state, x)
    graph, eager = cnn_graph_phase(tag, params, state, cfg, x, logits, want,
                                   n, eager_call, forward_wall(eager_call, n))
    del params, state, x
    torch.cuda.empty_cache()
    images_s = B / eager["wall_ms"] * 1e3
    result = dict(arch=arch, ovsf_mode=cfg.ovsf_mode, batch=B,
                  in_hw=cfg.in_hw, tf32=False, plan=label,
                  plan_path_counts=plan_paths_count, launches=launches,
                  ovsf_gemm_launches_by_kernel=by_kernel_launches,
                  rel_err=rel, cpu_forward_s=t_cpu,
                  wall_ms=eager["wall_ms"], images_s=images_s, graph=graph)
    graph_line = (f"{tag} graph replay ({graph['graphs']} graph): logits "
                  f"bit-equal to eager; wall {graph['wall_ms']:.3f}ms "
                  f"(eager {eager['wall_ms']:.3f}), "
                  f"{B / graph['wall_ms'] * 1e3:.1f} images/s")
    if eager["busy_ms"] is None:
        print(f"{tag} {images_s:.1f} images/s on {card} (wall "
              f"{eager['wall_ms']:.3f}ms per forward); torch.profiler "
              "recorded no device time: device ms and idle share not "
              "measured", flush=True)
        print(graph_line, flush=True)
        return dict(result, busy_ms=None, kernel_ms=None, idle_share=None,
                    top=[])
    print(f"{tag} {images_s:.1f} images/s on {card} (TF32 off): wall "
          f"{eager['wall_ms']:.3f}ms per forward, device busy "
          f"{eager['busy_ms']:.3f}ms, "
          + ", ".join(f"{k} {v:.4f}ms" for k, v in eager["by_kernel"].items())
          + f", idle share {eager['idle_share']:.3f}, "
          f"{eager['kernels']:g} kernels", flush=True)
    for ms, cnt, key in eager["top"]:
        print(f"{tag}   {ms:.4f}ms/forward x{cnt}/forward  {key[:90]}",
              flush=True)
    if graph["busy_ms"] is None:
        print(f"{graph_line}; torch.profiler recorded no device time for "
              "the replays: device ms and idle share not measured",
              flush=True)
    else:
        print(f"{graph_line}; device busy {graph['busy_ms']:.3f}ms (eager "
              f"{eager['busy_ms']:.3f}), idle share "
              f"{graph['idle_share']:.3f} (eager {eager['idle_share']:.3f}),"
              f" {graph['kernels']:g} kernels (eager {eager['kernels']:g}) "
              f"over {graph['windows']} profiled windows each;"
              f" over {n} forwards the hand-written kernels by name "
              f"{graph['own']} (eager equal), the wrappers' counters "
              f"{graph['wrappers']} (eager equal), kernels whose counts "
              f"differ: {graph['kernels_differing']}; a second batch's "
              "graph leaves both batches' logits intact", flush=True)
    return dict(result, busy_ms=eager["busy_ms"],
                kernel_ms=eager["by_kernel"], idle_share=eager["idle_share"],
                top=[dict(ms_per_forward=ms, launches_per_forward=cnt,
                          kernel=key) for ms, cnt, key in eager["top"]])


def forward_wall(call, n: int) -> float:
    """A CNN forward's wall (ms, host clock over n forwards, after two)."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def forward_profile(windows: dict, wall_ms: float, n: int) -> dict:
    """From a route's profiled windows of n forwards (``agreed_windows``)
    and its wall (``forward_wall``): device busy ms (None when the profiler
    records none), the OVSF kernels' ms, kernels launched and idle share,
    per forward."""
    kern, by_name, wrappers = (windows["first"], windows["counts"],
                               windows["wrappers"])
    busy_ms = sum(e.self_device_time_total for e in kern) / n / 1e3
    if not kern or busy_ms <= 0:
        return dict(wall_ms=wall_ms, busy_ms=None, by_kernel=None,
                    idle_share=None, kernels=None, top=[], by_name=None,
                    own=None, wrappers=wrappers, windows=windows["windows"])
    # ovsf_gemm's three kernels are ovsf_gemm_kernel, ovsf_gemm_tc_kernel
    # and ovsf_gemm_mono_kernel
    pats = {"ovsf_decompress": ("ovsf_decompress_kernel",),
            "ovsf_gemm": ("ovsf_gemm_kernel", "ovsf_gemm_tc_kernel",
                          "ovsf_gemm_mono_kernel"),
            "fwht": ("fwht_kernel",)}
    by_kernel = {name: sum(e.self_device_time_total for e in kern
                           if any(q in e.key for q in pats[name])) / n / 1e3
                 for name in pats}
    top = sorted(((e.self_device_time_total / n / 1e3, e.count // n, e.key)
                  for e in kern), reverse=True)[:8]
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, by_kernel=by_kernel,
                idle_share=1.0 - busy_ms / wall_ms,
                kernels=sum(by_name.values()) / n, top=top, by_name=by_name,
                own=own_counts(by_name), wrappers=wrappers,
                windows=windows["windows"])


def cnn_graph_phase(tag: str, params, state, cfg, x, logits, want: dict,
                    n: int, eager_call, eager_wall: float) -> tuple:
    """The same forward through ``cnn.CapturedForward``: the first call
    captures (its eager warm-up and every replay must equal ``logits``, the
    eager forward's, bit for bit), the launch counters zeroed before one
    replay must read ``want``, then its wall, device busy and idle share
    beside ``eager_call``'s (wall ``eager_wall``), both profiled in turn
    (``agreed_windows``); over the profiled forwards, the profiler's
    launches of each hand-written kernel must equal eager's and, in both,
    the wrappers' counters, and all kernels per forward eager's. Returns
    (the graph's results, eager's profile). Last, a second batch
    (one image) is captured and replayed:
    its logits must equal its eager forward's, and the first batch's
    static logits must survive its replays and it those of the first."""
    from repro_torch.models import cnn
    fwd = cnn.CapturedForward(params, state, cfg)
    first = fwd(x).clone()
    reset_wrapper_counts()
    replayed = fwd(x)
    torch.cuda.synchronize()
    launches = wrapper_counts()
    keys = fwd.graphs.keys()
    if keys != [fwd.key(x.shape[0])]:
        raise RuntimeError(f"{tag} graphs {keys}, expected one for "
                           f"{fwd.key(x.shape[0])[:3]}")
    if launches != want:
        raise RuntimeError(f"{tag} one replayed forward launched {launches}"
                           f", expected {want}")
    if not (torch.equal(first, logits) and torch.equal(replayed, logits)):
        raise RuntimeError(f"{tag} graph logits differ from eager: max abs "
                           f"{float((replayed - logits).abs().max()):.3e} "
                           "(must be bit-equal)")
    got_wall = forward_wall(lambda: fwd(x), n)
    windows = agreed_windows({"eager": eager_call, "graph": lambda: fwd(x)},
                             n, f"{tag} forward")
    eager = forward_profile(windows["eager"], eager_wall, n)
    got = forward_profile(windows["graph"], got_wall, n)
    if got["own"] is not None:
        check_own(f"{tag} graph", got["own"], got["wrappers"])
    if eager["own"] is not None:
        check_own(f"{tag} eager", eager["own"], eager["wrappers"])
    if got["own"] != eager["own"] or got["wrappers"] != eager["wrappers"]:
        raise RuntimeError(f"{tag} profiler launches of the hand-written "
                           f"kernels over {n} forwards: graph {got['own']}, "
                           f"eager {eager['own']}; wrappers graph "
                           f"{got['wrappers']}, eager {eager['wrappers']}")
    diff = ("not measured" if got["by_name"] is None
            else count_diff(got["by_name"], eager["by_name"]))
    if got["kernels"] != eager["kernels"]:
        names = [k for k in set(got["by_name"]) | set(eager["by_name"])
                 if got["by_name"].get(k) != eager["by_name"].get(k)]
        each = {k: {r: [c.get(k, 0) for c in windows[r]["each"]]
                    for r in windows} for k in names}
        raise RuntimeError(f"{tag} profiler kernels per forward: graph "
                           f"{got['kernels']}, eager {eager['kernels']}; "
                           f"differing: {diff}; by window: {each}")
    big = fwd(x)
    one = x[:1].clone()
    fwd(one)                            # captures the second batch
    small = fwd(one)
    small_kept = small.clone()
    with torch.no_grad():
        small_eager = cnn.cnn_apply(params, state, cfg, one)[0]
    if not (torch.equal(big, logits) and torch.equal(small, small_eager)):
        raise RuntimeError(f"{tag} batch {x.shape[0]} logits overwritten by "
                           "the batch-1 graph, or batch-1 logits differ from "
                           "eager")
    fwd(x)
    if not torch.equal(small, small_kept) or len(fwd.graphs.keys()) != 2:
        raise RuntimeError(f"{tag} batch-1 logits overwritten by a batch "
                           f"{x.shape[0]} replay (graphs "
                           f"{len(fwd.graphs.keys())})")
    del fwd
    return dict(graphs=1, bit_equal=True, launches=launches,
                kernels_differing=diff, own=got["own"],
                wrappers=got["wrappers"],
                **{k: got[k] for k in ("wall_ms", "busy_ms", "idle_share",
                                       "kernels", "by_kernel", "windows")}
                ), eager


RACE_ROUNDS = 9          # rounds of plan_race: every plan once a round
RACE_REPLAYS = 20        # back-to-back replays a plan is timed over a round


def plan_race(seed: int, dev, arch: str, plans: dict) -> dict:
    """Device ms per forward of one CNN (matrix mode, batch 8, fp32) under
    each ``ExecutionPlan`` of ``plans`` (label -> plan) on the same weights
    and images: each plan's forward captured once (``CapturedForward``),
    then ``RACE_ROUNDS`` rounds that replay every plan's graph
    ``RACE_REPLAYS`` times back to back between CUDA events, the order
    rotated each round; per plan the median of its rounds. Plans timed in
    turn within seconds see the same clocks; the profiled forwards of
    ``cnn_phase``, minutes apart, moved by more than the plans differ (the
    default ResNet-50 plan 6.097-6.230 ms over five runs on one card type
    and limit)."""
    from repro_torch.configs import get_config
    from repro_torch.models import cnn
    B = 8
    cfg = get_config(arch).replace(ovsf_mode="matrix")
    params, state = cnn.cnn_init(cfg, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    x = torch.randn((B, cfg.in_hw, cfg.in_hw, 3), generator=gen, device=dev)
    labels = list(plans)
    graphs = {}
    for label in labels:
        fwd = cnn.CapturedForward(params, state,
                                  cfg.replace(exec_plan=no_cache(plans[label])))
        fwd(x)                              # eager warm-up, then capture
        fwd(x)
        graphs[label] = fwd.graphs._entries[fwd.key(B)].graph
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    rounds = {label: [] for label in labels}
    for r in range(RACE_ROUNDS):
        for label in labels[r % len(labels):] + labels[:r % len(labels)]:
            g = graphs[label]
            g.replay()
            start.record()
            for _ in range(RACE_REPLAYS):
                g.replay()
            end.record()
            end.synchronize()
            rounds[label].append(start.elapsed_time(end) / RACE_REPLAYS)
    del graphs, params, state, x
    torch.cuda.empty_cache()
    return {label: dict(median_ms=statistics.median(ms), ms=ms)
            for label, ms in rounds.items()}


def calibrate_phase(seed: int, card: str, dev, cnns: list, out_dir: str
                    ) -> dict:
    """Per-conv path times of full-width ResNet-50 and SqueezeNet-1.1 into
    an h100 ``CalibrationTable`` (saved to ``out_dir``), then each CNN under
    its calibrated ``ALL_PATHS`` plan through ``cnn_phase``, its device ms
    per forward beside the plans ``cnns`` ran in this run. Then the three
    ResNet-50 plans race in turn (``plan_race``): the calibrated plan's
    median must be at most 1.01x the default plan's and below the
    uncalibrated ``ALL_PATHS`` plan's."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import mapper
    from repro_torch.runtime.calibrate import CalibrationTable
    table = CalibrationTable()
    archs = ("resnet50", "squeezenet1_1")
    rows = {a: cnn_path_times(seed, dev, a, table) for a in archs}
    n_times = sum(len(r) for r in rows.values()) * len(mapper.ALL_PATHS)
    table_path = os.path.join(out_dir, "calibration_h100.json")
    table.save(table_path)
    factors = table.factors("h100")
    print(f"[calibrate] {n_times} (conv, path) device times in the h100 "
          f"table ({len(table)} keys) -> {table_path}", flush=True)
    plans, runs = {}, {}
    for arch in archs:
        plans[arch] = calibrated_cnn_plan(arch, table)
        for r in rows[arch]:
            n = r["conv"]
            print(f"[calibrate {arch}] {n}: uncalibrated {r['plan_path']}, "
                  f"calibrated {plans[arch].plan_for(n).path} (factors "
                  + ", ".join(f"{p} {factors[f'{n}|{p}']:.4f}"
                              for p in mapper.ALL_PATHS) + ")", flush=True)
        runs[arch] = cnn_phase(seed, card, dev, arch, "matrix",
                               plan=plans[arch], label="calibrated ALL_PATHS")
    by_plan = {}
    for arch in archs:
        ran = {c["plan"]: c["busy_ms"] for c in cnns
               if c["arch"] == arch and c["ovsf_mode"] == "matrix"}
        ran["calibrated ALL_PATHS"] = runs[arch]["busy_ms"]
        by_plan[arch] = ran
        print(f"[cnn] {arch} matrix mode, device ms per forward by plan (h100 "
              "target): " + ", ".join(f"{k} {v}" for k, v in ran.items()),
              flush=True)
    cfg50 = get_config("resnet50").replace(ovsf_mode="matrix")
    dflt_label = "+".join(mapper.DEFAULT_PATHS)
    race = plan_race(seed, dev, "resnet50", {
        dflt_label: mapper.plan_cnn(cfg50, batch=8, hw="h100",
                                    paths=mapper.DEFAULT_PATHS),
        "ALL_PATHS": mapper.plan_cnn(cfg50, batch=8, hw="h100",
                                     paths=mapper.ALL_PATHS),
        "calibrated ALL_PATHS": plans["resnet50"]})
    cal, dflt, uncal = (race["calibrated ALL_PATHS"]["median_ms"],
                        race[dflt_label]["median_ms"],
                        race["ALL_PATHS"]["median_ms"])
    print(f"[calibrate] resnet50 plans in turn on {card} ({RACE_ROUNDS} "
          f"rounds of {RACE_REPLAYS} replays, CUDA events), median ms per "
          "forward: " + ", ".join(
              f"{k} {v['median_ms']:.4f} (rounds {min(v['ms']):.4f}-"
              f"{max(v['ms']):.4f})" for k, v in race.items())
          + f"; calibrated / default {cal / dflt:.4f} (limit 1.01)",
          flush=True)
    if not (cal <= 1.01 * dflt and cal < uncal):
        raise RuntimeError(f"calibrated ResNet-50 plan {cal:.4f} ms, default "
                           f"{dflt:.4f}, uncalibrated ALL_PATHS {uncal:.4f} "
                           "(medians of the plans replayed in turn)")
    ratios = {f"{a} {r['conv']}": r["fused"]["vs_library"]
              for a in archs for r in rows[a]}
    print("[calibrate] fused (monolithic tensor-core ovsf_gemm) / matmul on "
          f"the dense W: max {max(ratios.values()):.2f}, "
          f"{sum(v <= 1.0 for v in ratios.values())} of {len(ratios)} convs "
          f"at most 1x, {sum(v <= 2.0 for v in ratios.values())} at most "
          "2x: " + ", ".join(f"{k} {v:.2f}" for k, v in ratios.items()),
          flush=True)
    r50f = [r["fused"] for r in rows["resnet50"]]
    summary = {k: sum(f[k] for f in r50f)
               for k in ("ms", "call_ms", "plain_ms", "library_ms",
                         "bound_ms", "old_bound_ms")}
    summary.update(
        bound_by=("bytes" if all(f["bound_by"] == "bytes" for f in r50f)
                  else "operations"),
        max_abs_err=max(f["max_abs_err"] for f in r50f),
        launches=sum(f["launches"]["ovsf_gemm"] for f in r50f))
    return dict(table_file=os.path.relpath(table_path, ROOT),
                table=table.to_json(), factors=factors, path_times=rows,
                plans={a: {n: lp.path for n, lp in p.entries}
                       for a, p in plans.items()},
                runs=runs, device_ms_by_plan=by_plan, plan_race=race,
                fused_summary=summary)


# -- phase 8: chaos ----------------------------------------------------------

CHAOS_PLAN = ("nan:step=3", "fail:step=7")      # the CI chaos lines' faults
CHAOS_STYLES = {"contiguous window": dict(), "paged window": dict(paged=True)}
CHAOS_ALLOWED = ("eos", "length")


def chaos_specs(cfg, seed: int, n: int = 6, max_new: int = 8,
                buffer: int = 128, sampled=()) -> list:
    """The requests ``launch.serve`` submits for ``--seed``/``--buffer``:
    (rid, prompt, max_new, sampling kw); the rids in ``sampled`` (all of
    them when True) draw at temperature 0.8, top-k 20, seed = rid."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(4, buffer // 4))
        prompt = rng.integers(0, cfg.vocab, plen, dtype=np.int32)
        sp = (dict(temperature=0.8, top_k=20, seed=rid)
              if sampled is True or rid in sampled else {})
        out.append((rid, prompt, max_new, sp))
    return out


def chaos_engine(params, cfg, dev, faults=(), **kw):
    """``LLMEngine`` as ``launch.serve`` builds it (4 slots, buffer 128,
    chunk 8) with ``faults`` armed and ``kw`` on top."""
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.serving import LLMEngine
    args = dict(batch_slots=4, buffer_len=128, chunk_size=8)
    args.update(kw)
    return LLMEngine(params, cfg, device=dev,
                     faults=FaultPlan.parse(faults) if faults else None,
                     **args)


def chaos_submit(eng, specs, fins: list, must_admit: bool = True,
                 **kw) -> list:
    """``specs`` into ``eng``, each request reporting to ``fins``; a
    request refused at submission fails the run unless ``must_admit`` is
    False."""
    from repro_torch.serving import Request, SamplingParams
    reqs = [Request(rid, prompt.copy(), max_new_tokens=max_new,
                    sampling=SamplingParams(**sp), on_finish=fins.append,
                    **kw) for rid, prompt, max_new, sp in specs]
    for r in reqs:
        if not eng.submit(r) and must_admit:
            raise RuntimeError(f"request {r.rid} refused: {r.finish_reason}")
    return reqs


def chaos_decoding(eng, reqs, tag: str) -> None:
    """Step ``eng`` until every request of ``reqs`` has emitted a token."""
    for _ in range(64):
        if all(r.out_tokens for r in reqs):
            return
        eng.step()
    raise RuntimeError(f"{tag} requests still in prefill after 64 steps")


def chaos_outputs(eng, fins: list, rids, tag: str, allowed) -> dict:
    """{rid: (reason, tokens)}: every request of ``rids`` finished exactly
    once (``on_finish`` and ``outputs()``) with a reason in ``allowed``."""
    got = sorted(o.rid for o in fins)
    if got != sorted(rids) or sorted(o.rid for o in eng.outputs()) != got:
        raise RuntimeError(f"{tag} finished {got} (on_finish), "
                           f"{sorted(o.rid for o in eng.outputs())} "
                           f"(outputs); expected each of {sorted(rids)} once")
    outs = {o.rid: (o.finish_reason, list(o.tokens)) for o in fins}
    bad = {r: o[0] for r, o in outs.items() if o[0] not in allowed}
    if bad:
        raise RuntimeError(f"{tag} finish reasons {bad}, allowed {allowed}")
    return outs


def chaos_recovered(eng, tag: str, recoveries: int, stalls: int = 0
                    ) -> None:
    """``eng`` rebuilt its core exactly ``recoveries`` times, ``stalls`` of
    them for a stalled step: a fault the run did not inject, caught by the
    watchdog, fails the run."""
    st = eng.stats
    if (st.recoveries, st.stalls) != (recoveries, stalls):
        raise RuntimeError(f"{tag} recoveries={st.recoveries} stalls="
                           f"{st.stalls}, expected {recoveries} and {stalls}")


def chaos_drain(eng, specs, tag: str, allowed=CHAOS_ALLOWED,
                recoveries: int = 0) -> dict:
    fins: list = []
    chaos_submit(eng, specs, fins)
    eng.run_until_drained(max_steps=2000)
    torch.cuda.synchronize()
    chaos_recovered(eng, tag, recoveries)
    return chaos_outputs(eng, fins, [s[0] for s in specs], tag, allowed)


def chaos_params(seed: int, dev, dtype: str):
    """Full-width TinyLlama-1.1B as ``launch.serve --seed`` builds it."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    cfg = get_config("tinyllama_1_1b")
    cfg = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, alpha_dtype=""),
                      dtype=dtype)
    return cfg, R.model_init(cfg, seed, dev)


def agree(outs: dict, clean: dict) -> list:
    """The rids whose (reason, tokens) equal the fault-free run's."""
    return [r for r in outs if outs[r] == clean[r]]


def chaos_ci_lines(seed: int, dev, cfg, params, x_name: str) -> dict:
    """``ci.yml``'s chaos lines (6 requests, max-new 8, chunk 8, nan at
    step 3, fail at step 7) in the contiguous and the paged window, each
    beside the same run without faults: exactly the request in slot 0 at
    step 3 ends ``error``, one recovery, the graph keys after it the step
    shapes of the fault-free run; fp32: every other stream equal; bf16:
    the count that agree is printed (near-tied logits may part)."""
    res = {}
    for style, kw in CHAOS_STYLES.items():
        tag = f"[chaos {x_name} {style}]"
        specs = chaos_specs(cfg, seed)
        eng = chaos_engine(params, cfg, dev, **kw)
        clean = chaos_drain(eng, specs, f"{tag} fault-free")
        shapes = sorted(eng.core.step_shapes)
        eng.core.close()
        eng = chaos_engine(params, cfg, dev, CHAOS_PLAN, **kw)
        # the nan fault's step 3 precedes the rebuild at step 7, so it runs
        # on the first core
        first_core, core_step, poisoned = eng.core, eng.core.step, []

        def step(so, last=None, _eng=eng):
            if first_core.step_idx == 3:        # the nan fault's step, slot 0
                poisoned.append(_eng.slots[0].rid if _eng.slots[0] else None)
            return core_step(so, last)
        first_core.step = step
        t0 = time.perf_counter()
        outs = chaos_drain(eng, specs, tag, CHAOS_ALLOWED + ("error",), 1)
        wall = time.perf_counter() - t0
        st = eng.stats
        errored = [r for r, o in outs.items() if o[0] == "error"]
        same = agree(outs, clean)
        keys = sorted(eng.core.graphs.keys())
        print(f"{tag} {CHAOS_PLAN}: errored {errored} (slot 0 at step 3: "
              f"{poisoned}), errors={st.errors} recoveries={st.recoveries}; "
              f"{len(same)} of {len(outs) - len(errored)} other streams "
              f"equal the fault-free run's; graphs after recovery {keys}, "
              f"fault-free step shapes {shapes}; {st.steps} steps in "
              f"{wall:.3f}s", flush=True)
        if (st.recoveries, st.errors) != (1, 1) or errored != poisoned:
            raise RuntimeError(f"{tag} errored {errored}, slot 0 at step 3 "
                               f"{poisoned}, recoveries {st.recoveries}")
        if keys != sorted(eng.core.step_shapes) or keys != shapes:
            raise RuntimeError(f"{tag} graphs {keys}, step shapes "
                               f"{sorted(eng.core.step_shapes)}, fault-free "
                               f"{shapes}")
        if x_name == "fp32" and len(same) != len(outs) - 1:
            raise RuntimeError(f"{tag} streams {outs} differ from the "
                               f"fault-free run's {clean}")
        eng.core.close()
        res[style] = dict(errored=errored, errors=st.errors,
                          recoveries=st.recoveries, agree=len(same),
                          others=len(outs) - len(errored), graphs=keys,
                          fault_free_shapes=shapes, steps=st.steps,
                          wall_s=wall, tokens={r: o[1] for r, o in
                                               outs.items()},
                          fault_free_tokens={r: o[1] for r, o in
                                             clean.items()})
    return res


def chaos_nan_only(seed: int, dev, cfg, params) -> dict:
    """``nan:step=3`` alone beside the fault-free run (bf16, contiguous
    window): the same graphs and the same number of captures. Then both
    engines decode three requests, the nan engine's idle slot 3 poisoned
    at every step, and ``agreed_windows`` holds the profiler's kernels per
    replayed step, by name, and the wrappers' counters equal, with no new
    capture."""
    tag = "[chaos bf16 nan only]"
    specs = chaos_specs(cfg, seed)
    engines, runs = {}, {}
    for name, plan in (("fault-free", ()), ("nan", ("nan:step=3",))):
        eng = chaos_engine(params, cfg, dev, plan)
        chaos_drain(eng, specs, f"{tag} {name}", CHAOS_ALLOWED + ("error",))
        runs[name] = dict(graphs=sorted(eng.core.graphs.keys()),
                          captures=eng.stats.warmups, errors=eng.stats.errors)
        engines[name] = eng
    a, b = runs["fault-free"], runs["nan"]
    rng = np.random.default_rng(seed + 5)
    from repro_torch.runtime.faults import FaultPlan
    for name, eng in engines.items():
        reqs = chaos_submit(eng, [(100 + j, rng.integers(
            0, cfg.vocab, 24, dtype=np.int32), 100, {}) for j in range(3)],
            [])
        chaos_decoding(eng, reqs, tag)  # three slots decode, slot 3 idle
        if name == "nan":               # an idle slot's logits, every step
            eng.core.faults = FaultPlan.parse(["nan:step=0,every=1,slot=3"])
    caps_before = {n: e.stats.warmups for n, e in engines.items()}
    windows = agreed_windows({n: e.step for n, e in engines.items()},
                             DECODE_STEPS, tag)
    counts = {n: w["counts"] for n, w in windows.items()}
    new_caps = {n: e.stats.warmups - caps_before[n]
                for n, e in engines.items()}
    kernels = {n: sum(c.values()) / DECODE_STEPS for n, c in counts.items()}
    print(f"{tag} graphs {b['graphs']} ({b['captures']} captures; "
          f"fault-free {a['graphs']}, {a['captures']}), errors "
          f"{b['errors']}; poisoned decode windows: "
          f"{kernels['nan']:g} kernels a step (fault-free "
          f"{kernels['fault-free']:g}), new captures {new_caps}, "
          f"{windows['nan']['windows']} profiled windows", flush=True)
    if (b["graphs"] != a["graphs"] or b["captures"] != a["captures"]
            or b["errors"] != 1 or any(new_caps.values())
            or counts["nan"] != counts["fault-free"]
            or windows["nan"]["wrappers"] != windows["fault-free"]["wrappers"]
            or not counts["nan"]):
        raise RuntimeError(f"{tag} the poison changed the graphs or the "
                           f"launches: {runs}, windows "
                           f"{count_diff(counts['nan'], counts['fault-free'])}"
                           f", new captures {new_caps}")
    for name, eng in engines.items():
        chaos_recovered(eng, f"{tag} {name}", 0)
        eng.core.close()
    return dict(graphs=b["graphs"], captures=b["captures"],
                fault_free_captures=a["captures"],
                wrappers_per_window=windows["nan"]["wrappers"],
                kernels_per_poisoned_step=kernels["nan"],
                fault_free_kernels_per_step=kernels["fault-free"],
                profiled_windows=windows["nan"]["windows"])


def chaos_recoveries(seed: int, dev, cfg, params, card: str) -> dict:
    """``fail:step=5,every=10`` (bf16, contiguous window, max-new 16) over
    at least 3 recoveries, read from the engine's counters: each recovery's
    rebuild ms (``EngineStats.rebuild_s``: the old core freed, the new one
    built), the re-capture ms of each shape on the rebuilt core (its
    ``StepGraphs.first_calls``: warm-up and capture), ``memory_reserved`` before
    and after each rebuild. Every value after a rebuild must equal the one
    after the 1st within the allocator's 2 MiB granularity: a leak per
    recovery of any size fails."""
    tag = "[chaos bf16 recoveries]"
    print(f"{tag} memory_reserved at the start "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.1f} MiB", flush=True)
    eng = chaos_engine(params, cfg, dev, ("fail:step=5,every=10",))
    specs = chaos_specs(cfg, seed, max_new=16)
    fins: list = []
    chaos_submit(eng, specs, fins)
    recs: list = []
    for _ in range(2000):
        st = eng.stats
        reserved, rebuild_s, n = (torch.cuda.memory_reserved(dev),
                                  st.rebuild_s, st.recoveries)
        left = eng.step()
        if st.recoveries != n:
            torch.cuda.synchronize()
            recs.append(dict(
                rebuild_ms=(st.rebuild_s - rebuild_s) * 1e3,
                reserved_before_mib=reserved / 2**20,
                reserved_after_mib=torch.cuda.memory_reserved(dev) / 2**20,
                core=eng.core))
        if left == 0:
            break
    torch.cuda.synchronize()
    n = eng.stats.recoveries
    chaos_recovered(eng, tag, n)
    outs = chaos_outputs(eng, fins, [sp[0] for sp in specs], tag,
                         CHAOS_ALLOWED)
    for r in recs:                      # each rebuilt core's first calls
        r["capture_ms"] = {f"{k[0]} {k[1]}": v * 1e3 for k, v in
                           r.pop("core").graphs.first_calls}
    for i, r in enumerate(recs):
        print(f"{tag} recovery {i + 1}: rebuild {r['rebuild_ms']:.1f} ms, "
              "re-capture " + ", ".join(f"{k} {v:.1f} ms" for k, v in
                                        r["capture_ms"].items())
              + f"; memory_reserved {r['reserved_before_mib']:.1f} -> "
              f"{r['reserved_after_mib']:.1f} MiB ({card})", flush=True)
    if n < 3 or len(recs) != n:
        raise RuntimeError(f"{tag} {n} recoveries ({len(recs)} seen), "
                           "expected at least 3")
    first = recs[0]["reserved_after_mib"]
    grown = [r["reserved_after_mib"] - first for r in recs[1:]]
    pools = recs[1]["reserved_before_mib"] - first
    print(f"{tag} {n} recoveries, {len(outs)} requests finished; reserved "
          f"after each rebuild minus after the 1st {grown} MiB (at most "
          f"2 MiB each); a rebuilt core's pools and step temporaries "
          f"{pools:.1f} MiB", flush=True)
    if any(abs(g) > 2.0 for g in grown):
        raise RuntimeError(f"{tag} memory_reserved after the rebuilds moved "
                           f"{grown} MiB from the 1st's {first:.1f} MiB")
    eng.core.close()
    return dict(recoveries=n, per_recovery=recs, grown_mib=grown,
                one_core_mib=pools)


def chaos_timed_steps(eng) -> list:
    """Step ``eng`` until it is idle; for each step that ran the core:
    (host wall s, first-call s of new shapes, whether it stalled, the
    core's step index it ran)."""
    rows = []
    for _ in range(2000):
        st = eng.stats
        steps, warm, stalls = st.steps, st.warmup_s, st.stalls
        idx = eng.core.step_idx
        t0 = time.perf_counter()
        left = eng.step()
        dt = time.perf_counter() - t0
        if eng.core.step_idx > idx:
            rows.append((dt, eng.stats.warmup_s - warm,
                         eng.stats.stalls > stalls, idx))
        if left == 0:
            return rows
    raise RuntimeError("the engine did not drain in 2000 steps")


def chaos_stall(seed: int, dev, cfg, params, card: str) -> dict:
    """The stall watchdog, fp32 contiguous window, the CI requests. The
    fault-free run, stepped one at a time, gives each step's host wall:
    replayed steps, and the first steps of a shape (warm-up and capture).
    ``step_timeout_s`` lies between them (the geometric mean of the
    slowest replayed and the fastest first step) and ``delay:step=4``
    sleeps 3x it. Then: the delayed step stalls; a step stalls if and only
    if its wall less its first calls exceeds the timeout; every stall
    rebuilds the core once; at least one first step of a shape on the
    rebuilt core took longer than the timeout and did not stall (counted,
    it would rebuild the core again at every first step, without end);
    every request finishes and the streams equal the fault-free run's."""
    tag = "[chaos fp32 stall watchdog]"
    specs = chaos_specs(cfg, seed)
    rids = [sp[0] for sp in specs]
    eng = chaos_engine(params, cfg, dev)
    fins: list = []
    chaos_submit(eng, specs, fins)
    rows = chaos_timed_steps(eng)
    torch.cuda.synchronize()
    chaos_recovered(eng, f"{tag} fault-free", 0)
    clean = chaos_outputs(eng, fins, rids, f"{tag} fault-free",
                          CHAOS_ALLOWED)
    eng.core.close()
    replayed = [w for w, warm, _s, _i in rows if not warm]
    first = [w for w, warm, _s, _i in rows if warm]
    timeout = math.sqrt(max(replayed) * min(first))
    delay = 3 * timeout
    eng = chaos_engine(params, cfg, dev, (f"delay:step=4,s={delay:.6f}",),
                       step_timeout_s=timeout)
    fins = []
    chaos_submit(eng, specs, fins)
    t0 = time.perf_counter()
    rows = chaos_timed_steps(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats
    outs = chaos_outputs(eng, fins, rids, tag, CHAOS_ALLOWED)
    same = agree(outs, clean)
    # first calls alone longer than the timeout, and no stall counted
    spared = [warm for _w, warm, stalled, _i in rows
              if warm > timeout and not stalled]
    # a stall counted for a step whose wall less its first calls was short
    wrong = [(w, warm) for w, warm, stalled, _i in rows
             if stalled and w - warm <= timeout]
    delayed = [stalled for _w, _warm, stalled, i in rows if i == 4]
    print(f"{tag} timeout {timeout * 1e3:.3f} ms (replayed steps "
          f"{min(replayed) * 1e3:.3f}-{max(replayed) * 1e3:.3f} ms, first "
          f"steps of a shape {[round(w * 1e3, 1) for w in first]} ms), delay "
          f"{delay * 1e3:.3f} ms at step 4: stalls={st.stalls} recoveries="
          f"{st.recoveries}; {st.warmups} first steps of a shape off the "
          f"stall clock ({st.warmup_s * 1e3:.1f} ms), {len(spared)} of them "
          f"longer than the timeout alone "
          f"({[round(w * 1e3, 1) for w in spared]} ms); {len(same)} of {len(outs)} streams equal the fault-free "
          f"run's; {st.steps} steps in {wall:.3f}s ({card})", flush=True)
    if (delayed != [True] or wrong or not spared or not st.stalls
            or st.recoveries != st.stalls or outs != clean):
        raise RuntimeError(f"{tag} delayed step stalled {delayed}, steps "
                           f"against the clock {wrong}, first steps spared "
                           f"{spared}, stalls {st.stalls}, recoveries "
                           f"{st.recoveries}, streams {outs} vs {clean}")
    eng.core.close()
    return dict(timeout_ms=timeout * 1e3,
                replayed_step_ms=[w * 1e3 for w in replayed],
                first_step_ms=[w * 1e3 for w in first],
                spared_first_step_ms=[w * 1e3 for w in spared],
                stalls=st.stalls, recoveries=st.recoveries,
                warmups=st.warmups, warmup_ms=st.warmup_s * 1e3,
                agree=len(same))


def chaos_capture_failure(seed: int, dev, cfg, params, clean: dict) -> dict:
    """fp32 contiguous window, no faults: the first core's window body
    raises on its first call under capture (after its eager warm-up). The
    engine recovers, no stream is left capturing, the caller's stream is
    current again, and the streams equal the fault-free run's (``clean``)."""
    tag = "[chaos fp32 capture failure]"
    eng = chaos_engine(params, cfg, dev)
    body, raised = eng.core._window_body, []

    def failing(bufs):
        if torch.cuda.is_current_stream_capturing() and not raised:
            raised.append(1)
            raise RuntimeError("injected failure under capture")
        return body(bufs)
    eng.core._window_body = failing
    outs = chaos_drain(eng, chaos_specs(cfg, seed), tag, recoveries=1)
    capturing = torch.cuda.is_current_stream_capturing()
    stream_ok = torch.cuda.current_stream(dev) == torch.cuda.default_stream(
        dev)
    keys = sorted(eng.core.graphs.keys())
    print(f"{tag} raised under capture {len(raised)}x, recoveries "
          f"{eng.stats.recoveries}, capturing after {capturing}, default "
          f"stream current {stream_ok}, graphs {keys}; "
          f"{len(agree(outs, clean))} of {len(outs)} streams equal the "
          "fault-free run's", flush=True)
    if (not raised or eng.stats.recoveries != 1 or capturing or not stream_ok
            or outs != clean or keys != sorted(eng.core.step_shapes)):
        raise RuntimeError(f"{tag} did not recover cleanly: {outs} vs "
                           f"{clean}")
    eng.core.close()
    return dict(raised=len(raised), recoveries=eng.stats.recoveries,
                graphs=keys, agree=len(outs))


def chaos_preempt(seed: int, dev, cfg, params) -> dict:
    """fp32 paged packed, odd rids sampled: (a) a pool of 8 pages (one
    slot's buffer) under 6 requests of max-new 16, the page gate must
    preempt; (b) ``admission="preempt"`` and a priority-5 request arriving
    once four requests decode. Streams equal the runs never preempted
    (default pool; ``admission="reject"``); the extra prompt tokens the
    recompute cost are printed."""
    res = {}
    sampled = (1, 3, 5)
    paged = dict(paged=True, packed=True)
    specs = chaos_specs(cfg, seed, max_new=16, sampled=sampled)
    for case, kw in (("page gate", dict(kv_pages=8)),
                     ("admission preempt", dict(admission="preempt"))):
        tag = f"[chaos fp32 paged packed, {case}]"
        runs = {}
        for name, extra in (("never preempted", {}), ("preempted", kw)):
            eng = chaos_engine(params, cfg, dev, **paged, **extra)
            if case == "page gate":
                outs = chaos_drain(eng, specs, f"{tag} {name}")
            else:
                fins: list = []
                chaos_decoding(eng, chaos_submit(eng, specs[:4], fins), tag)
                late = (9, np.random.default_rng(seed + 9).integers(
                    0, cfg.vocab, 20, dtype=np.int32), 8, {})
                chaos_submit(eng, [late], fins, priority=5)
                eng.run_until_drained(max_steps=2000)
                torch.cuda.synchronize()
                chaos_recovered(eng, f"{tag} {name}", 0)
                outs = chaos_outputs(eng, fins, [0, 1, 2, 3, 9],
                                     f"{tag} {name}", CHAOS_ALLOWED)
            runs[name] = dict(outs=outs, st=dataclasses.replace(eng.stats))
            eng.core.close()
        a, b = runs["never preempted"], runs["preempted"]
        extra_tokens = b["st"].chunk_tokens - a["st"].chunk_tokens
        same = agree(b["outs"], a["outs"])
        print(f"{tag} preemptions={b['st'].preemptions}; {len(same)} of "
              f"{len(b['outs'])} streams (greedy and sampled) equal the "
              f"never-preempted run's; recompute cost {extra_tokens} extra "
              f"prompt tokens ({b['st'].chunk_tokens} vs "
              f"{a['st'].chunk_tokens}); peak pages {b['st'].kv_pages_used}"
              f" of {b['st'].kv_pages_total}", flush=True)
        if b["st"].preemptions < 1 or len(same) != len(b["outs"]):
            raise RuntimeError(f"{tag} preemptions {b['st'].preemptions}, "
                               f"streams {b['outs']} vs {a['outs']}")
        res[case] = dict(preemptions=b["st"].preemptions,
                         extra_prompt_tokens=extra_tokens,
                         chunk_tokens=b["st"].chunk_tokens,
                         never_preempted_chunk_tokens=a["st"].chunk_tokens,
                         agree=len(same), requests=len(b["outs"]))
    return res


def chaos_lifetimes(seed: int, dev, cfg, params) -> dict:
    """bf16 paged packed with ``max_waiting=2``: of four requests submitted
    at once two are shed; once the first two decode, one's deadline passes
    (``timeout`` out of its slot, tokens kept) and the other is cancelled
    (``cancelled``, its pages back at once); a queued request is cancelled
    too. Each request finishes once, with its reason."""
    tag = "[chaos bf16 deadlines, shedding, cancellation]"
    eng = chaos_engine(params, cfg, dev, paged=True, packed=True,
                       max_waiting=2)
    specs = chaos_specs(cfg, seed, max_new=32)
    fins: list = []
    reqs = chaos_submit(eng, specs[:4], fins, must_admit=False)
    shed = [o.rid for o in fins]
    for _ in range(12):
        eng.step()
        if all(len(r.out_tokens) > 1 for r in reqs[:2]):
            break
    more = chaos_submit(eng, specs[4:], fins)
    pager = eng.core.pager
    slot = next(i for i, r in enumerate(eng.slots) if r is reqs[1])
    pages = len(pager.slot_pages(slot))
    used = pager.used_pages
    cancelled = eng.cancel(reqs[1])
    freed = used - pager.used_pages
    queued = eng.cancel(more[1])        # still waiting: withdrawn
    reqs[0].deadline_s = time.perf_counter() - reqs[0].t_submit
    eng.run_until_drained(max_steps=2000)
    torch.cuda.synchronize()
    chaos_recovered(eng, tag, 0)
    outs = chaos_outputs(eng, fins, [s[0] for s in specs], tag,
                         CHAOS_ALLOWED + ("shed", "timeout", "cancelled"))
    reasons = {r: o[0] for r, o in sorted(outs.items())}
    want = {0: "timeout", 1: "cancelled", 2: "shed", 3: "shed",
            4: "length", 5: "cancelled"}
    st = eng.stats
    print(f"{tag} reasons {reasons}; shed at submission {shed}; the "
          f"cancelled running request freed {freed} of its {pages} pages at "
          f"once; timed-out tokens {len(outs[0][1])} of 32; counters "
          f"timeouts={st.timeouts} shed={st.shed} cancelled={st.cancelled}",
          flush=True)
    if (reasons != want or not cancelled or not queued or freed != pages
            or not 0 < len(outs[0][1]) < 32 or pager.used_pages
            or (st.timeouts, st.shed, st.cancelled) != (1, 2, 2)):
        raise RuntimeError(f"{tag} reasons {reasons}, expected {want}; "
                           f"freed {freed} of {pages} pages")
    eng.core.close()
    return dict(reasons=reasons, freed_pages=freed,
                timed_out_tokens=len(outs[0][1]))


def journal_records(path: str) -> dict:
    """rid -> the number of records in the journal at ``path`` that carry a
    terminal reason (``fin`` records and compacted snapshots)."""
    from repro_torch.serving.journal import _iter_records
    count: dict = {}
    for seg in sorted(os.listdir(path)):
        with open(os.path.join(path, seg), "rb") as f:
            for rec in _iter_records(f.read()):
                if rec.get("t") == "fin" or (rec.get("t") == "entry"
                                             and "reason" in rec):
                    count[rec["rid"]] = count.get(rec["rid"], 0) + 1
    return count


def chaos_kill9_start(seed: int, x_name: str, out_dir: str) -> dict:
    """``ci.yml``'s kill-9 line at full width on the card, started as a
    subprocess in a session of its own (``--supervise`` starts a child):
    ``python -m repro_torch.launch.serve --arch tinyllama_1_1b --requests 6
    --max-new 8 --chunk-size 8 --temperature 0.8 --top-k 20 --journal DIR
    --supervise --inject die:step=3`` (``--dtype float32`` for the fp32
    run); its output to a log under ``out_dir``. ``chaos_kill9_finish``
    waits for it."""
    import shutil
    jdir = os.path.join(out_dir, f"chaos_journal_{x_name}")
    shutil.rmtree(jdir, ignore_errors=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "tinyllama_1_1b", "--requests", "6", "--max-new", "8",
           "--chunk-size", "8", "--temperature", "0.8", "--top-k", "20",
           "--seed", str(seed), "--journal", jdir, "--supervise",
           "--inject", "die:step=3"]
    if x_name == "fp32":
        cmd += ["--dtype", "float32"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    path = os.path.join(out_dir, f"chaos_kill9_{x_name}.log")
    log = open(path, "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                            stderr=subprocess.STDOUT,
                            start_new_session=True)
    return dict(x_name=x_name, proc=proc, t0=time.perf_counter(),
                jdir=jdir, path=path, log=log)


def chaos_kill9_stop(runs) -> None:
    """Stop every process the kill-9 lines started (each line's
    session)."""
    import signal
    for run in runs:
        if run["proc"].poll() is None:
            try:
                os.killpg(run["proc"].pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        run["proc"].wait()
        run["log"].close()


def chaos_kill9_finish(run: dict, clean: dict) -> dict:
    """Wait for a kill-9 line (``chaos_kill9_start``): it must exit 0 with
    each request finished exactly once in its journal; its streams are
    held against ``clean``, the same requests in this process without the
    kill (``chaos_drain`` of the sampled specs): equal in fp32, the count
    that agree printed in bf16 (the recomputed context rounds otherwise
    than the first pass did)."""
    import shutil
    from repro_torch.serving import RequestJournal
    x_name, proc, jdir = run["x_name"], run["proc"], run["jdir"]
    tag = f"[chaos {x_name} kill-9]"
    try:
        rc = proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        chaos_kill9_stop([run])
        raise RuntimeError(f"{tag} still running after 600 s")
    wall = time.perf_counter() - run["t0"]
    run["log"].close()
    with open(run["path"]) as f:
        log = f.read()
    if rc != 0 or "restart #1" not in log:
        raise RuntimeError(f"{tag} exit {rc}:\n{log[-4000:]}")
    fins = journal_records(jdir)
    entries = {rid: (e.finish_reason, list(e.tokens)) for rid, e in
               RequestJournal(jdir).entries.items()}
    shutil.rmtree(jdir, ignore_errors=True)
    same = agree(entries, clean)
    recovered = [ln for ln in log.splitlines() if "[serve] journal:" in ln]
    print(f"{tag} exit 0 in {wall:.1f}s (started beside the phase); "
          f"{recovered}; terminal records per request {fins}; {len(same)} "
          f"of {len(entries)} streams equal the run without the kill",
          flush=True)
    if (sorted(entries) != list(range(6)) or fins != {r: 1 for r in range(6)}
            or any(e[0] != "length" or len(e[1]) != 8
                   for e in entries.values())):
        raise RuntimeError(f"{tag} journal {entries}, terminal records "
                           f"{fins}")
    if x_name == "fp32" and len(same) != 6:
        raise RuntimeError(f"{tag} streams {entries} differ from the run "
                           f"without the kill {clean}")
    return dict(wall_s=wall, agree=len(same), terminal_records=fins,
                recovered=recovered, tokens={r: e[1] for r, e in
                                             entries.items()},
                fault_free_tokens={r: o[1] for r, o in clean.items()})


def chaos_kill9_clean(seed: int, dev, cfg, params, x_name: str) -> dict:
    """The kill-9 line's requests served in this process without a kill:
    {rid: (finish reason, tokens)}."""
    eng = chaos_engine(params, cfg, dev)
    clean = chaos_drain(eng, chaos_specs(cfg, seed, sampled=True),
                        f"[chaos {x_name} kill-9] fault-free")
    eng.core.close()
    return clean


def chaos_journal_cost(seed: int, dev, cfg, params, out_dir: str,
                       card: str) -> dict:
    """The replayed chunk-free step wall of the bf16 paged packed engine
    with ``--journal`` and without, in turns over the same kind of work:
    four requests decoding (the chunk-free graph already captured), windows
    of 16 steps, A B B A A B B A. Each journaled step writes four ``tok``
    records and one fsync."""
    import shutil
    from repro_torch.serving import RequestJournal
    tag = "[chaos bf16 journal cost]"
    jdir = os.path.join(out_dir, "chaos_journal_cost")
    shutil.rmtree(jdir, ignore_errors=True)
    journal = RequestJournal(jdir)
    engines = {"no journal": chaos_engine(params, cfg, dev, paged=True,
                                          packed=True),
               "journal": chaos_engine(params, cfg, dev, paged=True,
                                       packed=True, journal=journal)}
    rng = np.random.default_rng(seed + 3)
    for eng in engines.values():
        reqs = chaos_submit(eng, [(j, rng.integers(0, cfg.vocab, 24,
                                                   dtype=np.int32), 96, {})
                                  for j in range(4)], [])
        chaos_decoding(eng, reqs, tag)  # every slot decodes
        for _ in range(2):              # the chunk-free shape captured
            eng.step()
    walls: dict = {n: [] for n in engines}
    for name in ("no journal", "journal", "journal", "no journal") * 2:
        eng = engines[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            eng.step()
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) / 16 * 1e3)
    flushes = journal.flushes
    for name, eng in engines.items():
        eng.run_until_drained(max_steps=2000)
        chaos_recovered(eng, f"{tag} {name}", 0)
        eng.core.close()
    journal.close()
    shutil.rmtree(jdir, ignore_errors=True)
    med = {n: float(np.median(w)) for n, w in walls.items()}
    print(f"{tag} chunk-free step wall, median of 4 windows of 16 steps: "
          f"{med['journal']:.3f} ms with the journal ({flushes} flushes), "
          f"{med['no journal']:.3f} ms without, +"
          f"{med['journal'] - med['no journal']:.3f} ms ({card}); windows "
          f"{ {n: [round(x, 3) for x in w] for n, w in walls.items()} }",
          flush=True)
    return dict(step_ms=med, windows_ms=walls, flushes=flushes)


def chaos_phase(seed: int, card: str, dev, out_dir: str) -> dict:
    """Phase 8 (module docstring): the fault paths of ``LLMEngine`` at full
    width, every step replayed from CUDA graphs."""
    t0 = time.perf_counter()
    res = {}
    cfg, params = chaos_params(seed, dev, "float32")
    res["ci_fp32"] = chaos_ci_lines(seed, dev, cfg, params, "fp32")
    clean = {r: ("length", t) for r, t in
             res["ci_fp32"]["contiguous window"]["fault_free_tokens"].items()}
    res["capture_failure"] = chaos_capture_failure(seed, dev, cfg, params,
                                                   clean)
    res["stall"] = chaos_stall(seed, dev, cfg, params, card)
    # the kill-9 lines run beside the rest of the phase (the stall
    # watchdog's timed steps are done; the journal's cost is timed after
    # they end)
    kills = [chaos_kill9_start(seed, x, out_dir) for x in ("fp32", "bf16")]
    try:
        res["preempt"] = chaos_preempt(seed, dev, cfg, params)
        clean = {"fp32": chaos_kill9_clean(seed, dev, cfg, params, "fp32")}
        del params
        torch.cuda.empty_cache()
        cfg, params = chaos_params(seed, dev, "bfloat16")
        res["ci_bf16"] = chaos_ci_lines(seed, dev, cfg, params, "bf16")
        res["nan_only"] = chaos_nan_only(seed, dev, cfg, params)
        res["recoveries"] = chaos_recoveries(seed, dev, cfg, params, card)
        res["lifetimes"] = chaos_lifetimes(seed, dev, cfg, params)
        clean["bf16"] = chaos_kill9_clean(seed, dev, cfg, params, "bf16")
        for run in kills:
            res[f"kill9_{run['x_name']}"] = chaos_kill9_finish(
                run, clean[run["x_name"]])
    except BaseException:
        chaos_kill9_stop(kills)
        raise
    res["journal_cost"] = chaos_journal_cost(seed, dev, cfg, params,
                                             out_dir, card)
    del params
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t0
    print(f"[chaos] phase passed in {res['wall_s']:.1f}s", flush=True)
    return res


# -- phase 9: gateway --------------------------------------------------------

# qwen2_5_14b's OVSF projections (d 5120, d_ff 13824, 40 x 128 query and
# 8 x 128 key/value heads: k and v are OVSF too, 1024 >= min_dim 512)
QWEN_LAYER = {"q": (5120, 5120), "k": (5120, 1024), "v": (5120, 1024),
              "o": (5120, 5120), "gate": (5120, 13824),
              "up": (5120, 13824), "down": (13824, 5120)}
QWEN_FLASH_CASES = (("qwen window decode", 4, 40, 8, 128, 128,
                     (1, 33, 100, 128)),
                    ("qwen packed", 64, 40, 8, 128, 128, None))
# the depth of the fp32 TinyLlama pair (over 2 replicas, then the flip +
# scrub repairs, each reloading the pair), cut for the script's time; the
# bf16 pair runs all 22
GATEWAY_FP32_LAYERS = SERVE_CUT_LAYERS
QWEN_LAYERS = 6             # the depth phase 9 serves qwen2_5_14b at
                            # (48 before its run shared the time limit with
                            # phase 11, 12 before phase 13; full width
                            # either way)
GATEWAY_MODELS = (("tinyllama_1_1b", "tl-a", 0),
                  ("tinyllama_1_1b", "tl-b", 1),
                  ("qwen2_5_14b", "qw", 0))
GATEWAY_KW = dict(batch_slots=4, buffer_len=128, chunk_size=8)
SCRUB_REPAIRS = 4           # flip + scrub repair cycles of the memory gate
GATEWAY_CI = "tinyllama_1_1b:tl-a,tinyllama_1_1b:tl-b,qwen2_5_14b:qw"
# ci.yml:80, :81, :99 and :113 (``--hw cpu`` is the reference's; the port's
# launcher runs on the card by default)
GATEWAY_CI_LINES = {
    "ci.yml:80 smoke": ["--models", GATEWAY_CI, "--chunk-size", "8",
                        "--self-test", "8"],
    "ci.yml:81 nan scoped to qw": [
        "--models", GATEWAY_CI, "--chunk-size", "8", "--self-test", "8",
        "--inject", "nan:step=3", "--inject-model", "qw"],
    "ci.yml:99 fleet chaos": [
        "--models", GATEWAY_CI, "--chunk-size", "8", "--max-new", "8",
        "--replicas", "2", "--dead-after", "1", "--scrub-every", "2",
        "--inject", "fail:step=2", "--inject", "flip:step=3",
        "--inject-model", "tl-a", "--self-test", "12"],
}
GATEWAY_KILL9 = ["--models", "tinyllama_1_1b:tl-a,tinyllama_1_1b:tl-b",
                 "--chunk-size", "8", "--max-new", "8", "--supervise",
                 "--self-test", "6", "--inject", "die:step=5", "--port", "0"]


def run_qwen_checks(rng, dev) -> dict:
    """Phase 9 (1): ``ovsf_gemm`` (bf16 x and alphas, 16-long segments) at
    qwen2_5_14b's projection shapes, M 4 and 64, each on the tensor-core
    kernel, and ``flash_decode_attn`` at its head layout (H 40, Hkv 8, hd
    128), bf16 and fp32, against their plain versions; the summary rows of
    the kernels line: one layer's seven projections at M 4, and the window
    decode in bf16."""
    rows = [gemm_row(rng, dev, 16, M, K, N, torch.bfloat16, "",
                     "ovsf_gemm_qwen")
            for M in (4, 64) for (K, N) in sorted(set(QWEN_LAYER.values()))]
    off = [r["case"] for r in rows if r["kernel"] != "tensor_core"]
    if off:
        raise RuntimeError(f"[gateway kernel] not on the tensor-core "
                           f"ovsf_gemm: {off}")
    gemm = {}
    for M in (4, 64):
        pick = {(r["K"], r["N"]): r for r in rows if r["M"] == M}
        s = {key: sum(pick[kn][key] for kn in QWEN_LAYER.values())
             for key in ("ms", "call_ms", "plain_ms", "library_ms",
                         "bound_ms")}
        s["bound_by"] = ("bytes" if all(pick[kn]["bound_by"] == "bytes"
                                        for kn in QWEN_LAYER.values())
                         else "operations")
        gemm[M] = s
        print(f"[gateway kernel] ovsf_gemm qwen2_5_14b layer (q, k, v, o, "
              f"gate, up, down) M={M} bf16: {s['ms']:.4f}ms, matmul on "
              f"dense W {s['library_ms']:.4f}ms, bound {s['bound_ms']:.4f}ms "
              f"({s['bound_by']})", flush=True)
    gemm_summary = dict(gemm[4], layer_M64=gemm[64],
                        max_abs_err=max(r["max_abs_err"] for r in rows))
    flash = []
    for label0, B, H, Hkv, hd, T, pos in QWEN_FLASH_CASES:
        for dt in (torch.bfloat16, torch.float32):
            flash.append(flash_row(rng, dev, label0, B, H, Hkv, hd, T, pos,
                                   dt))
        torch.cuda.empty_cache()
    flash_summary = dict(next(r for r in flash if "window" in r["case"]
                              and "bfloat16" in r["dtype"]))
    flash_summary["max_abs_err"] = max(r["max_abs_err"] for r in flash)
    return dict(gemm_rows=rows, gemm_summary=gemm_summary, flash_rows=flash,
                flash_summary=flash_summary)


def run_multi_checks(rng, dev) -> list:
    """``ovsf_matmul_multi`` over M = 2 stacked variants at TinyLlama-1.1B's
    q (2048 -> 2048) and down (5632 -> 2048) shapes, 16-long segments at rho
    0.5, T 8 and 64, bf16 and fp32: every token's row must equal
    ``spectral_matmul`` of its variant on the same x, bit for bit."""
    from repro_torch.kernels.ops import ovsf_matmul_multi, spectral_matmul
    rows = []
    for K, N in ((2048, 2048), (5632, 2048)):
        ns = K // 16
        idx = torch.from_numpy(np.stack([np.sort(rng.choice(16, 8,
                                                            replace=False))
                                         for _ in range(ns)]).astype(np.int32)
                               ).to(dev)
        for T in (8, 64):
            for dt in (torch.bfloat16, torch.float32):
                x = torch.randn((T, K), device=dev).to(dt)
                al = (torch.randn((2, ns * 8, N), device=dev)
                      / math.sqrt(K * 8)).to(dt)
                mids = torch.from_numpy(rng.integers(0, 2, T).astype(
                    np.int32)).to(dev)
                y = ovsf_matmul_multi(x, al, idx, mids)
                for m in range(2):
                    sel = mids == m
                    if not torch.equal(y[sel],
                                       spectral_matmul(x, al[m], idx)[sel]):
                        raise RuntimeError(
                            f"[gateway kernel] ovsf_matmul_multi {K}->{N} "
                            f"T={T} {dt}: variant {m}'s rows differ from "
                            "spectral_matmul")
                rows.append(dict(K=K, N=N, T=T, dtype=str(dt), equal=True))
    print(f"[gateway kernel] ovsf_matmul_multi equals spectral_matmul bit "
          f"for bit in {len(rows)} cases (M 2, TinyLlama q and down, T 8 and "
          "64, bf16 and fp32)", flush=True)
    return rows


def run_cache_check(dev) -> dict:
    """The decompress-weight cache on the card: a ``materialize`` plan with
    ``cache_weights`` (one ResNet-50 s1 conv's GEMM, fp32, monolithic
    codes) generates W once (one ``ovsf_decompress`` launch), a second
    eager call hits (no launch, equal output); captured into a CUDA graph
    the call bypasses the cache (one launch a replay, equal output), and
    the counters of its label read 1 miss and 2 hits (the second call and
    the capture's eager warm-up)."""
    from repro_torch.kernels import ops
    from repro_torch.runtime.graphs import StepGraphs
    from repro_torch.runtime.mapper import LayerPlan
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((512, 576), generator=gen, device=dev)
    al = torch.randn((512, 64), generator=gen, device=dev) / 24.0
    idx = torch.sort(torch.randperm(1024, generator=gen, device=dev)[:512]
                     ).values.to(torch.int32)
    plan = LayerPlan("materialize", cache_weights=True,
                     cache_key="s1b0c2")
    label = "chip-smoke cache check"
    ops.clear_weight_cache(label)
    with ops.weight_cache_scope(label):
        y1, l1 = path_launches(lambda: ops.ovsf_matmul(x, al, idx,
                                                       plan=plan))
        y2, l2 = path_launches(lambda: ops.ovsf_matmul(x, al, idx,
                                                       plan=plan))
        sg = StepGraphs(dev)
        body = lambda a: (ops.ovsf_matmul(a["x"], al, idx, plan=plan),)
        sg.run("cache", {"x": x}, body)
        y3, l3 = path_launches(lambda: sg.run("cache", {"x": x}, body)[0])
        stats = ops.weight_cache_stats(label)
    sg.clear()
    ops.clear_weight_cache(label)
    want = {"entries": 1, "hits": 2, "misses": 1}
    got = {k: stats[k] for k in want}
    ok = (l1["ovsf_decompress"] == 1 and l2["ovsf_decompress"] == 0
          and l3["ovsf_decompress"] == 1 and torch.equal(y1, y2)
          and torch.equal(y1, y3) and got == want)
    print(f"[gateway kernel] decompress cache on the card: launches "
          f"{l1['ovsf_decompress']} (miss) / {l2['ovsf_decompress']} (hit) "
          f"/ {l3['ovsf_decompress']} a replay (capture bypasses it), "
          f"counters {got}, outputs equal: {ok}", flush=True)
    if not ok:
        raise RuntimeError(f"decompress cache: launches {l1} {l2} {l3}, "
                           f"counters {got} (want {want})")
    return dict(launches=[l1, l2, l3], counters=got)


def gateway_registry(seed: int, dev, dtype: str, models, qwen_layers: int,
                     tl_layers: int = 0):
    """A ``ModelRegistry`` of ``models`` ((arch, alias, occurrence)) at full
    width in ``dtype``, loaded by the launcher's seeded loaders on the card
    (occurrence k > 0: ``make_alpha_variant`` of the base); qwen2_5_14b at
    ``qwen_layers`` layers, TinyLlama at ``tl_layers`` (0: all 22)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.gateway import make_loader
    from repro_torch.serving import ModelRegistry
    reg = ModelRegistry()
    for arch, alias, k in models:
        cfg = get_config(arch).replace(dtype=dtype)
        if arch == "qwen2_5_14b":
            cfg = cfg.replace(n_layers=qwen_layers)
        elif tl_layers:
            cfg = cfg.replace(n_layers=tl_layers)
        reg.register(alias, cfg, make_loader(cfg, seed, k, dev),
                     tags=(arch, f"variant-{k}"))
    return reg


def gateway_specs(seed: int, names: list, vocab: int, n: int = 12,
                  max_new: int = 16) -> list:
    """n requests round-robin over ``names``: (rid, model, prompt of 8-40
    tokens below ``vocab``, max_new, sampling kw); every third sampled
    (temperature 0.8, top-k 40, seed = rid)."""
    rng = np.random.default_rng(seed + 9)
    return [(rid, names[rid % len(names)],
             rng.integers(0, vocab, int(rng.integers(8, 41)),
                          dtype=np.int32), max_new,
             dict(temperature=0.8, top_k=40, seed=rid) if rid % 3 == 2
             else {})
            for rid in range(n)]


def gateway_requests(specs, fins: list) -> list:
    from repro_torch.serving import Request, SamplingParams
    return [Request(rid, prompt, max_new_tokens=max_new, model=model,
                    sampling=SamplingParams(**sp), on_finish=fins.append)
            for rid, model, prompt, max_new, sp in specs]


def gateway_outputs(fins: list, specs, tag: str) -> dict:
    """{rid: tokens}: every request finished exactly once, eos or length."""
    got = sorted(o.rid for o in fins)
    if got != sorted(r[0] for r in specs):
        raise RuntimeError(f"{tag} finished {got}: not each request once")
    bad = {o.rid: o.finish_reason for o in fins
           if o.finish_reason not in ("eos", "length")}
    if bad:
        raise RuntimeError(f"{tag} finish reasons {bad}")
    return {o.rid: list(o.tokens) for o in fins}


def gateway_drive(reg, dev, specs, tag: str, count: bool = True,
                  engine_kw: dict = GATEWAY_KW, **kw) -> tuple:
    """A ``ServingGateway`` over ``reg`` (``engine_kw``: 4 slots, buffer
    128, chunk 8; every step replayed from CUDA graphs) serving ``specs``:
    (gateway, streams, wall s, per-engine counts). With ``count`` each
    engine's core step is wrapped to count its steps, its chunk-free steps
    and its kernels' launches (the wrappers' counters, zeroed just before
    the run)."""
    from repro_torch.serving import ServingGateway
    gw = ServingGateway(reg, device=dev, **engine_kw, **kw)
    fins: list = []
    reqs = gateway_requests(specs, fins)
    t0 = time.perf_counter()
    for r in reqs:
        if not gw.add_request(r)[0]:
            raise RuntimeError(f"{tag} request {r.rid} was not admitted")
    per = {}
    for rs in (gw._groups.values() if count else ()):
        for eng in rs.engines:
            key = eng.model_label
            per[key] = dict(steps=0, chunk_free=0, launches={},
                            variants=eng.variants)
            core_step = eng.core.step

            def counted(so, last=None, _f=core_step, _k=key):
                before = wrapper_counts()
                out = _f(so, last)
                after = wrapper_counts()
                c = per[_k]
                c["steps"] += 1
                c["chunk_free"] += not so.chunks
                for w in after:
                    c["launches"][w] = (c["launches"].get(w, 0)
                                        + after[w] - before[w])
                return out
            eng.core.step = counted
    reset_wrapper_counts()
    gw.run_until_drained(max_steps=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rs in (gw._groups.values() if count else ()):
        for eng in rs.engines:
            # the wrapper holds the core: unwrap, so that a closed engine's
            # params die with it (no reference cycle waits for the GC)
            eng.core.__dict__.pop("step", None)
    return gw, gateway_outputs(fins, specs, tag), wall, per


def dedicated_streams(reg, names, dev, specs, tag: str,
                      engine_kw: dict = GATEWAY_KW, **kw) -> dict:
    """Each of ``names`` alone in a dedicated ``LLMEngine`` on its resident
    params (``engine_kw``), the spectral path pinned (``use_mapper=False``,
    ``exec_path="spectral"``), serving its share of ``specs``."""
    from repro_torch.serving import LLMEngine
    out = {}
    for name in names:
        e = reg.entries[name]
        cfg = e.cfg.replace(ovsf=dataclasses.replace(e.cfg.ovsf,
                                                     exec_path="spectral"))
        eng = LLMEngine(e.params, cfg, device=dev, use_mapper=False,
                        **engine_kw, **kw)
        mine = [s for s in specs if s[1] == name]
        fins: list = []
        for r in gateway_requests(mine, fins):
            eng.submit(r)
        eng.run_until_drained(max_steps=4000)
        out.update(gateway_outputs(fins, mine, f"{tag} dedicated {name}"))
        eng.core.close()
    return out


def close_gateway(gw) -> None:
    for g in list(gw._groups):
        gw._drop_group(g)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def multi_decode_profile(eng, seed: int, card: str, n_layers: int) -> dict:
    """Re-routing and the replayed multi step: four requests (tl-b, tl-a,
    tl-b, tl-a: each slot on the other variant than in the run before) of
    48 prompt tokens straight into the stacked engine must capture nothing;
    then ``DECODE_STEPS`` chunk-free steps timed (host wall) and profiled
    (``agreed_windows``): the hand-written kernels' launches by name equal
    the wrappers' counters, one ``flash_decode_attn`` a layer a step (22)
    and no ``ovsf_gemm``; idle share = 1 - device busy / wall."""
    from repro_torch.serving import Request
    tag = "[gateway bf16 multi]"
    keys = sorted(eng.core.graphs.keys())
    first = len(eng.core.graphs.first_calls)
    rng = np.random.default_rng(seed + 5)
    for j, model in enumerate(("tl-b", "tl-a", "tl-b", "tl-a")):
        eng.submit(Request(200 + j, rng.integers(0, eng.cfg.vocab, 48,
                                                 dtype=np.int32),
                           max_new_tokens=2 * DECODE_STEPS
                           + (DECODE_STEPS + 1) * MOST_WINDOWS, model=model))
    routed = None
    for _ in range(12):
        eng.step()
        if all(s is not None and s.out_tokens for s in eng.slots):
            routed = eng.core.model_ids.tolist()
            break
    if routed is None:
        raise RuntimeError(f"{tag} the four requests never all decoded")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
    windows = agreed_windows({"graph": eng.step}, DECODE_STEPS, tag)["graph"]
    per_step = {w: n / DECODE_STEPS for w, n in windows["wrappers"].items()}
    want = {w: 0.0 for w in per_step}
    want["flash_decode_attn"] = float(n_layers)
    if per_step != want:
        raise RuntimeError(f"{tag} launches per chunk-free step {per_step}, "
                           f"expected {want}")
    prof = decode_profile(eng, tag, step_ms, windows)
    if sorted(eng.core.graphs.keys()) != keys or \
            len(eng.core.graphs.first_calls) != first:
        raise RuntimeError(f"{tag} re-routing captured: graphs "
                           f"{sorted(eng.core.graphs.keys())} (were {keys})")
    print(f"{tag} re-routed slots to variants {routed}: no capture, graphs "
          f"{keys}; chunk-free multi step {step_ms:.3f}ms on {card}",
          flush=True)
    return dict(prof, routed=routed, graphs=keys, per_step=per_step)


def reserved_by_pool(dev) -> dict:
    """``memory_reserved`` split by memory pool, from
    ``torch.cuda.memory_snapshot()``: the caching allocator's default pool
    (``segment_pool_id`` (0, 0)) and each CUDA graph's private pool, each
    with its segment count, reserved bytes (``total_size``) and live bytes
    (``allocated_size``). Their reserved bytes sum to ``memory_reserved``."""
    out: dict = {}
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != dev.index:
            continue
        pid = tuple(seg.get("segment_pool_id", (0, 0)))
        name = "default" if pid == (0, 0) else f"graph {pid[0]}.{pid[1]}"
        p = out.setdefault(name, dict(segments=0, reserved=0, allocated=0))
        p["segments"] += 1
        p["reserved"] += seg["total_size"]
        p["allocated"] += seg["allocated_size"]
    return out


def pool_line(split: dict) -> str:
    return "; ".join(f"{k}: {v['segments']} segments, reserved "
                     f"{v['reserved'] / 2**20:.2f} MiB, allocated "
                     f"{v['allocated'] / 2**20:.2f} MiB"
                     for k, v in sorted(split.items()))


def gateway_memory_gate(reg, seed: int, dev, card: str) -> dict:
    """H2: ``flip`` + scrub repair ``SCRUB_REPAIRS`` times on the fp32
    TinyLlama pair (``reg``) under traffic (packed steps; a flip at gateway
    steps 2, 5, 8, ...; a scrub every 3 steps): each repair drains the
    group, closes its engine, drops every member's params, reloads them in
    registration order and verifies the banks bitwise, and builds a new
    engine (it captures at its next step). After every repair (the GC run
    and the cache emptied) ``memory_reserved`` is split by pool
    (``reserved_by_pool``: the allocator's default pool and each graph's
    pool, segments, reserved and live bytes, printed), and both the live
    bytes, ``memory_allocated``, and ``memory_reserved`` must stay within
    2 MiB of the first repair's: an engine, a graph pool or a bank that
    outlived its repair would add its MiB, and a reload that took another
    layout would move the reserved bytes (ROADMAP C.1: before
    ``ModelRegistry.repair_group`` dropped the whole group first, each
    member reloaded beside the other's live copy, into whatever holes the
    last layout left, and ``memory_reserved`` moved 0 to 218 MiB between
    repairs with the live bytes flat). A flip is a copy in a new
    tree: the engine serving meanwhile keeps its clean tensors, so the
    streams equal a run with no flip (fp32: the recomputed contexts round
    as the first pass did)."""
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.serving import ServingGateway
    tag = "[gateway fp32 scrub]"
    names = [a for _x, a, _k in GATEWAY_MODELS[:2]]
    plan = FaultPlan.parse([f"flip:step={2 + 3 * i},leaf={3 + i},bit="
                            f"{11 + 977 * i}" for i in range(SCRUB_REPAIRS)])
    specs = [(rid, names[rid % 2], p, 48, sp) for rid, _m, p, _n, sp
             in gateway_specs(seed + 1, names, reg.entries["tl-a"].cfg.vocab,
                              n=4)]
    reserved, allocated, repair_s, pools = [], [], [], []
    orig = ServingGateway._scrub_tick

    def tick(gw):
        t0 = time.perf_counter()
        before = gw.stats.scrub_repairs
        orig(gw)
        if gw.stats.scrub_repairs != before:
            torch.cuda.synchronize()
            repair_s.append(time.perf_counter() - t0)
            gc.collect()                # live memory only: no cached block
            torch.cuda.empty_cache()
            reserved.append(torch.cuda.memory_reserved(dev))
            allocated.append(torch.cuda.memory_allocated(dev))
            pools.append(reserved_by_pool(dev))
            print(f"{tag} after repair {len(pools)}: memory_reserved "
                  f"{reserved[-1] / 2**20:.2f} MiB, memory_allocated "
                  f"{allocated[-1] / 2**20:.2f} MiB; by pool: "
                  f"{pool_line(pools[-1])}", flush=True)
            if sum(p["reserved"] for p in pools[-1].values()) != \
                    reserved[-1]:
                raise RuntimeError(f"{tag} the pools' reserved bytes do not "
                                   f"sum to memory_reserved: {pools[-1]}")
    ServingGateway._scrub_tick = tick
    try:
        gw, outs, wall, _per = gateway_drive(reg, dev, specs, tag,
                                             count=False, packed=True,
                                             faults={"tl-a": plan},
                                             scrub_every=3)
    finally:
        ServingGateway._scrub_tick = orig
    s = gw.stats
    close_gateway(gw)
    clean_gw, clean, _w, _p = gateway_drive(reg, dev, specs,
                                            f"{tag} no flip", count=False,
                                            packed=True)
    close_gateway(clean_gw)
    res_mib = [(r - reserved[0]) / 2**20 for r in reserved]
    all_mib = [(a - allocated[0]) / 2**20 for a in allocated]
    print(f"{tag} {s.corruptions_injected} flips, {s.scrub_corruptions} "
          f"caught, {s.scrub_repairs} repaired bitwise in {wall:.1f}s "
          f"(repairs {[round(x, 2) for x in repair_s]} s); after each "
          f"repair vs the first: memory_allocated "
          f"{[round(x, 2) for x in all_mib]} MiB, memory_reserved "
          f"{[round(x, 2) for x in res_mib]} MiB ({reserved[0] / 2**30:.2f} "
          f"GiB; {card}); streams equal the run without flips: "
          f"{outs == clean}", flush=True)
    if not (s.corruptions_injected == s.scrub_corruptions
            == s.scrub_repairs == SCRUB_REPAIRS):
        raise RuntimeError(f"{tag} injected {s.corruptions_injected}, "
                           f"caught {s.scrub_corruptions}, repaired "
                           f"{s.scrub_repairs}; expected {SCRUB_REPAIRS}")
    if any(abs(m) > 2.0 for m in all_mib + res_mib):
        raise RuntimeError(f"{tag} memory across scrub repairs: allocated "
                           f"{all_mib} MiB, reserved {res_mib} MiB (limit "
                           f"2 MiB each); by pool: "
                           + " | ".join(pool_line(p) for p in pools))
    if outs != clean:
        raise RuntimeError(f"{tag} the flips reached a stream: {outs} vs "
                           f"{clean}")
    return dict(repairs=s.scrub_repairs, repair_s=repair_s,
                allocated_mib_vs_first=all_mib,
                reserved_mib_vs_first=res_mib, pools=pools, wall_s=wall)


def gateway_ci_start(out_dir: str) -> dict:
    """The four CI gateway lines (``GATEWAY_CI_LINES``; the kill-9 line
    twice, ``--dtype bfloat16`` and ``--dtype float32``) as subprocesses of
    ``python -m repro_torch.launch.gateway --smoke``, started together:
    name -> (process, start time, log path, log file, end time), the end
    time set by a thread that waits for the process."""
    import shutil
    import threading
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    runs = {}
    lines = dict(GATEWAY_CI_LINES)
    for dt in ("bfloat16", "float32"):
        jdir = os.path.join(out_dir, f"gateway_journal_{dt}")
        shutil.rmtree(jdir, ignore_errors=True)
        lines[f"ci.yml:113 kill-9 {dt}"] = (GATEWAY_KILL9
                                            + ["--journal", jdir,
                                               "--dtype", dt])
    for name, argv in lines.items():
        path = os.path.join(out_dir, "gateway_" + re.sub(r"\W+", "_", name)
                            + ".log")
        log = open(path, "w")
        # a session of its own: the supervised lines start grandchildren,
        # and a failed phase must stop them too (``gateway_ci_kill``)
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.gateway", "--smoke"]
            + argv, cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        end: list = []
        threading.Thread(target=lambda p=proc, e=end: (
            p.wait(), e.append(time.perf_counter())), daemon=True).start()
        runs[name] = (proc, time.perf_counter(), path, log, end)
    return runs


def gateway_ci_kill(runs: dict) -> None:
    """Stop every process the CI lines started (each line's session)."""
    import signal
    for proc, *_rest in runs.values():
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.wait()


def gateway_ci_wait(runs: dict, timeout_s: float = 400.0) -> dict:
    """Wait for the CI lines: each must exit 0 (the launcher's self-test
    contract); walls and the contract's lines printed."""
    out = {}
    deadline = time.perf_counter() + timeout_s
    for name, (proc, t0, path, log, end) in runs.items():
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            gateway_ci_kill(runs)
            raise RuntimeError(f"[gateway ci] {name} still running after "
                               f"{timeout_s:.0f}s")
        for _ in range(100):            # the waiter thread's stamp
            if end:
                break
            time.sleep(0.01)
        wall = (end[0] if end else time.perf_counter()) - t0
        log.close()
        text = open(path).read()
        said = [ln for ln in text.splitlines()
                if " OK" in ln or "byte-identical" in ln]
        print(f"[gateway ci] {name} (--smoke): exit {rc} in {wall:.1f}s; "
              + " | ".join(said), flush=True)
        if rc != 0:
            gateway_ci_kill(runs)
            raise RuntimeError(f"[gateway ci] {name} exit {rc}:\n"
                               f"{text[-4000:]}")
        out[name] = dict(rc=rc, wall_s=wall, said=said)
    fp32 = out["ci.yml:113 kill-9 float32"]["said"]
    if not any("6/6 recovered streams byte-identical" in s for s in fp32):
        raise RuntimeError(f"[gateway ci] kill-9 fp32 streams: {fp32}")
    return out


def gateway_phase(seed: int, card: str, dev, out_dir: str,
                  packed_profile: dict) -> dict:
    """Phase 9 (module docstring): the multi-model gateway at full width on
    the card, every engine step replayed from CUDA graphs."""
    from repro_torch.configs import get_config
    from repro_torch.serving.model_registry import (dense_fp32_bytes,
                                                    param_bytes)
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 25)
    res = dict(qwen_kernels=run_qwen_checks(rng, dev),
               multi_equal=run_multi_checks(rng, dev),
               cache=run_cache_check(dev))
    names = [a for _x, a, _k in GATEWAY_MODELS]
    # (2) the bf16 gateway: the stacked tl-a/tl-b engine and qw's engine
    tag = "[gateway bf16]"
    t0 = time.perf_counter()
    reg = gateway_registry(seed, dev, "bfloat16", GATEWAY_MODELS,
                           QWEN_LAYERS)
    specs = gateway_specs(seed, names, min(e.cfg.vocab for e in
                                           reg.entries.values()))
    for e in reg.entries.values():
        reg.ensure_resident_group(e.group)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gw, streams, wall, per = gateway_drive(reg, dev, specs, tag)
    multi = gw.engine_for("tl-a")
    qw = gw.engine_for("qw")
    if multi is not gw.engine_for("tl-b") or multi.variants != 2 or \
            qw.variants:
        raise RuntimeError(f"{tag} engines: tl-a/tl-b not one stacked pair")
    mc, qc = per[multi.model_label], per[qw.model_label]
    n_qw = reg.entries["qw"].cfg.n_layers
    n_tl = reg.entries["tl-a"].cfg.n_layers
    want_m = {w: 0 for w in mc["launches"]}
    want_m["flash_decode_attn"] = n_tl * mc["steps"]
    want_q = {w: 0 for w in qc["launches"]}
    want_q["ovsf_gemm"] = len(QWEN_LAYER) * n_qw * qc["steps"]
    want_q["flash_decode_attn"] = n_qw * qc["chunk_free"]
    if mc["launches"] != want_m or qc["launches"] != want_q:
        raise RuntimeError(f"{tag} launches: stacked {mc} (want {want_m}), "
                           f"qw {qc} (want {want_q})")
    for eng in (multi, qw):
        keys = sorted(eng.core.graphs.keys())
        if keys != sorted(eng.core.step_shapes) or len(keys) > 2:
            raise RuntimeError(f"{tag} {eng.model_label} graphs {keys}, step "
                               f"shapes {sorted(eng.core.step_shapes)}")
    pair_bytes = reg.resident_bytes() - param_bytes(reg.entries["qw"].params)
    tl_dense = dense_fp32_bytes(reg.entries["tl-a"].cfg)
    pool = gw.resident_bytes()
    qw_dense = dense_fp32_bytes(get_config("qwen2_5_14b"))
    if not pair_bytes < tl_dense or not pool < qw_dense:
        raise RuntimeError(f"{tag} resident bytes: pair {pair_bytes} vs "
                           f"TinyLlama dense fp32 {tl_dense}; pool {pool} vs "
                           f"qwen2_5_14b dense fp32 {qw_dense}")
    tcfg, qcfg = reg.entries["tl-a"].cfg, reg.entries["qw"].cfg
    print(f"{tag} registry tl-a, tl-b (stacked, {n_tl} layers, d "
          f"{tcfg.d_model}) and qw (qwen2_5_14b, {n_qw} of "
          f"{get_config('qwen2_5_14b').n_layers} layers, d {qcfg.d_model}, "
          f"d_ff {qcfg.d_ff}, {qcfg.n_heads}/{qcfg.n_kv_heads} heads) loaded "
          f"and checksummed in {load_s:.1f}s; 12 requests finished once in "
          f"{wall:.2f}s on {card}; stacked engine {mc['steps']} steps, "
          f"launches {mc['launches']}; qw engine {qc['steps']} steps "
          f"({qc['chunk_free']} chunk-free), launches {qc['launches']}; "
          f"graphs stacked {sorted(multi.core.graphs.keys())}, qw "
          f"{sorted(qw.core.graphs.keys())}; resident: pair "
          f"{pair_bytes / 2**30:.3f} GiB < TinyLlama dense fp32 "
          f"{tl_dense / 2**30:.3f} GiB, pool {pool / 2**30:.3f} GiB < "
          f"qwen2_5_14b dense fp32 {qw_dense / 2**30:.3f} GiB", flush=True)
    res["bf16"] = dict(load_s=load_s, wall_s=wall, stacked=mc, qw=qc,
                       pair_bytes=pair_bytes, tl_dense_fp32=tl_dense,
                       pool_bytes=pool, qw_dense_fp32=qw_dense,
                       qwen_layers=n_qw, tokens=streams)
    res["multi_step"] = multi_decode_profile(multi, seed, card, n_tl)
    res["multi_step"]["single_packed"] = {
        k: packed_profile.get(k) for k in ("step_ms", "busy_ms",
                                           "idle_share")}
    print(f"{tag} replayed chunk-free step: stacked pair (2 variants, "
          f"window W 1) {res['multi_step']['step_ms']:.3f}ms, idle share "
          f"{res['multi_step']['idle_share']}; phase 4's single-model "
          f"contiguous packed step ({SERVE_CUT_LAYERS} of 22 layers) "
          f"{packed_profile.get('step_ms')}ms, idle "
          f"share {packed_profile.get('idle_share')}", flush=True)
    del multi, qw
    close_gateway(gw)
    # the CI lines run beside the rest of the phase (the timings are done)
    ci = gateway_ci_start(out_dir)
    try:
        tl = [n for n in names if n != "qw"]
        ded = dedicated_streams(reg, tl, dev, specs, tag)
        mine = {r: t for r, t in streams.items() if specs[r][1] in tl}
        same = [r for r in mine if mine[r] == ded[r]]
        print(f"{tag} {len(same)} of {len(mine)} tl-a/tl-b streams equal "
              "dedicated spectral engines (bf16: printed, held in fp32)",
              flush=True)
        res["bf16"]["dedicated_agree"] = len(same)
        del reg
        torch.cuda.empty_cache()
        # fp32: the pair over 2 replicas, streams held equal
        tag32 = "[gateway fp32]"
        reg32 = gateway_registry(seed, dev, "float32", GATEWAY_MODELS[:2],
                                 QWEN_LAYERS, GATEWAY_FP32_LAYERS)
        specs32 = [(rid, tl[rid % 2], p, n, sp) for rid, _m, p, n, sp
                   in specs]
        gw32, s32, wall32, per32 = gateway_drive(reg32, dev, specs32,
                                                 tag32, replicas=2,
                                                 packed=True)
        replicas = []
        for eng in gw32._groups[reg32.entries["tl-a"].group].engines:
            kv = sum(eng.core.caches[n].nbytes for n in ("k_rows",
                                                          "v_rows"))
            replicas.append(dict(label=eng.model_label,
                                 steps=per32[eng.model_label]["steps"],
                                 kv_mib=kv / 2**20,
                                 graphs=sorted(eng.core.graphs.keys()),
                                 graphs_mib=graphs_held_mib(eng, dev)))
        close_gateway(gw32)
        ded32 = dedicated_streams(reg32, tl, dev, specs32, tag32,
                                  packed=True)
        print(f"{tag32} 12 requests over 2 replicas of the stacked pair "
              f"({reg32.entries['tl-a'].cfg.n_layers} layers) in "
              f"{wall32:.2f}s; per replica: "
              + "; ".join(f"{r['label']} {r['steps']} steps, KV "
                          f"{r['kv_mib']:.1f} MiB, graphs {r['graphs']} "
                          f"holding {r['graphs_mib']:.1f} MiB"
                          for r in replicas)
              + f"; streams equal dedicated spectral engines: "
              f"{s32 == ded32}", flush=True)
        if s32 != ded32:
            raise RuntimeError(f"{tag32} streams {s32} differ from "
                               f"dedicated engines {ded32}")
        res["fp32"] = dict(wall_s=wall32, replicas=replicas,
                           equal_dedicated=True)
        res["scrub"] = gateway_memory_gate(reg32, seed, dev, card)
        del reg32
        torch.cuda.empty_cache()
    except BaseException:
        gateway_ci_kill(ci)
        raise
    res["ci"] = gateway_ci_wait(ci)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"[gateway] phase passed in {res['wall_s']:.1f}s", flush=True)
    return res


# -- phase 10: the MoE family ------------------------------------------------

MOE_ARCH = "olmoe_1b_7b"    # 16 layers, d 2048, 16 x 128 heads (a GQA group
                            # of 1), 64 experts top-8, expert d_ff 1024
MOE_LAYERS = 2              # the depth phase 10 serves it at (full width;
                            # cut for the script's time)
# the window decode at OLMoE-1B-7B's heads: (label, B, H, Hkv, hd, T, pos)
MOE_FLASH = ("olmoe window decode", 4, 16, 16, 128, 128, (1, 37, 100, 128))
MOE_PARITY_LAYERS = 2       # the card-vs-CPU steps' depth (full width)
MOE_FLIP_GAP = 1e-5         # a routing flip needs a k-th/(k+1)-th tie
MOE_ALPHA_SHARE = 0.55      # expert alphas' bytes / dense bf16 banks' (rho .5)
MOE_PLAN = ("attn_q", "attn_k", "attn_v", "attn_o", "e")


def run_moe_kernel_checks(rng, dev) -> dict:
    """Phase 10 (1): ``paged_flash_decode`` (T 4 and 128) and
    ``flash_decode_attn`` (the window decode, B 4, T 128) at OLMoE-1B-7B's
    heads (H 16, Hkv 16, hd 128: a GQA group of 1 at hd 128), bf16 and
    fp32, against their plain versions with device ms, bound and SDPA's
    ms. The kernels line's summaries: the T 4 paged decode and the window
    decode, bf16."""
    paged_rows, paged_summary = run_paged_checks(rng, dev, (16, 16, 128),
                                                 "olmoe ")
    label0, B, H, Hkv, hd, T, pos = MOE_FLASH
    flash = [flash_row(rng, dev, label0, B, H, Hkv, hd, T, pos, dt)
             for dt in (torch.bfloat16, torch.float32)]
    flash_summary = dict(flash[0])
    flash_summary["max_abs_err"] = max(r["max_abs_err"] for r in flash)
    torch.cuda.empty_cache()
    return dict(paged_rows=paged_rows, paged_summary=paged_summary,
                flash_rows=flash, flash_summary=flash_summary)


def moe_resident(params, cfg, card: str) -> dict:
    """Phase 10 (5): the bytes the expert banks' alphas and ids hold on the
    card (each storage once) against the same banks stored dense in bf16:
    at most ``MOE_ALPHA_SHARE`` (rho 0.5 keeps half the coefficients)."""
    d, f = cfg.d_model, cfg.d_ff
    seen, alpha, ids, dense = set(), 0, 0, 0
    for blk in params["blocks"]:
        for name, (d_in, d_out) in (("gate", (d, f)), ("up", (d, f)),
                                    ("down", (f, d))):
            p = blk["moe"][name]
            if "alphas" not in p:
                raise RuntimeError(f"moe: expert bank {name} is dense")
            for t, add in ((p["alphas"], "alpha"), (p["idx"], "ids")):
                st = t.untyped_storage()
                if st.data_ptr() in seen:
                    continue
                seen.add(st.data_ptr())
                if add == "alpha":
                    alpha += st.nbytes()
                else:
                    ids += st.nbytes()
            dense += cfg.n_experts * d_in * d_out * 2
    share = alpha / dense
    print(f"[moe resident] {cfg.name} expert banks ({cfg.n_layers} layers x "
          f"3 x {cfg.n_experts} experts): alphas {alpha / 2**20:.1f} MiB "
          f"(+ ids {ids / 2**10:.1f} KiB) on the card vs {dense / 2**20:.1f}"
          f" MiB as dense bf16 banks: {share:.4f} (limit {MOE_ALPHA_SHARE})"
          f" ({card})", flush=True)
    if not share <= MOE_ALPHA_SHARE:
        raise RuntimeError(f"moe: expert alphas hold {share:.4f} of the "
                           f"dense bf16 banks' bytes, above "
                           f"{MOE_ALPHA_SHARE}")
    return dict(alpha_bytes=alpha, ids_bytes=ids, dense_bf16_bytes=dense,
                share=share)


def check_moe_plan(tag: str, xplan) -> dict:
    """The engine's plan on the card: the reference's entries, ``fused``
    each (the expert weight types share the entry ``e``: the reference's
    mapper cuts ``expert_gatex64`` to ``e`` with ``split("x")``); returns
    each OVSF weight type's resolved path."""
    plan = {n: p.path for n, p in xplan.entries}
    names = ("attn_q", "attn_k", "attn_v", "attn_o", "expert_gate",
             "expert_up", "expert_down")
    resolved = {n: getattr(xplan.plan_for(n), "path", None) for n in names}
    print(f"{tag} mapper plan (hw {xplan.hw_label}, decode at 4 slots): "
          + ", ".join(f"{n}={p}" for n, p in plan.items())
          + f"; per weight type {resolved}", flush=True)
    if tuple(plan) != MOE_PLAN or set(plan.values()) != {"fused"} or \
            set(resolved.values()) != {"fused"}:
        raise RuntimeError(f"{tag} plan {plan} (per weight type {resolved}):"
                           f" expected {MOE_PLAN} all fused")
    return resolved


def graphs_mib_by_key(eng, dev) -> dict:
    """MiB each of the engine's graphs holds (its own pool): reserved
    memory before and after dropping it. Drops every graph (the engine is
    discarded next)."""
    sg = eng.core.graphs
    out = {}
    for key in sg.keys():
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(dev)
        del sg._entries[key]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out[" ".join(map(str, key))] = \
            (before - torch.cuda.memory_reserved(dev)) / 2**20
    sg.clear()
    return out


def expert_step_ms(eng, params, T: int, dev) -> float:
    """Device ms of a step's MoE blocks at ``T`` tokens (the replayed
    chunk-free step's bucket): layer 0's ``moe_apply`` (router, dispatch,
    the three banks regenerated and multiplied, combine) under the engine's
    plan, timed from graph replay, times the layers."""
    from repro_torch.models import moe
    cfg = eng.cfg
    blk = params["blocks"][0]["moe"]
    h = torch.randn((1, T, cfg.d_model), device=dev).to(cfg.act_dtype)
    with torch.no_grad():
        ms, _ = timings([lambda: moe.moe_apply(blk, cfg, h)], 3)
    torch.cuda.empty_cache()
    return ms * cfg.n_layers


@contextlib.contextmanager
def no_plain_banks(tag: str):
    """Fail if, inside, the plain segmented decompress
    (``ovsf_gemm.segmented_decompress_plain``, which the wrapper's plain
    version runs) computes anything on the card: an expert bank there is
    generated by the segmented kernel alone."""
    from repro_torch.kernels import ovsf_gemm as G
    real, on_card = G.segmented_decompress_plain, []

    def guarded(alphas, idx, d_in):
        if alphas.is_cuda:
            on_card.append(tuple(alphas.shape))
        return real(alphas, idx, d_in)
    G.segmented_decompress_plain = guarded
    try:
        yield
    finally:
        G.segmented_decompress_plain = real
    if on_card:
        raise RuntimeError(f"{tag} the plain segmented decompress ran on "
                           f"the card for alphas {on_card[:4]}")


def moe_serve(params, cfg, seed: int, card: str, dev) -> dict:
    """Phase 10 (2): ``family_serve`` over OLMoE: every step launches 4 x
    layers ``ovsf_gemm`` (q, k, v, o; all on the tensor-core kernel), 3 x
    layers segmented ``ovsf_decompress`` (the expert banks, regenerated
    under the ``fused`` plan as the reference's are, one launch a bank)
    and one ``paged_flash_decode`` a layer, nothing else of ours; no plain
    segmented decompress on the card (``no_plain_banks``); the plan
    (``check_moe_plan``). Printed and recorded besides: the MoE blocks'
    device ms a step and their share of the replayed step."""
    from repro_torch.kernels import ovsf_gemm as G
    tag = f"[{MOE_ARCH} paged packed]"
    n_ovsf = ovsf_per_layer(params)
    n_banks = ovsf_banks(params["blocks"][0])
    if n_ovsf != 4 or n_banks != 3:
        raise RuntimeError(f"{tag} {n_ovsf} OVSF linears and {n_banks} "
                           "OVSF expert banks a block, expected 4 (q, k, v,"
                           " o) and 3 (gate, up, down)")
    before = dict(G.ovsf_decompress.launches_by_layout)
    with no_plain_banks(tag):
        res = family_serve(
            params, cfg, seed, card, dev, tag,
            {"ovsf_gemm": n_ovsf * cfg.n_layers,
             "ovsf_decompress": n_banks * cfg.n_layers,
             "paged_flash_decode": cfg.n_layers},
            lambda eng, key: dict(
                per_weight_type=check_moe_plan(tag, eng.cfg.exec_plan),
                moe_blocks_ms=expert_step_ms(eng, params, key[1], dev)))
    layouts = {k: v - before[k]
               for k, v in G.ovsf_decompress.launches_by_layout.items()}
    if layouts["mono"] or not layouts["seg"]:
        raise RuntimeError(f"{tag} ovsf_decompress by layout {layouts}: "
                           "the banks' codes are segmented")
    moe_ms, span = res["moe_blocks_ms"], res["replay_ms"]
    res["moe_blocks_share"] = moe_ms / span
    print(f"{tag} the MoE blocks {moe_ms:.3f} ms of the chunk-free step's "
          f"{span:.3f} ms replay ({moe_ms / span:.3f}; layer 0's block "
          f"timed alone x {cfg.n_layers}); the segmented ovsf_decompress "
          f"{res['ovsf_decompress_ms']:.3f} ms a step ({card})", flush=True)
    return res


def routing_recorder():
    """(records, a ``moe.route`` that records each call's chosen experts,
    kept mask and probabilities on the host): installed by the caller."""
    from repro_torch.models import moe
    route, records = moe.route, []

    def recording(p, cfg, xg):
        r = route(p, cfg, xg)
        records.append({k: r[k].detach().cpu()
                        for k in ("gate_idx", "keep", "probs")})
        return r
    return records, recording


def compare_routing(card: list, cpu: list, slot_of: list, k: int) -> tuple:
    """Card vs CPU routing over a sequence of packed steps (``card``,
    ``cpu``: one record a MoE block in call order, steps after steps;
    ``slot_of``: each step's (T,) slot ids, the sentinel padding its own
    group). A token's routing matches when its top-k set and the kept
    experts among it are equal. A slot whose token differed is perturbed
    from then on (its later layers and steps read what the difference
    changed); a set difference of an unperturbed slot is a flip, with the
    k-th minus (k+1)-th probability on each side. Returns (flips, each
    step's matched slots, differences in all)."""
    per_step = len(card) // len(slot_of)
    perturbed, flips, matched, diffs = set(), [], [], 0
    for s, slots in enumerate(slot_of):
        for layer in range(per_step):
            a, b = card[s * per_step + layer], cpu[s * per_step + layer]
            hit = set()
            for t, slot in enumerate(slots):
                ia, ib = a["gate_idx"][0, t], b["gate_idx"][0, t]
                ka, kb = a["keep"][0, t], b["keep"][0, t]
                same_set = set(ia.tolist()) == set(ib.tolist())
                if same_set and sorted(zip(ia.tolist(), ka.tolist())) == \
                        sorted(zip(ib.tolist(), kb.tolist())):
                    continue
                diffs += 1
                hit.add(slot)
                if not same_set and slot not in perturbed:
                    gap = []
                    for p in (a["probs"], b["probs"]):
                        v = p[0, t].sort(descending=True).values
                        gap.append(float(v[k - 1] - v[k]))
                    flips.append(dict(step=s, layer=layer, token=t,
                                      slot=slot, gap_card=gap[0],
                                      gap_cpu=gap[1]))
            perturbed |= hit
        matched.append(sorted(set(slots) - perturbed))
    return flips, matched, diffs


def moe_parity(seed: int, dev) -> dict:
    """Phase 10 (4): OLMoE-1B-7B at full width but ``MOE_PARITY_LAYERS``
    layers in fp32 (TF32 off), planned as the engine plans it on the card:
    a paged packed step (chunks of 40 and 20 tokens, one one-token chunk,
    three padding tokens) and a decode step over its cache, on the card and
    on the CPU with the same parameters. The routing is compared first
    (``compare_routing``): the run fails on a flip whose probability gap
    exceeds ``MOE_FLIP_GAP`` on either side, or if a step matched no slot;
    every matched slot's logits row within 1e-3 relative L2 of the CPU's.
    Slots that differ are counted and printed."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import registry as R
    from repro_torch.serving import plan_cfg
    cfg = get_config(MOE_ARCH).replace(dtype="float32",
                                       n_layers=MOE_PARITY_LAYERS)
    cfg = plan_cfg(cfg, 4, dev)
    if {p.path for _n, p in cfg.exec_plan.entries} != {"fused"}:
        raise RuntimeError(f"moe parity: plan {cfg.exec_plan} is not fused")
    params = R.model_init(cfg, seed + 3, dev)
    n_slots, ps, npg = 4, 16, 16
    P = n_slots * npg
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[0, :3] = [7, 2, 40]
    table[1, :2] = [11, 5]
    table[2, :1] = [63]
    rng = np.random.default_rng(seed + 3)
    T, n = 64, 61
    tokens = np.zeros(T, np.int32)
    tokens[:n] = rng.integers(0, cfg.vocab, n)
    slot_ids = np.full(T, n_slots, np.int32)
    slot_ids[:n] = [0] * 40 + [1] * 20 + [2]
    positions = np.zeros(T, np.int32)
    positions[:n] = list(range(40)) + list(range(20)) + [0]
    steps = [(tokens, slot_ids, positions, np.array([40, 20, 1, 0], np.int32),
              np.array([39, 59, 60, 0], np.int32)),
             (np.array(list(rng.integers(0, cfg.vocab, 3)) + [0], np.int32),
              np.array([0, 1, 2, n_slots], np.int32),
              np.array([40, 20, 1, 0], np.int32),
              np.array([41, 21, 2, 0], np.int32),
              np.array([0, 1, 2, 0], np.int32))]
    active = [0, 1, 2]                  # slot 3 takes no token

    def run(p, device):
        records, recording = routing_recorder()
        route, moe.route = moe.route, recording
        try:
            cache = R.init_paged_cache(cfg, n_slots, ps, P, device)
            cache["pos"] = torch.zeros(n_slots, dtype=torch.int32,
                                       device=device)
            out = []
            with torch.no_grad():
                for step in steps:
                    logits, cache = R.serve_step_paged(
                        p, cfg, cache, torch.from_numpy(table).to(device),
                        *(torch.from_numpy(a).to(device) for a in step))
                    out.append(logits.float().cpu())
        finally:
            moe.route = route
        return out, records

    t0 = time.perf_counter()
    gpu, g_rec = run(params, dev)
    t_gpu = time.perf_counter() - t0
    cpu_params = R.params_to(params, "cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu, c_rec = run(cpu_params, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    if len(g_rec) != len(steps) * cfg.n_layers or len(c_rec) != len(g_rec):
        raise RuntimeError(f"moe parity: {len(g_rec)} card and {len(c_rec)}"
                           f" CPU MoE blocks recorded, expected "
                           f"{len(steps) * cfg.n_layers}")
    flips, matched, diffs = compare_routing(
        g_rec, c_rec, [s[1].tolist() for s in steps], cfg.top_k)
    rel = []
    for g, c, ok in zip(gpu, cpu, matched):
        if g.shape != (n_slots, cfg.vocab) or not torch.isfinite(g).all():
            raise RuntimeError(f"moe parity: logits {tuple(g.shape)} not "
                               "finite")
        rel.append({r: float((g[r] - c[r]).norm() / c[r].norm())
                    for r in active if r in ok})
    unmatched = [sorted(set(active) - set(ok)) for ok in matched]
    print(f"[moe parity] {MOE_ARCH} full width, {cfg.n_layers} layers, fp32,"
          f" a packed step and a decode step: routing card vs CPU differs "
          f"in {diffs} (token, block) pairs, flips {flips} (gap limit "
          f"{MOE_FLIP_GAP}); slots matched in every block "
          f"{[[r for r in active if r in ok] for ok in matched]}, unmatched "
          f"{unmatched}; their logits rel L2 err "
          + "; ".join(", ".join(f"slot {r} {e:.3e}" for r, e in st.items())
                      for st in rel)
          + f" (limit 1e-3); card steps {t_gpu:.3f}s, CPU steps "
          f"{t_cpu:.3f}s", flush=True)
    big = [f for f in flips if max(f["gap_card"], f["gap_cpu"])
           > MOE_FLIP_GAP]
    if big:
        raise RuntimeError(f"moe parity: routing flips with a probability "
                           f"gap above {MOE_FLIP_GAP}: {big}")
    if not all(st for st in rel):
        raise RuntimeError(f"moe parity: a step matched no slot's routing "
                           f"({matched})")
    worst = max(e for st in rel for e in st.values())
    if not worst <= 1e-3:
        raise RuntimeError(f"moe parity: relative error {rel} > 1e-3")
    return dict(rel_err=[{str(r): e for r, e in st.items()} for st in rel],
                flips=flips, routing_diffs=diffs, unmatched=unmatched,
                gpu_steps_s=t_gpu, cpu_steps_s=t_cpu, layers=cfg.n_layers)


def moe_phase(seed: int, card: str, dev) -> dict:
    """Phase 10 (module docstring): the MoE family, OLMoE-1B-7B at full
    width on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 26)
    res = dict(kernels=run_moe_kernel_checks(rng, dev))
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = R.model_init(cfg, seed, dev)
    torch.cuda.synchronize()
    print(f"[moe] {cfg.name} bf16: {R.param_count(params) / 1e9:.3f}B stored"
          f" values initialised on the card in {time.perf_counter() - t0:.2f}"
          f"s, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated",
          flush=True)
    res["resident"] = moe_resident(params, cfg, card)
    res["paged packed"] = moe_serve(params, cfg, seed, card, dev)
    tag = f"[{MOE_ARCH} legacy bucketed]"
    with no_plain_banks(tag):
        res["legacy"] = family_legacy(params, cfg, seed, card, dev, tag, 1)
    del params
    torch.cuda.empty_cache()
    res["parity"] = moe_parity(seed, dev)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"[moe] phase passed in {res['wall_s']:.1f}s", flush=True)
    return res


# -- phase 11: the recurrent families -----------------------------------------

SSM_ARCHS = ("falcon_mamba_7b", "zamba2_1_2b")
# the card-vs-CPU steps' depth (full width): Zamba2's first shared-attention
# application follows its 6th Mamba-2 block
SSM_PARITY_LAYERS = {"falcon_mamba_7b": 2, "zamba2_1_2b": 6}
# the depth phase 11 serves each at (full width; 0 = uncut), cut for the
# script's time: Falcon-Mamba-7B from 64, Zamba2-1.2B from 38 (two
# applications of its shared block)
SSM_LAYERS = {"falcon_mamba_7b": 8, "zamba2_1_2b": 12}
# the main path's launcher flags; the recurrent families fall back from them
# to the legacy engine with exact per-request prefill
SSM_ENGINE_KW = dict(chunk_size=64, paged=True, packed=True)
# (K, N) of the projections ``ovsf_gemm`` runs per layer: a Mamba block's
# in/out projections, and the hybrid's shared attention + MLP block
SSM_GEMMS = {"falcon_mamba_7b": {"in": (4096, 16384), "out": (8192, 4096)},
             "zamba2_1_2b": {"in": (2048, 8384), "out": (4096, 2048)}}
ZAMBA2_SHARED = {"q": (2048, 2048), "k": (2048, 2048), "v": (2048, 2048),
                 "o": (2048, 2048), "gate": (2048, 8192),
                 "up": (2048, 8192), "down": (8192, 2048)}
# the window decode at Zamba2's heads: (label, B, H, Hkv, hd, T, pos)
SSM_FLASH = ("zamba2 window decode", 4, 32, 32, 64, 128, (1, 37, 100, 128))
# StarCoder2-15B: its six OVSF projections (ungated MLP; k and v 512 wide)
# and its heads (H 48, Hkv 4, hd 128)
STARCODER_ARCH = "starcoder2_15b"
STARCODER_LAYER = {"q": (6144, 6144), "k": (6144, 512), "v": (6144, 512),
                   "o": (6144, 6144), "up": (6144, 24576),
                   "down": (24576, 6144)}
STARCODER_FLASH = ("starcoder2 window decode", 4, 48, 4, 128, 128,
                   (1, 37, 100, 128))
STARCODER_LAYERS = 2        # the depth its launch counts are served at


def gemm_summary(rows: list, shapes: dict, M: int, label: str,
                 tag: str = "[ssm kernel]") -> dict:
    """``shapes``' ``ovsf_gemm`` rows at ``M`` (bf16) summed: one layer's
    projections, the summary row of the kernels line."""
    pick = {(r["K"], r["N"]): r for r in rows if r["M"] == M}
    s = {key: sum(pick[kn][key] for kn in shapes.values())
         for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
    s["bound_by"] = ("bytes" if all(pick[kn]["bound_by"] == "bytes"
                                    for kn in shapes.values())
                     else "operations")
    s["max_abs_err"] = max(pick[kn]["max_abs_err"] for kn in shapes.values())
    print(f"{tag} ovsf_gemm {label} ({', '.join(shapes)}) M={M} "
          f"bf16: {s['ms']:.4f}ms, matmul on dense W {s['library_ms']:.4f}ms"
          f" (x{s['ms'] / s['library_ms']:.2f}), bound {s['bound_ms']:.4f}ms "
          f"({s['bound_by']})", flush=True)
    return s


def run_ssm_kernel_checks(rng, dev) -> dict:
    """Phase 11 (1): ``ovsf_gemm`` (bf16 x and alphas, 16-long segments,
    M 4) at Falcon-Mamba-7B's and Zamba2-1.2B's in/out projections, at the
    shared block's and at StarCoder2-15B's six, each on the tensor-core
    kernel; ``flash_decode_attn`` (window decode B 4, T 128) at Zamba2's
    heads (H 32, Hkv 32, hd 64) and at StarCoder2's (H 48, Hkv 4, hd 128),
    and ``paged_flash_decode`` (T 4 and 128) at StarCoder2's, bf16 and
    fp32; each against its plain version with device ms, bound and the
    library call's ms."""
    shapes = {kn for layer in (*SSM_GEMMS.values(), ZAMBA2_SHARED,
                               STARCODER_LAYER) for kn in layer.values()}
    rows = [gemm_row(rng, dev, 16, 4, K, N, torch.bfloat16, "",
                     "ovsf_gemm_ssm") for (K, N) in sorted(shapes)]
    torch.cuda.empty_cache()
    off = [r["case"] for r in rows if r["kernel"] != "tensor_core"]
    if off:
        raise RuntimeError(f"[ssm kernel] not on the tensor-core ovsf_gemm: "
                           f"{off}")
    gemm = {"falcon_mamba_7b": gemm_summary(
                rows, SSM_GEMMS["falcon_mamba_7b"], 4, "falcon_mamba_7b"),
            "zamba2_1_2b": gemm_summary(
                rows, {**SSM_GEMMS["zamba2_1_2b"], **ZAMBA2_SHARED}, 4,
                "zamba2_1_2b (a Mamba-2 block and the shared block)"),
            STARCODER_ARCH: gemm_summary(rows, STARCODER_LAYER, 4,
                                         STARCODER_ARCH)}
    flash = {}
    for arch, (label0, B, H, Hkv, hd, T, pos) in (
            ("zamba2_1_2b", SSM_FLASH), (STARCODER_ARCH, STARCODER_FLASH)):
        cases = [flash_row(rng, dev, label0, B, H, Hkv, hd, T, pos, dt)
                 for dt in (torch.bfloat16, torch.float32)]
        flash[arch] = dict(cases[0], max_abs_err=max(r["max_abs_err"]
                                                     for r in cases),
                           cases=cases)
        torch.cuda.empty_cache()
    paged_rows, paged_summary = run_paged_checks(rng, dev, (48, 4, 128),
                                                 "starcoder2 ")
    torch.cuda.empty_cache()
    return dict(gemm_rows=rows, gemm=gemm, flash=flash,
                paged_rows=paged_rows, paged_summary=paged_summary)


def ssm_gemms_per_call(cfg) -> int:
    """``ovsf_gemm`` launches of one pass of the trunk: two a Mamba block,
    seven a shared-block application (the hybrid)."""
    from repro_torch.models.transformer import n_attn_apps
    apps = n_attn_apps(cfg) if cfg.family == "hybrid" else 0
    return 2 * cfg.n_layers + len(ZAMBA2_SHARED) * apps


def ssm_plan(tag: str, cfg) -> dict:
    """The engine's plan on the card: ``fused`` for every entry, and every
    OVSF weight type the model dispatches (``mlp_in`` / ``mlp_out``; the
    hybrid's shared block's seven) resolved to a ``fused`` entry."""
    xplan = cfg.exec_plan
    plan = {n: p.path for n, p in xplan.entries}
    names = ["mlp_in", "mlp_out"]
    if cfg.family == "hybrid":
        names += ["attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate",
                  "mlp_up", "mlp_down"]
    resolved = {n: getattr(xplan.plan_for(n), "path", None) for n in names}
    print(f"{tag} mapper plan (hw {xplan.hw_label}, decode at 4 slots): "
          + ", ".join(f"{n}={p}" for n, p in plan.items())
          + f"; per weight type {resolved}", flush=True)
    if set(plan.values()) != {"fused"} or \
            set(resolved.values()) != {"fused"}:
        raise RuntimeError(f"{tag} plan {plan} (per weight type {resolved}):"
                           " expected every entry and weight type fused")
    return resolved


def ovsf_resident(params, card: str, tag: str) -> dict:
    """Bytes of every OVSF layer's alphas on the card against the same
    matrices stored dense in bf16 (d_in = segments x 16)."""
    from repro_torch.models import registry as R
    alpha = dense = 0

    def walk(t):
        nonlocal alpha, dense
        if isinstance(t, dict):
            if "alphas" in t and "idx" in t:
                alpha += t["alphas"].nbytes
                dense += t["idx"].shape[0] * 16 * t["alphas"].shape[-1] * 2
                return
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
    walk(params)
    total = sum(t.nbytes for t in R.leaves(params))
    print(f"{tag} OVSF alphas {alpha / 2**20:.1f} MiB on the card vs "
          f"{dense / 2**20:.1f} MiB as dense bf16 ({alpha / dense:.4f}); "
          f"all params {total / 2**30:.3f} GiB ({card})", flush=True)
    if not alpha / dense <= MOE_ALPHA_SHARE:
        raise RuntimeError(f"{tag} alphas hold {alpha / dense:.4f} of the "
                           f"dense bf16 bytes, above {MOE_ALPHA_SHARE}")
    return dict(alpha_bytes=alpha, dense_bf16_bytes=dense,
                share=alpha / dense, param_bytes=total)


def ssm_serve(params, cfg, seed: int, card: str, dev) -> dict:
    """Phase 11 (2): the 8 requests of phase 4 (6 greedy, 2 sampled, 16 new
    tokens each) through ``LLMEngine(chunk_size=64, paged=True,
    packed=True)`` at 4 slots and buffer 256, eager and replayed. Gates: the
    engine warns and falls back to phase-based serving (no chunks, pages or
    packing; no bucketing: every prefill exact, eager); every request
    finishes; the plan (``ssm_plan``); every step launches
    ``ssm_gemms_per_call`` ``ovsf_gemm`` a prefill call and a decode (all
    tensor-core) and one ``flash_decode_attn`` a shared-block application
    a decode, nothing else of ours; streams, every step's logits, launch
    counters, profiled kernels by name and per step equal between the two
    runs; one graph, ``("decode", 1)``; the profiler's launches of our
    kernels equal the wrappers' counters; the cache (``conv``, ``ssm``,
    K/V) keeps its addresses through the runs and the replays after.
    Printed: the replayed decode step's wall, replay span, device busy and
    idle share, the graph's MiB, the state's bytes."""
    import warnings
    from repro_torch.models.transformer import n_attn_apps
    tag = f"[{cfg.name} legacy]"
    specs = serve_specs(cfg, seed)
    per_call = ssm_gemms_per_call(cfg)
    apps = n_attn_apps(cfg) if cfg.family == "hybrid" else 0
    runs, engines, walls, fell = {}, {}, {}, []
    for mode in ("eager", "graph"):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng, run = serve_run(params, cfg, dev, "legacy",
                                 serve_requests(specs), f"{tag} {mode}",
                                 mode == "graph", False,
                                 engine_kw=SSM_ENGINE_KW)
        fell += [str(x.message) for x in w
                 if "chunked prefill requires a KV-cache family"
                 in str(x.message)]
        core = eng.core
        if (core.window, core.packed, core.paged, eng.bucketed) != \
                (0, False, False, False) or core.pager is not None:
            raise RuntimeError(f"{tag} {mode}: the engine did not fall back "
                               f"to exact phase-based serving")
        for calls, decoded, delta in run["per_step"]:
            want = {k: 0 for k in delta}
            want["ovsf_gemm"] = per_call * (len(calls) + decoded)
            want["flash_decode_attn"] = apps * decoded
            if delta != want or any(k[0] != "prefill_exact" for k in calls):
                raise RuntimeError(f"{tag} {mode}: a step with prefill calls"
                                   f" {calls} and {'a' if decoded else 'no'}"
                                   f" decode launched {delta}, expected "
                                   f"{want}")
        if run["by_kernel"]["tensor_core"] != run["launches"]["ovsf_gemm"]:
            raise RuntimeError(f"{tag} {mode}: ovsf_gemm by kernel "
                               f"{run['by_kernel']}, not all tensor-core")
        if run["moved"]:
            raise RuntimeError(f"{tag} {mode}: cache leaves {run['moved']} "
                               "changed address during the run")
        runs[mode], engines[mode] = run, eng
        walls[mode] = decode_ready(eng, cfg, np.random.default_rng(seed + 1))
    if len(fell) != 2:
        raise RuntimeError(f"{tag} fallback warnings {fell}, expected one "
                           "an engine")
    resolved = ssm_plan(tag, engines["graph"].cfg)
    graph_core = engines["graph"].core
    ptrs = {n: t.data_ptr() for n, t in graph_core.caches.items()}
    windows = agreed_windows({m: e.step for m, e in engines.items()},
                             DECODE_STEPS, tag)
    profiles = {m: decode_profile(e, f"{tag} {m}", walls[m], windows[m])
                for m, e in engines.items()}
    for m, e in engines.items():
        check_fault_free(e, f"{tag} {m}", runs[m].pop("core"))
    key = ("decode", 1)
    profiles["graph"]["replay_ms"] = replay_span(engines["graph"], key)
    moved = [n for n, t in graph_core.caches.items()
             if t.data_ptr() != ptrs[n]]
    if moved:
        raise RuntimeError(f"{tag} cache leaves {moved} changed address "
                           "across the replays")
    compare = graph_vs_eager(tag, runs["eager"], runs["graph"], profiles,
                             wall_gate=False)
    mib = graphs_mib_by_key(engines["graph"], dev)
    del engines, graph_core, eng, core
    torch.cuda.empty_cache()
    graph, eager = runs["graph"], runs["eager"]
    stats, pg = graph["stats"], profiles["graph"]
    print(f"{tag} 8/8 finished through the fallback (exact prefills, "
          f"eager; decode replayed): steps={stats.steps} tokens="
          f"{stats.tokens_out} wall={graph['wall']:.3f}s (eager "
          f"{eager['wall']:.3f}s) launches={graph['launches']} ({per_call} "
          f"ovsf_gemm a prefill call and a decode, {apps} flash_decode_attn "
          f"a decode); the decode step's wall {pg['step_ms']:.3f} ms "
          f"replayed (eager {profiles['eager']['step_ms']:.3f}), a replay "
          f"{pg['replay_ms']:.3f} ms on the device, idle share "
          f"{pg['idle_share']}; cache {graph['kv_bytes'] / 2**20:.1f} MiB at "
          f"fixed addresses; graphs' MiB "
          + ", ".join(f"{k} {v:.1f}" for k, v in mib.items())
          + f" ({card})", flush=True)
    return dict(steps=stats.steps, tokens_out=stats.tokens_out,
                wall_s=graph["wall"], eager_wall_s=eager["wall"],
                launches=graph["launches"], per_call=per_call,
                ovsf_gemm_by_kernel=graph["by_kernel"],
                per_weight_type=resolved, graph_vs_eager=compare,
                decode_profile=pg, eager_decode_profile=profiles["eager"],
                replay_ms=pg["replay_ms"], graphs_mib=mib,
                cache_bytes=graph["kv_bytes"], fallback_warning=fell[0],
                tokens=graph["tokens"])


def ssm_parity(arch: str, seed: int, dev) -> dict:
    """Phase 11 (3): the model at full width but ``SSM_PARITY_LAYERS``
    layers in fp32 (TF32 off), planned as the engine plans it on the card:
    three prompts (9, 40 and 70 tokens: the last crosses a 64-long scan
    chunk) each prefilled alone (``serve_prefill``), adopted into a 4-slot
    cache, then two all-slot decode steps (``serve_step``; slot 3 idle), on
    the card and on the CPU with the same parameters; every logits row of
    every call within 1e-3 relative L2 of the CPU's, and the recurrent
    state after the last step within 1e-3 too."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.serving import plan_cfg
    cfg = get_config(arch).replace(dtype="float32",
                                   n_layers=SSM_PARITY_LAYERS[arch])
    cfg = plan_cfg(cfg, 4, dev)
    if {p.path for _n, p in cfg.exec_plan.entries} != {"fused"}:
        raise RuntimeError(f"ssm parity: plan {cfg.exec_plan} is not fused")
    params = R.model_init(cfg, seed + 3, dev)
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab, (1, n)).astype(np.int64)
               for n in (9, 40, 70)]
    steps = [rng.integers(0, cfg.vocab, (4, 1)).astype(np.int64)
             for _ in range(2)]
    T = 96

    def run(p, device):
        cache = R.init_cache(cfg, 4, T, device)
        out = []
        with torch.no_grad():
            for b, toks in enumerate(prompts):
                lg, c = R.serve_prefill(p, cfg, torch.from_numpy(toks)
                                        .to(device), T)
                out.append(lg.float().cpu())
                for name in ("conv", "ssm", "k", "v"):
                    if name in c:
                        cache[name][:, b].copy_(c[name][:, 0])
                cache["pos"][b] = toks.shape[1]
            for toks in steps:
                lg, cache = R.serve_step(p, cfg, cache,
                                         torch.from_numpy(toks).to(device))
                out.append(lg.float().cpu())
        return out, {n: cache[n].float().cpu() for n in ("conv", "ssm")}

    t0 = time.perf_counter()
    gpu, gstate = run(params, dev)
    t_gpu = time.perf_counter() - t0
    cpu_params = R.params_to(params, "cpu")
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu, cstate = run(cpu_params, torch.device("cpu"))
    t_cpu = time.perf_counter() - t0
    rel = []
    for g, c in zip(gpu, cpu):
        if g.shape != c.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"ssm parity {arch}: logits {tuple(g.shape)} "
                               "not finite or misshapen")
        rel.append([float((g[r] - c[r]).norm() / c[r].norm())
                    for r in range(g.shape[0])])
    state = {n: float((gstate[n] - cstate[n]).norm() / cstate[n].norm())
             for n in gstate}
    worst = max(max(r) for r in rel)
    print(f"[ssm parity] {arch} full width, {cfg.n_layers} layers, fp32: "
          f"3 exact prefills and 2 all-slot decode steps, logits rel L2 err "
          f"max {worst:.3e} (per call "
          + ", ".join(f"{max(r):.2e}" for r in rel)
          + f"), state after the last step {state} (limit 1e-3); card "
          f"{t_gpu:.3f}s, CPU {t_cpu:.3f}s", flush=True)
    if not worst <= 1e-3 or not max(state.values()) <= 1e-3:
        raise RuntimeError(f"ssm parity {arch}: relative error {rel}, state "
                           f"{state} > 1e-3")
    return dict(rel_err=rel, state_rel_err=state, layers=cfg.n_layers,
                gpu_s=t_gpu, cpu_s=t_cpu)


def starcoder2_serve(seed: int, card: str, dev) -> dict:
    """Phase 11 (4): StarCoder2-15B at full width but ``STARCODER_LAYERS``
    layers, bf16, the 8 requests of phase 4, replayed: through the main
    path's engine (paged packed, chunk 64: per step 6 ``ovsf_gemm`` and one
    ``paged_flash_decode`` a layer) and the legacy engine (bucketed: 6
    ``ovsf_gemm`` a layer a prefill call and a decode, one
    ``flash_decode_attn`` a layer a decode). Every request finishes; the
    launch counts of its kernel rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    cfg = get_config(STARCODER_ARCH).replace(n_layers=STARCODER_LAYERS)
    params = R.model_init(cfg, seed, dev)
    n_ovsf = ovsf_per_layer(params)
    if n_ovsf != len(STARCODER_LAYER):
        raise RuntimeError(f"[{STARCODER_ARCH}] {n_ovsf} OVSF linears a "
                           f"block, expected {len(STARCODER_LAYER)}")
    specs = serve_specs(cfg, seed)
    tag = f"[{STARCODER_ARCH} paged packed]"
    _eng, run = serve_run(params, cfg, dev, "paged packed",
                          serve_requests(specs), tag, True, False)
    none = {k: 0 for k in wrapper_counts()}
    want = dict(none, ovsf_gemm=n_ovsf * cfg.n_layers,
                paged_flash_decode=cfg.n_layers)
    for _calls, active, delta in run["per_step"]:
        if delta != (want if active else none):
            raise RuntimeError(f"{tag} a step launched {delta}, expected "
                               f"{want}")
    del _eng
    tag2 = f"[{STARCODER_ARCH} legacy]"
    _eng, legacy = serve_run(params, cfg, dev, "bucketed",
                             serve_requests(specs), tag2, True, False,
                             engine_kw=LEGACY_STYLES["bucketed"])
    check_legacy_steps(tag2, legacy, cfg.n_layers, n_ovsf)
    del _eng, params
    torch.cuda.empty_cache()
    print(f"[{STARCODER_ARCH}] full width (d {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}), "
          f"{cfg.n_layers} layers, bf16, replayed: paged packed 8/8 finished"
          f", launches {run['launches']} in {run['stats'].steps} steps; "
          f"legacy 8/8, launches {legacy['launches']} in "
          f"{legacy['stats'].steps} steps ({card})", flush=True)
    return {"paged packed": dict(launches=run["launches"],
                                 steps=run["stats"].steps,
                                 tokens=run["tokens"]),
            "legacy": dict(launches=legacy["launches"],
                           steps=legacy["stats"].steps,
                           tokens=legacy["tokens"])}


def ssm_phase(seed: int, card: str, dev) -> dict:
    """Phase 11 (module docstring): the recurrent families at full width on
    the card, and StarCoder2-15B's kernel rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 28)
    res = dict(kernels=run_ssm_kernel_checks(rng, dev))
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        cfg = cfg.replace(n_layers=SSM_LAYERS[arch] or cfg.n_layers)
        t0 = time.perf_counter()
        params = R.model_init(cfg, seed, dev)
        torch.cuda.synchronize()
        tag = f"[ssm] {cfg.name}"
        print(f"{tag} bf16 ({cfg.n_layers} layers, d {cfg.d_model}, d_inner "
              f"{cfg.d_inner}, N {cfg.ssm_state}, vocab {cfg.vocab}): "
              f"{R.param_count(params) / 1e9:.3f}B stored values initialised"
              f" on the card in {time.perf_counter() - t0:.2f}s, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated",
              flush=True)
        res[arch] = dict(resident=ovsf_resident(params, card, tag),
                         serve=ssm_serve(params, cfg, seed, card, dev))
        del params
        gc.collect()            # the engines' reference cycles hold them
        torch.cuda.empty_cache()
        res[arch]["parity"] = ssm_parity(arch, seed, dev)
    res[STARCODER_ARCH] = starcoder2_serve(seed, card, dev)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"[ssm] phase passed in {res['wall_s']:.1f}s", flush=True)
    return res


# -- phase 12: the encoder-decoder and VLM families ---------------------------

WHISPER_ARCH = "whisper_tiny"
LLAVA_ARCH = "llava_next_34b"
# the depth phase 12 serves LLaVA-NeXT-34B at (of 60, full width): all 60
# took the whole script to 893 s of its 1200 s limit on a slow host
LLAVA_LAYERS = 4            # of 60, for the script's time; full width
LLAVA_PARITY_LAYERS = 2     # the card-vs-CPU steps' depth (full width)
LLAVA_PARITY_IMAGE = 8      # image positions of the card-vs-CPU prefill
ENTRY_STEPS = 16            # greedy decode steps after each family's prefill
# (K, N) of LLaVA-NeXT-34B's seven OVSF projections a layer (k and v 1024
# wide: 8 KV heads of 128)
LLAVA_LAYER = {"q": (7168, 7168), "k": (7168, 1024), "v": (7168, 1024),
               "o": (7168, 7168), "gate": (7168, 20480),
               "up": (7168, 20480), "down": (20480, 7168)}
LLAVA_PLAN = ("attn_q", "attn_k", "attn_v", "attn_o", "mlp_gate", "mlp_up",
              "mlp_down")
# (label, B, H, Hkv, hd, T, positions): LLaVA's heads (a GQA group of 7),
# Whisper's self heads, Whisper's cross read (every row at Te = 1500, the
# tail of the split plan not a whole tile) and the same read of the paged
# packed engine's mixed bucket (128 tokens, each its slot's gathered rows)
ENCDEC_VLM_FLASH = {
    "llava": ("llava window decode", 4, 56, 8, 128, 128, (1, 37, 100, 128)),
    "whisper": ("whisper window decode", 4, 6, 6, 64, 128, (1, 37, 100, 128)),
    "whisper_cross": ("whisper cross read", 4, 6, 6, 64, 1500, (1500,) * 4),
    "whisper_packed_cross": ("whisper packed cross read", 128, 6, 6, 64,
                             1500, (1500,) * 128)}
ENCDEC_VLM_PAGED = {"llava": (56, 8, 128), "whisper": (6, 6, 64)}


def run_encdec_vlm_kernel_checks(rng, dev) -> dict:
    """Phase 12 (1): ``ovsf_gemm`` (bf16, 16-long segments) at LLaVA's seven
    projections at M 4 (decode) and 1024 (a prefill's rows), each on the
    tensor-core kernel, summed a layer; ``flash_decode_attn`` at LLaVA's
    heads, Whisper's self heads, Whisper's cross read (B 4, T 1500, pos
    1500) and the packed cross read (B 128); ``paged_flash_decode`` (T 4
    and 128) at LLaVA's and Whisper's heads; bf16 and fp32, each against
    its plain version with device ms, bound and the library call's ms
    (matmul on the dense W; SDPA). The packed cross path's row gather
    (``xk[sid]``, ``xv[sid]``: 128 tokens from 4 slots of 1500 rows) is
    timed beside them."""
    shapes = sorted(set(LLAVA_LAYER.values()))
    rows = [gemm_row(rng, dev, 16, M, K, N, torch.bfloat16, "",
                     "ovsf_gemm_llava") for M in (4, 1024) for K, N in shapes]
    torch.cuda.empty_cache()
    off = [r["case"] for r in rows if r["kernel"] != "tensor_core"]
    if off:
        raise RuntimeError(f"[encdec/vlm kernel] not on the tensor-core "
                           f"ovsf_gemm: {off}")
    gemm = {M: gemm_summary(rows, LLAVA_LAYER, M, LLAVA_ARCH,
                            "[encdec/vlm kernel]") for M in (4, 1024)}
    flash = {}
    for key, (label0, B, H, Hkv, hd, T, pos) in ENCDEC_VLM_FLASH.items():
        cases = [flash_row(rng, dev, label0, B, H, Hkv, hd, T, pos, dt)
                 for dt in (torch.bfloat16, torch.float32)]
        flash[key] = dict(cases[0], max_abs_err=max(r["max_abs_err"]
                                                    for r in cases),
                          cases=cases)
        torch.cuda.empty_cache()
    paged = {}
    for key, heads in ENCDEC_VLM_PAGED.items():
        cases, summary = run_paged_checks(rng, dev, heads, f"{key} ")
        paged[key] = dict(summary, cases=cases)
        torch.cuda.empty_cache()
    gathers = []
    for dt in (torch.bfloat16, torch.float32):
        xk = torch.randn((4, 1500, 6, 64), device=dev).to(dt)
        xv = torch.randn((4, 1500, 6, 64), device=dev).to(dt)
        sid = torch.from_numpy(rng.integers(0, 4, 128)).to(dev)
        g_ms, _ = timings([lambda: (xk[sid], xv[sid])], 20)
        g_bytes = 2 * (4 + 128) * 1500 * 6 * 64 * xk.element_size()
        gathers.append(dict(T=128, Te=1500, dtype=str(dt), ms=g_ms,
                            bytes=g_bytes,
                            bound_ms=g_bytes / HBM_BYTES_PER_S * 1e3))
        print(f"[encdec/vlm kernel] packed cross gather T=128 Te=1500 "
              f"{str(dt).split('.')[-1]}: {g_ms:.4f}ms per layer "
              f"({g_bytes / 1e6:.1f} MB read once and written, bound "
              f"{g_bytes / HBM_BYTES_PER_S * 1e3:.4f}ms)", flush=True)
        del xk, xv
    torch.cuda.empty_cache()
    return dict(gemm_rows=rows, gemm=gemm, flash=flash, paged=paged,
                cross_gather=gathers)


def entry_calls(params, cfg, device, tokens: np.ndarray, extra: dict,
                feed=None, steps: int = ENTRY_STEPS) -> dict:
    """``serve_prefill`` of (B, Sp) ``tokens`` with ``extra`` (``frames`` or
    ``image_embeds``, numpy) on ``device``, then ``steps`` decode steps
    fed greedily (or the tokens ``feed`` gives, a step each): fp32
    logits of every call on the host, the tokens fed, each call's launch
    counters' increase and host seconds, and the cache after the
    prefill's cross leaves' shape and type (an encoder-decoder's)."""
    from repro_torch.models import registry as R
    Sp = tokens.shape[1]
    kw = {k: torch.from_numpy(v).to(device, cfg.act_dtype)
          for k, v in extra.items()}
    tok = torch.from_numpy(tokens.astype(np.int64)).to(device)
    out, fed, launches, secs = [], [], [], []
    cross = None
    with torch.no_grad():
        for i in range(steps + 1):
            before = wrapper_counts()
            t0 = time.perf_counter()
            if i == 0:
                lg, cache = R.serve_prefill(params, cfg, tok, Sp + steps,
                                            **kw)
                if "xk" in cache:
                    cross = (tuple(cache["xk"].shape), str(cache["xk"].dtype),
                             bool(cache["xk"].any()))
            else:
                lg, cache = R.serve_step(params, cfg, cache, tok)
            if device.type == "cuda":
                torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            after = wrapper_counts()
            launches.append({k: after[k] - before[k] for k in after})
            out.append(lg.float().cpu())
            nxt = (lg.argmax(-1) if feed is None
                   else torch.from_numpy(feed[i]).to(device))
            fed.append(nxt.cpu().numpy())
            tok = nxt[:, None]
    return dict(logits=out, fed=fed, launches=launches, secs=secs,
                cross=cross)


def rel_rows(got: list, want: list, tag: str) -> list:
    """Each call's logits rows' relative L2 error (card against CPU), the
    shapes equal and the values finite."""
    rel = []
    for g, c in zip(got, want):
        if g.shape != c.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{tag} logits {tuple(g.shape)} vs "
                               f"{tuple(c.shape)}, or not finite")
        rel.append([float((g[r] - c[r]).norm() / c[r].norm())
                    for r in range(g.shape[0])])
    return rel


def check_entry_launches(tag: str, run: dict, want_prefill: dict,
                         want_step: dict) -> None:
    """The prefill launched ``want_prefill`` and every decode step
    ``want_step`` of the wrappers' counters (the rest 0)."""
    for i, delta in enumerate(run["launches"]):
        want = {k: 0 for k in delta}
        want.update(want_prefill if i == 0 else want_step)
        if delta != want:
            raise RuntimeError(f"{tag} call {i} launched {delta}, expected "
                               f"{want}")


def family_serve(params, cfg, seed: int, card: str, dev, tag: str,
                 want: dict, extra=None, engine_kw=None) -> dict:
    """The 8 requests of phase 4 (6 greedy, 2 sampled, 16 new tokens)
    through the main path's engine (``LLMEngine(chunk_size=64, paged=True,
    packed=True)``, 4 slots, buffer 256), eager and replayed: every request
    finishes; every step that runs tokens launches ``want`` of the
    wrappers' counters and nothing else; streams, every chunk-free step's
    logits, launch counters and profiled kernels equal between the two
    runs (``graph_vs_eager``, the wall printed only); the cache keeps its
    addresses; an encoder-decoder's cross caches stay zero (the engine
    passes tokens only). ``extra(engine, step key)``, if given, runs on
    the replaying engine before it is freed; its dict joins the result.
    ``engine_kw``: the engine's arguments besides slots and buffer, in
    place of the main path's. Printed: the chunk-free step's wall, replay
    span, device busy and idle share, its ``ovsf_gemm`` and
    ``ovsf_decompress`` device ms, the graphs' MiB."""
    specs = serve_specs(cfg, seed)
    none = {k: 0 for k in wrapper_counts()}
    want = dict(none, **want)
    runs, engines, walls = {}, {}, {}
    for mode in ("eager", "graph"):
        eng, run = serve_run(params, cfg, dev, "paged packed",
                             serve_requests(specs), f"{tag} {mode}",
                             mode == "graph", False, engine_kw=engine_kw)
        for _calls, active, delta in run["per_step"]:
            if delta != (want if active else none):
                raise RuntimeError(f"{tag} {mode}: a step launched {delta}, "
                                   f"expected {want}")
        if run["by_kernel"]["tensor_core"] != run["launches"]["ovsf_gemm"]:
            raise RuntimeError(f"{tag} {mode}: ovsf_gemm by kernel "
                               f"{run['by_kernel']}, not all tensor-core")
        if run["moved"]:
            raise RuntimeError(f"{tag} {mode}: cache leaves {run['moved']} "
                               "changed address during the run")
        caches = eng.core.caches
        if "xk" in caches and (caches["xk"].any() or caches["xv"].any()):
            raise RuntimeError(f"{tag} {mode}: the engine wrote its cross "
                               "caches")
        runs[mode], engines[mode] = run, eng
        walls[mode] = decode_ready(eng, cfg, np.random.default_rng(seed + 1))
    windows = agreed_windows({m: e.step for m, e in engines.items()},
                             DECODE_STEPS, tag)
    profiles = {m: decode_profile(e, f"{tag} {m}", walls[m], windows[m])
                for m, e in engines.items()}
    for m, e in engines.items():
        check_fault_free(e, f"{tag} {m}", runs[m].pop("core"))
    graph_eng = engines["graph"]
    key = tuple(profiles["graph"]["step_shapes"][0])
    profiles["graph"]["replay_ms"] = replay_span(graph_eng, key)
    compare = graph_vs_eager(tag, runs["eager"], runs["graph"], profiles,
                             wall_gate=False)
    def own_ms(names):
        return sum(e.self_device_time_total for e in windows["graph"]["first"]
                   if any(re.search(rf"\b{k}\b", e.key)
                          for k in names)) / DECODE_STEPS / 1e3
    gemm_ms = own_ms(OWN_OF_WRAPPER["ovsf_gemm"] + ("sum_splits_kernel",))
    dec_ms = own_ms(OWN_OF_WRAPPER["ovsf_decompress"])
    mib = graphs_mib_by_key(graph_eng, dev)
    more = extra(graph_eng, key) if extra is not None else {}
    del engines, graph_eng, eng
    gc.collect()
    torch.cuda.empty_cache()
    graph, eager = runs["graph"], runs["eager"]
    stats, pg = graph["stats"], profiles["graph"]
    busy = pg["busy_ms"]
    print(f"{tag} 8/8 finished: steps={stats.steps} chunk_free_steps="
          f"{graph['chunk_free']} tokens={stats.tokens_out} wall="
          f"{graph['wall']:.3f}s (eager {eager['wall']:.3f}s) launches="
          f"{graph['launches']} ({want} a step); the chunk-free step {key}: "
          f"wall {pg['step_ms']:.3f} ms, replay {pg['replay_ms']:.3f} ms on "
          f"the device, busy "
          + ("not measured" if busy is None else f"{busy:.3f} ms")
          + f", idle share {pg['idle_share']}, kernels a step "
          f"{pg['kernels_per_step']}, ovsf_gemm {gemm_ms:.3f} ms and "
          f"ovsf_decompress {dec_ms:.3f} ms of it; "
          f"cache {graph['kv_bytes'] / 2**20:.1f} MiB; graphs' MiB "
          + ", ".join(f"{k} {v:.1f}" for k, v in mib.items())
          + f" ({card})", flush=True)
    return dict(steps=stats.steps, chunk_free_steps=graph["chunk_free"],
                tokens_out=stats.tokens_out, wall_s=graph["wall"],
                eager_wall_s=eager["wall"], launches=graph["launches"],
                ovsf_gemm_by_kernel=graph["by_kernel"],
                graph_vs_eager=compare, decode_profile=pg,
                eager_decode_profile=profiles["eager"],
                replay_ms=pg["replay_ms"], ovsf_gemm_ms=gemm_ms,
                ovsf_decompress_ms=dec_ms, graphs_mib=mib,
                cache_bytes=graph["kv_bytes"],
                flash_unmasked=graph["flash_unmasked"],
                tokens=graph["tokens"],
                launch_totals={k: sum(d[k] for _c, _a, d in graph["per_step"])
                               for k in none}, **more)


def family_legacy(params, cfg, seed: int, card: str, dev, tag: str,
                  flash_per_layer: int) -> dict:
    """The same model and requests through the legacy path, bucketed,
    eager and replayed (``legacy_pair``: streams, every step's logits and
    launch counters equal; each bucket's graph holds K/V as deep as its
    bucket), ``flash_per_layer`` ``flash_decode_attn`` a layer a decode;
    no prefill graph holds a cross cache (the prefill bodies leave them
    out). Printed: each graph's replay ms and MiB."""
    specs = serve_specs(cfg, seed)
    runs, engines, prefill = legacy_pair(params, cfg, dev, specs,
                                         "bucketed", tag, flash_per_layer)
    graph, eager = runs["graph"], runs["eager"]
    for m, e in engines.items():
        check_fault_free(e, f"{tag} {m}", runs[m]["core"])
    core = engines["graph"].core
    held = {k: [tuple(o.shape) for o in core.graphs._entries[k].outputs]
            for k in core.graphs.keys() if k[0] == "prefill"}
    if any(len(shapes) != 4 for shapes in held.values()):
        raise RuntimeError(f"{tag} prefill graphs hold outputs {held}: "
                           "logits, head, K and V only")
    if "xk" in core.caches and core.caches["xk"].any():
        raise RuntimeError(f"{tag} the legacy engine wrote its cross caches")
    replay = {" ".join(map(str, k)): replay_span(engines["graph"], tuple(k))
              for k in graph["graphs"]}
    mib = graphs_mib_by_key(engines["graph"], dev)
    del engines, core
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} 8/8 finished; streams, logits ({len(graph['steps'])} "
          f"steps) and launches {graph['launches']} equal eager vs "
          f"replayed; prefill keys {prefill}; wall {graph['wall']:.3f}s "
          f"(eager {eager['wall']:.3f}s); device ms a replay: "
          + ", ".join(f"{k} {v:.3f}" for k, v in replay.items())
          + "; graphs' MiB " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in mib.items())
          + f" ({card})", flush=True)
    return dict(tokens=graph["tokens"], launches=graph["launches"],
                flash_unmasked=graph["flash_unmasked"],
                steps=len(graph["steps"]),
                prefill_keys=[list(k) for k in prefill],
                wall_s=graph["wall"], eager_wall_s=eager["wall"],
                replay_ms=replay, graphs_mib=mib)


def whisper_inputs(cfg, seed: int) -> tuple:
    """(4, Sp) prompts, Sp drawn in [4, 32], and (4, Te, d) frames, from
    ``seed``."""
    rng = np.random.default_rng(seed + 29)
    Sp = int(rng.integers(4, 33))
    tokens = rng.integers(0, cfg.vocab, (4, Sp))
    frames = rng.standard_normal((4, cfg.encoder_seq, cfg.d_model),
                                 np.float32)
    return tokens, frames


def whisper_phase(seed: int, card: str, dev) -> dict:
    """Phase 12 (2): Whisper-tiny uncut (4 + 4 layers, d 384, 6 heads of 64,
    Te 1500, vocab 51865), bf16: no OVSF layer at this width (d 384 <
    min_dim 512), so its path runs the two attention kernels only.
    ``serve_prefill`` with frames (4 x 1500 x 384 from the seed) and
    prompts of one length in [4, 32], then 16 greedy ``serve_step``s: the
    cross caches Te deep in bf16; no kernel in the prefill (S > 1: plain
    ``sdpa``), two ``flash_decode_attn`` a layer a step (self, and cross
    over the 1500 rows); the frames reach the decoder (the prefill's
    logits without them differ). The same in fp32 on the card and the CPU
    (the card's greedy tokens fed to both): every call's logits within
    1e-3 relative L2. Then ``family_serve`` (a paged packed step launches
    one ``paged_flash_decode`` and one ``flash_decode_attn``, the cross
    read of the packed tokens, a layer) and ``family_legacy`` (two
    ``flash_decode_attn`` a layer a decode), counting the cross reads
    apart (``flash_decode_attn.launches_unmasked``): all of the packed
    steps' reads and half the legacy decodes'."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.serving import plan_cfg
    cfg = get_config(WHISPER_ARCH)
    tag = f"[{WHISPER_ARCH}]"
    params = R.model_init(cfg, seed, dev)
    if ovsf_per_layer(params) or ovsf_per_layer(params["encoder"]):
        raise RuntimeError(f"{tag} an OVSF layer at d {cfg.d_model}")
    pcfg = plan_cfg(cfg, 4, dev)
    if pcfg.exec_plan.names():
        raise RuntimeError(f"{tag} plan {pcfg.exec_plan.names()}: expected "
                           "none (no OVSF layer)")
    tokens, frames = whisper_inputs(cfg, seed)
    L = cfg.n_layers
    run = entry_calls(params, pcfg, dev, tokens, {"frames": frames})
    check_entry_launches(tag, run, {}, {"flash_decode_attn": 2 * L})
    Te = cfg.encoder_seq
    if run["cross"] != ((L, 4, Te, cfg.n_kv_heads, cfg.hd),
                        "torch.bfloat16", True):
        raise RuntimeError(f"{tag} the prefill's cross caches {run['cross']}")
    bare = entry_calls(params, pcfg, dev, tokens, {}, steps=0)
    if bare["cross"][2]:
        raise RuntimeError(f"{tag} cross caches filled without frames")
    a, b = run["logits"][0], bare["logits"][0]
    gap = [float((a[r] - b[r]).norm() / b[r].norm()) for r in range(4)]
    if not min(gap) > 1e-2:
        raise RuntimeError(f"{tag} prefill logits with frames within {gap} "
                           "relative L2 of those without: the frames do not "
                           "reach the decoder")
    step_ms = statistics.median(run["secs"][1:]) * 1e3
    print(f"{tag} bf16 uncut ({cfg.encoder_layers} + {L} layers, d "
          f"{cfg.d_model}, Te {Te}): serve_prefill with frames (4 x "
          f"{Te} x {cfg.d_model}) and {tokens.shape[1]}-token prompts in "
          f"{run['secs'][0] * 1e3:.1f} ms, cross caches {run['cross'][0]} "
          f"{run['cross'][1]}; {ENTRY_STEPS} greedy steps, median "
          f"{step_ms:.2f} ms eager, {2 * L} flash_decode_attn each; the "
          f"frames move the prefill logits by {min(gap):.3f}-{max(gap):.3f} "
          f"relative L2 ({card})", flush=True)
    del bare
    c32 = get_config(WHISPER_ARCH).replace(dtype="float32")
    p32 = R.model_init(c32, seed + 3, dev)
    card32 = entry_calls(p32, c32, dev, tokens, {"frames": frames})
    cpu32 = entry_calls(R.params_to(p32, "cpu"), c32, torch.device("cpu"),
                        tokens, {"frames": frames}, feed=card32["fed"])
    del p32
    rel = rel_rows(card32["logits"], cpu32["logits"], f"{tag} fp32")
    worst = max(max(r) for r in rel)
    print(f"{tag} fp32 card vs CPU: prefill with frames and "
          f"{ENTRY_STEPS} steps, logits rel L2 err max {worst:.3e} (limit "
          f"1e-3); card {sum(card32['secs']):.3f}s, CPU "
          f"{sum(cpu32['secs']):.3f}s", flush=True)
    if not worst <= 1e-3:
        raise RuntimeError(f"{tag} fp32 card vs CPU relative error {rel}")
    serve = family_serve(params, cfg, seed, card, dev,
                         f"[{WHISPER_ARCH} paged packed]",
                         {"paged_flash_decode": L, "flash_decode_attn": L})
    legacy = family_legacy(params, cfg, seed, card, dev,
                           f"[{WHISPER_ARCH} legacy bucketed]", 2)
    # every packed step's flash_decode_attn is a cross read; a legacy
    # decode runs a self read and a cross read a layer
    flash = {"paged packed": serve, "legacy": legacy}
    if serve["flash_unmasked"] != serve["launches"]["flash_decode_attn"] or \
            2 * legacy["flash_unmasked"] != \
            legacy["launches"]["flash_decode_attn"]:
        raise RuntimeError(f"{tag} flash_decode_attn launches, all and "
                           "cross reads: " + ", ".join(
                               f"{k} {r['launches']['flash_decode_attn']} "
                               f"{r['flash_unmasked']}"
                               for k, r in flash.items()))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(entry=dict(prompt_len=int(tokens.shape[1]),
                           prefill_s=run["secs"][0], step_ms=step_ms,
                           cross=list(run["cross"][:2]), frames_gap=gap,
                           launches=run["launches"][1]),
                parity=dict(rel_err=rel, worst=worst), serve=serve,
                legacy=legacy)


def llava_plan(tag: str, cfg) -> dict:
    """The engine's plan on the card: the seven projections' entries, each
    ``fused``."""
    xplan = cfg.exec_plan
    plan = {n: p.path for n, p in xplan.entries}
    print(f"{tag} mapper plan (hw {xplan.hw_label}, decode at 4 slots): "
          + ", ".join(f"{n}={p}" for n, p in plan.items()), flush=True)
    if tuple(plan) != LLAVA_PLAN or set(plan.values()) != {"fused"}:
        raise RuntimeError(f"{tag} plan {plan}: expected {LLAVA_PLAN} all "
                           "fused")
    return plan


def llava_inputs(cfg, seed: int, n_img: int, lo: int, hi: int) -> tuple:
    """(4, n_img + St) tokens, St drawn in [lo, hi], and (4, n_img, d)
    image embeddings (N(0, 0.02^2), an embedding's scale), from
    ``seed``."""
    rng = np.random.default_rng(seed + 34)
    St = int(rng.integers(lo, hi + 1))
    tokens = rng.integers(0, cfg.vocab, (4, n_img + St))
    img = rng.standard_normal((4, n_img, cfg.d_model), np.float32) * 0.02
    return tokens, img


def llava_parity(seed: int, dev) -> dict:
    """Phase 12 (4): LLaVA-NeXT-34B at full width but
    ``LLAVA_PARITY_LAYERS`` layers in fp32 (TF32 off), planned as the engine
    plans it on the card: ``serve_prefill`` of 4 rows with
    ``LLAVA_PARITY_IMAGE`` image positions and 32 text tokens, then two
    decode steps, on the card and on the CPU with the same parameters (the
    card's greedy tokens fed to both): every call's logits within 1e-3
    relative L2."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.serving import plan_cfg
    cfg = plan_cfg(get_config(LLAVA_ARCH).replace(
        dtype="float32", n_layers=LLAVA_PARITY_LAYERS), 4, dev)
    params = R.model_init(cfg, seed + 3, dev)
    tokens, img = llava_inputs(cfg, seed, LLAVA_PARITY_IMAGE, 32, 32)
    card_run = entry_calls(params, cfg, dev, tokens, {"image_embeds": img},
                           steps=2)
    cpu_params = R.params_to(params, "cpu")
    del params
    torch.cuda.empty_cache()
    cpu_run = entry_calls(cpu_params, cfg, torch.device("cpu"), tokens,
                          {"image_embeds": img}, feed=card_run["fed"],
                          steps=2)
    rel = rel_rows(card_run["logits"], cpu_run["logits"], "[llava parity]")
    worst = max(max(r) for r in rel)
    print(f"[llava parity] {LLAVA_ARCH} full width, {cfg.n_layers} layers, "
          f"fp32: a prefill with {LLAVA_PARITY_IMAGE} image positions and 2"
          f" decode steps, logits rel L2 err max {worst:.3e} (per call "
          + ", ".join(f"{max(r):.2e}" for r in rel)
          + f"; limit 1e-3); card {sum(card_run['secs']):.3f}s, CPU "
          f"{sum(cpu_run['secs']):.3f}s", flush=True)
    if not worst <= 1e-3:
        raise RuntimeError(f"[llava parity] relative error {rel} > 1e-3")
    return dict(rel_err=rel, worst=worst, layers=cfg.n_layers,
                gpu_s=sum(card_run["secs"]), cpu_s=sum(cpu_run["secs"]))


def llava_phase(seed: int, card: str, dev) -> dict:
    """Phase 12 (3): LLaVA-NeXT-34B at full width (d 7168, 56/8 heads of
    128, d_ff 20480, vocab 64000; ``LLAVA_LAYERS`` of its 60 layers), bf16,
    OVSF rho 0.5 on the seven projections: the alphas at most 0.55x the
    dense bf16 bytes; the plan ``fused`` at every entry. ``serve_prefill``
    of 4 rows with the config's 1024 image positions (embeddings from the
    seed) and one text length in [32, 64] after them, then 16 greedy
    decode steps: 7 ``ovsf_gemm`` a layer a call (all tensor-core), one
    ``flash_decode_attn`` a layer a step. Then ``family_serve`` (7
    ``ovsf_gemm`` and one ``paged_flash_decode`` a layer a step) and
    ``family_legacy``; the decode step's device ms and its ``ovsf_gemm``
    share against the byte bound of the alphas and ``lm_head``."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.models import registry as R
    from repro_torch.serving import plan_cfg
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    cfg = get_config(LLAVA_ARCH).replace(n_layers=LLAVA_LAYERS)
    tag = f"[{LLAVA_ARCH}]"
    t0 = time.perf_counter()
    params = R.model_init(cfg, seed, dev)
    torch.cuda.synchronize()
    print(f"{tag} bf16 ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}): {R.param_count(params) / 1e9:.3f}"
          f"B stored values initialised on the card in "
          f"{time.perf_counter() - t0:.2f}s; allocated "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB before)", flush=True)
    resident = ovsf_resident(params, card, tag)
    n_ovsf = ovsf_per_layer(params)
    if n_ovsf != len(LLAVA_LAYER):
        raise RuntimeError(f"{tag} {n_ovsf} OVSF linears a block, expected "
                           f"{len(LLAVA_LAYER)}")
    pcfg = plan_cfg(cfg, 4, dev)
    plan = llava_plan(tag, pcfg)
    L = cfg.n_layers
    tokens, img = llava_inputs(cfg, seed, cfg.vlm_image_tokens, 32, 64)
    G.reset_launches()
    run = entry_calls(params, pcfg, dev, tokens, {"image_embeds": img})
    check_entry_launches(tag, run, {"ovsf_gemm": n_ovsf * L},
                         {"ovsf_gemm": n_ovsf * L, "flash_decode_attn": L})
    if G.ovsf_gemm.launches_by_kernel["tensor_core"] != \
            G.ovsf_gemm.launches:
        raise RuntimeError(f"{tag} ovsf_gemm by kernel "
                           f"{dict(G.ovsf_gemm.launches_by_kernel)}")
    step_ms = statistics.median(run["secs"][1:]) * 1e3
    print(f"{tag} serve_prefill of 4 x ({cfg.vlm_image_tokens} image + "
          f"{tokens.shape[1] - cfg.vlm_image_tokens} text) positions in "
          f"{run['secs'][0]:.3f}s ({n_ovsf * L} ovsf_gemm at M = "
          f"{tokens.size}); {ENTRY_STEPS} greedy steps, median "
          f"{step_ms:.2f} ms eager ({n_ovsf * L} ovsf_gemm, {L} "
          f"flash_decode_attn each) ({card})", flush=True)
    serve = family_serve(params, cfg, seed, card, dev,
                         f"[{LLAVA_ARCH} paged packed]",
                         {"ovsf_gemm": n_ovsf * L, "paged_flash_decode": L})
    legacy = family_legacy(params, cfg, seed, card, dev,
                           f"[{LLAVA_ARCH} legacy bucketed]", 1)
    head = params["lm_head"]["w"]
    bound_ms = (resident["alpha_bytes"] + head.nbytes) / HBM_BYTES_PER_S * 1e3
    pg = serve["decode_profile"]
    busy = pg["busy_ms"]
    print(f"{tag} the replayed chunk-free paged packed step: "
          f"{serve['replay_ms']:.3f} ms on the device (busy "
          + ("not measured" if busy is None else f"{busy:.3f} ms")
          + f"), ovsf_gemm {serve['ovsf_gemm_ms']:.3f} ms of it; byte bound "
          f"of the alphas and lm_head {bound_ms:.3f} ms "
          f"({(resident['alpha_bytes'] + head.nbytes) / 1e9:.2f} GB); "
          f"replay / bound {serve['replay_ms'] / bound_ms:.2f} ({card})",
          flush=True)
    del params, head
    gc.collect()
    torch.cuda.empty_cache()
    return dict(layers=L, resident=resident, plan=plan,
                entry=dict(text_len=int(tokens.shape[1])
                           - cfg.vlm_image_tokens,
                           prefill_s=run["secs"][0], step_ms=step_ms,
                           launches=run["launches"][1]),
                serve=serve, legacy=legacy, bound_ms=bound_ms,
                parity=llava_parity(seed, dev))


def encdec_vlm_phase(seed: int, card: str, dev) -> dict:
    """Phase 12 (module docstring): the encoder-decoder and VLM families at
    their published widths on the card."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 29)
    res = dict(kernels=run_encdec_vlm_kernel_checks(rng, dev))
    res[WHISPER_ARCH] = whisper_phase(seed, card, dev)
    res[LLAVA_ARCH] = llava_phase(seed, card, dev)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"[encdec/vlm] phase passed in {res['wall_s']:.1f}s", flush=True)
    return res


# -- phase 13: training -------------------------------------------------------

TRAIN_ARCH = "tinyllama_1_1b"
# TinyLlama-1.1B's five OVSF projections (d 2048, d_ff 5632; k and v, 2048
# -> 256, are dense): (d_in, d_out)
TRAIN_LAYER = {"q": (2048, 2048), "o": (2048, 2048), "gate": (2048, 5632),
               "up": (2048, 5632), "down": (5632, 2048)}
TRAIN_BATCH, TRAIN_SEQ = 8, 128     # the launcher's step: M = B * S = 1024
TRAIN_STEPS = 12                    # the launcher's steps ...
# ... and its checkpoint interval: one save, at the end (for the script's
# time: a save's write slows the steps after it)
TRAIN_SAVE_EVERY = 12
TRAIN_LR = 1e-3
TRAIN_FAULT_LAYERS = 2              # the supervisor run's depth (full width)
TRAIN_FAULT_STEPS = 6               # its steps, saving every 3: checkpoints
TRAIN_FAULT_SAVE_EVERY = 3          # at 3 and 6; a fail at 5 restores 3
TRAIN_FAULT_AT = 5                  # and replays steps 3 and 4
TRAIN_PARITY_LAYERS = 2             # card vs CPU: fp32, B 2, S 64
# ResNet-50's 13 OVSF convs at batch 8 as im2col GEMMs (M, K, N, convs):
# stages 1-3, rho 0.5, monolithic codes of L = next_pow2(K)
RESNET50_CONVS = ((6272, 1152, 128, 4), (1568, 2304, 256, 6),
                  (392, 4608, 512, 3))
CNN_TRAIN_BATCH = 8
# (arch, image side, train-mode gradients gated at 1e-3) of the CNN train
# checks: ResNet-50 at its published size, timed; ResNet-18 at the CPU
# tests' 64 x 64, where its train-mode gradients are well conditioned
# (``cnn_train_phase``)
CNN_TRAIN_CASES = (("resnet50", 224, False), ("resnet18", 64, True))
CNN_WELL_CONDITIONED = 1e-4     # the CPU's gradient move under a 1e-6 image
                                # move that a 1e-3 comparison needs


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    # moved in its own type, widened where the sums run
    g, w = got.detach().double(), want.detach().to(got.device).double()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def grads_of(fn, inputs: list, g: torch.Tensor) -> tuple:
    """(output, gradients of ``inputs``) of ``fn(*inputs)`` against dy
    ``g``, on fresh leaves."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    y = fn(*leaves)
    return y.detach(), torch.autograd.grad(y, leaves, g)


def grad_check(tag: str, kernel_fn, plain_fn, inputs: list, g, dt,
               names: tuple = ("y", "dx", "dA")) -> float:
    """y and the gradients of ``inputs`` (``names``: y's, then each
    input's) through the kernel path against autograd through the plain
    version on the same inputs: relative L2 within ``TOL[dt]``; returns
    the largest absolute error of the gradients."""
    yk, gk = grads_of(kernel_fn, inputs, g)
    yp, gp = grads_of(plain_fn, inputs, g)
    torch.cuda.synchronize()
    errs = {n: rel_l2(a, b) for n, a, b in
            zip(names, (yk,) + tuple(gk), (yp,) + tuple(gp))}
    bad = {n: e for n, e in errs.items() if not e <= TOL[dt]}
    finite = all(torch.isfinite(t).all() for t in (yk,) + tuple(gk))
    if bad or not finite:
        raise RuntimeError(f"{tag}: relative L2 {errs} beyond {TOL[dt]} "
                           f"(finite {finite})")
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(gk, gp))


def queued_ms(call, n: int) -> float:
    """Device ms per ``call``: CUDA events around n calls queued behind a
    spin kernel (``torch.cuda._sleep``) that lasts twice the host's time
    to enqueue them, so the device runs them back to back and the host's
    launch gaps (an autograd call is host-bound at these sizes) are not in
    the number. A call must not synchronise with the host."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * SPIN_HZ))
    start.record()
    for _ in range(n):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def fwd_bwd_ms(fn, inputs: list, g, iters: int = 6) -> float:
    """Device ms of one forward + backward of ``fn`` (``queued_ms``)."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    return queued_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, g),
                     iters)


def ovsf_train_bound(M: int, K: int, N: int, J: int, wht_row: int,
                     dtype, idx_bytes: int, alpha_bytes: int = 0) -> dict:
    """Least device ms of y = x S^T A, forward alone and forward +
    backward, whatever the path: every input (x, alphas, ids; dy) read and
    every output (y; dx, dA) written once, or the function's operations.
    Those are the products with the J kept codes, 2 M J N forward and 4 M J
    N backward (dA = (x S^T)^T dy, dy A^T), at the operands' peak (bf16:
    the tensor cores), and ``wht_row`` WHT adds a row of x forward and of
    dy A^T backward, at the fp32 rate outside the tensor cores. Quantised
    alphas (``alpha_bytes``: the stored integers and scales) are read once,
    and their gradient is the scales' (a few bytes), in place of a float A
    and dA."""
    item = torch.tensor([], dtype=dtype).element_size()
    out = {}
    for key, prods, whts, elems, a_elems in (
            ("forward", 2, 1, M * K + M * N, J * N),
            ("train", 6, 2, 2 * (M * K + M * N), 2 * J * N)):
        t_ops = (prods * M * J * N / PEAK_FLOPS[dtype]
                 + whts * M * wht_row / FP32_CUDA_CORE_FLOPS) * 1e3
        t_mem = (item * elems + (alpha_bytes or item * a_elems)
                 + idx_bytes) / HBM_BYTES_PER_S * 1e3
        out[key] = (t_ops, t_mem)
    return out


def host_us(call, n: int = 3000) -> float:
    """Host microseconds per ``call`` over n calls in a row (the device
    keeps up at the sizes it is given)."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def forward_ms(fn, inputs: list, iters: int = 6) -> float:
    """Device ms of ``fn``'s forward alone, autograd off (``queued_ms``)."""
    with torch.no_grad():
        return queued_ms(lambda: fn(*inputs), iters)


def train_gemm_row(rng, dev, M: int, K: int, N: int, tag: str) -> dict:
    """One segmented OVSF projection's forward + backward at (M, K -> N),
    bf16: the ``ovsf_gemm`` forward on the tensor-core kernel, dx and dA
    within ``TOL`` of autograd through the plain version; device ms of the
    forward + backward (``fwd_bwd_ms``) and of the forward alone, the plain
    version's, ``torch.matmul`` forward + backward on a dense W, and the
    bound (``ovsf_train_bound``)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ovsf_gemm import ovsf_gemm, ovsf_gemm_plain
    x, al, idx, nk = gemm_case(rng, 16, M, K, N, torch.bfloat16, dev)
    g = torch.randn((M, N), device=dev, dtype=torch.bfloat16)
    before = ovsf_gemm.launches_by_kernel["tensor_core"]
    err = grad_check(tag, lambda a, b: ops.ovsf_gemm_fn(a, b, idx),
                     lambda a, b: ovsf_gemm_plain(a, b, idx), [x, al],
                     g, torch.bfloat16)
    if ovsf_gemm.launches_by_kernel["tensor_core"] != before + 1:
        raise RuntimeError(f"{tag}: not on the tensor-core kernel")
    J = al.shape[0]
    ms = fwd_bwd_ms(lambda a, b: ops.ovsf_gemm_fn(a, b, idx), [x, al], g)
    plain_ms = fwd_bwd_ms(lambda a, b: ovsf_gemm_plain(a, b, idx),
                          [x, al], g, 2)
    fwd = forward_ms(lambda a, b: ops.ovsf_gemm_fn(a, b, idx), [x, al])
    W = torch.randn((K, N), device=dev, dtype=torch.bfloat16)
    lib_ms = fwd_bwd_ms(torch.matmul, [x, W], g)
    bd = ovsf_train_bound(M, K, N, J, K * 4,     # log2 16 = 4 stages
                          torch.bfloat16, idx.numel() * 4)
    t_ops, t_mem = bd["train"]
    row = dict(case=tag, M=M, K=K, N=N, J=J, max_abs_err=err, ms=ms,
               forward_ms=fwd, backward_ms=ms - fwd, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=max(t_ops, t_mem),
               bound_by="operations" if t_ops >= t_mem else "bytes",
               forward_bound_ms=max(bd["forward"]))
    print(f"{tag}: dx, dA within {TOL[torch.bfloat16]} relative L2 of "
          f"autograd through the plain version (max abs err {err:.3e});"
          f" forward + backward {ms:.4f} ms (the kernel's forward "
          f"{fwd:.4f} ms, bound {row['forward_bound_ms']:.4f}; the "
          f"backward's plain code and matmuls {ms - fwd:.4f}), plain "
          f"{plain_ms:.4f} ms, matmul on a dense W {lib_ms:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return row


def run_train_kernel_checks(rng, dev) -> dict:
    """Phase 13 (1): each autograd wrapper's dx and dA against autograd
    through its kernel's plain version on the card. TinyLlama's five
    projections at M 1024 in bf16 (``ovsf_gemm`` forward on the tensor-core
    kernel, the segmented backward plain tensor code), one fp32 projection
    on the CUDA-core kernel, ResNet-50's conv GEMMs at batch 8 in fp32 under
    ``materialize``, ``fused`` (the monolithic kernel) and ``spectral``;
    ``fwht``'s backward equal to the plain transform of dy bit for bit.
    Forward + backward device ms (``fwd_bwd_ms``) beside
    ``torch.matmul`` forward + backward on a dense W that requires grad,
    and the forward alone (the kernel; the rest is the backward's plain
    code and ``torch.matmul``). Bounds: ``ovsf_train_bound``."""
    from repro_torch.core.ovsf import next_pow2
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import fwht_plain
    from repro_torch.kernels.ovsf_gemm import (ovsf_decompress_plain,
                                               ovsf_gemm, ovsf_gemm_plain)
    F = torch.nn.functional
    res = {"lm": [], "cnn": {}}
    M = TRAIN_BATCH * TRAIN_SEQ
    for name, (K, N) in TRAIN_LAYER.items():
        res["lm"].append(train_gemm_row(
            rng, dev, M, K, N,
            f"[train kernel] ovsf_gemm {name} M={M} {K}->{N} bf16"))
    # what the serving path saves by calling the wrapper, and not the
    # Function, where autograd records nothing (``ops.ovsf_gemm_fn``)
    x, al, idx, _nk = gemm_case(rng, 16, 4, 2048, 2048, torch.bfloat16, dev)
    with torch.no_grad():
        res["host_us"] = {
            "wrapper": host_us(lambda: ovsf_gemm(x, al, idx)),
            "function": host_us(lambda: ops.OvsfGemmFn.apply(x, al, idx))}
    print("[train kernel] host us a call, q at M=4 bf16 under no_grad: "
          f"the wrapper {res['host_us']['wrapper']:.2f}, the autograd "
          f"Function {res['host_us']['function']:.2f}", flush=True)
    # fp32 x over segmented codes: the CUDA-core kernel
    x, al, idx, _nk = gemm_case(rng, 16, 256, 2048, 2048, torch.float32, dev)
    g = torch.randn((256, 2048), device=dev)
    before = ovsf_gemm.launches_by_kernel["cuda_core"]
    tag = "[train kernel] ovsf_gemm q M=256 2048->2048 fp32 (cuda_core)"
    err = grad_check(tag, lambda a, b: ops.ovsf_gemm_fn(a, b, idx),
                     lambda a, b: ovsf_gemm_plain(a, b, idx), [x, al], g,
                     torch.float32)
    if ovsf_gemm.launches_by_kernel["cuda_core"] != before + 1:
        raise RuntimeError(f"{tag}: not on the CUDA-core kernel")
    res["fp32_cuda_core_err"] = err
    print(f"{tag}: within {TOL[torch.float32]} (max abs err {err:.3e})",
          flush=True)

    def spectral_plain(a, b, idx, K):
        L = next_pow2(K)
        return fwht_plain(F.pad(a, (0, L - K)))[:, idx.long()] @ b

    plains = {
        "materialize": lambda idx, K: (lambda a, b: a @ ovsf_decompress_plain(
            b, idx, K)),
        "fused": lambda idx, K: (lambda a, b: ovsf_gemm_plain(a, b, idx)),
        "spectral": lambda idx, K: (lambda a, b: spectral_plain(a, b, idx,
                                                                K))}
    for path in ops.EXEC_PATHS:
        tot = dict(ms=0.0, forward_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bound_ms=0.0, max_abs_err=0.0, t_ops=0.0, t_mem=0.0)
        for M_, K, N, count in RESNET50_CONVS:
            x, al, idx, _nk = gemm_case(rng, 0, M_, K, N, torch.float32,
                                        dev)
            g = torch.randn((M_, N), device=dev)
            tag = f"[train kernel] {path} M={M_} {K}->{N} fp32"

            def kern(a, b, idx=idx):
                return ops.ovsf_matmul(a, b, idx, path=path)
            err = grad_check(tag, kern, plains[path](idx, K), [x, al], g,
                             torch.float32)
            J, L = al.shape[0], next_pow2(K)
            ms = fwd_bwd_ms(kern, [x, al], g)
            fwd = forward_ms(kern, [x, al])
            plain_ms = fwd_bwd_ms(plains[path](idx, K), [x, al], g, 2)
            W = torch.randn((K, N), device=dev)
            lib_ms = fwd_bwd_ms(torch.matmul, [x, W], g)
            # one function whatever the path, so one bound
            t_ops, t_mem = ovsf_train_bound(
                M_, K, N, J, L * (L.bit_length() - 1), torch.float32,
                J * 4)["train"]
            for k, v in (("ms", ms), ("forward_ms", fwd),
                         ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("t_ops", t_ops), ("t_mem", t_mem)):
                tot[k] += count * v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            print(f"{tag}: within {TOL[torch.float32]} (max abs err "
                  f"{err:.3e}); forward + backward {ms:.4f} ms (forward "
                  f"{fwd:.4f}), plain {plain_ms:.4f} ms, matmul on a dense W "
                  f"{lib_ms:.4f} ms", flush=True)
            if path == "spectral":
                xp = F.pad(x, (0, L - K))
                gp = torch.randn_like(xp)
                _y, (got,) = grads_of(ops.FwhtFn.apply, [xp], gp)
                if not torch.equal(got, fwht_plain(gp)):
                    raise RuntimeError(f"{tag}: fwht's backward is not the "
                                       "plain transform of dy bit for bit")
        tot["bound_ms"] = max(tot["t_ops"], tot["t_mem"])
        tot["bound_by"] = ("operations" if tot["t_ops"] >= tot["t_mem"]
                           else "bytes")
        res["cnn"][path] = tot
        print(f"[train kernel] ResNet-50's 13 OVSF conv GEMMs under {path}, "
              f"batch 8, forward + backward: {tot['ms']:.3f} ms (forward "
              f"{tot['forward_ms']:.3f}; plain "
              f"{tot['plain_ms']:.3f}, matmul on dense W "
              f"{tot['library_ms']:.3f}, bound {tot['bound_ms']:.3f} ms, "
              f"{tot['bound_by']})", flush=True)
    return res


def cnn_grads(params: dict, state: dict, cfg, x, labels,
              train: bool = True) -> tuple:
    """(loss, {(layer, key): gradient}, new BN state) of ``cnn_loss``."""
    from repro_torch.models import cnn
    live = {n: {k: (t.detach().requires_grad_() if t.is_floating_point()
                    else t) for k, t in layer.items()}
            for n, layer in params.items()}
    loss, (new_st, _lg) = cnn.cnn_loss(live, state, cfg, x, labels, train)
    keys = [(n, k) for n, layer in live.items() for k, t in layer.items()
            if t.requires_grad]
    gs = torch.autograd.grad(loss, [live[n][k] for n, k in keys])
    return loss.detach(), dict(zip(keys, gs)), new_st


def grads_rel(got: dict, want: dict) -> float:
    """Relative L2 of every gradient at once."""
    return rel_l2(torch.cat([got[k].flatten().cpu() for k in want]),
                  torch.cat([want[k].flatten().cpu() for k in want]))


def cnn_plan_launches(cfg) -> dict:
    """Kernel launches of one ResNet-50 train step by the plan's paths:
    ``materialize`` (or no plan) one ``ovsf_decompress`` forward and one
    ``fwht`` backward (dA), ``fused`` one ``ovsf_gemm`` forward, one
    ``ovsf_decompress`` (dx) and one ``fwht`` (dA) backward, ``spectral``
    one ``fwht`` forward and one backward (d pad(x))."""
    from collections import Counter
    from repro_torch.models import cnn
    names = [d["name"] for d in cnn._resnet_layers(cfg)
             if d["k"] == 3 and d["rho"] < 1.0]
    plans = [cfg.exec_plan.plan_for(n) if cfg.exec_plan is not None
             else None for n in names]
    paths = [lp.path if lp is not None else "materialize" for lp in plans]
    per = {"materialize": (1, 0, 1), "fused": (1, 1, 1),
           "spectral": (0, 0, 2)}
    want = dict(ovsf_decompress=0, ovsf_gemm=0, fwht=0)
    for p in paths:
        for k, n in zip(want, per[p]):
            want[k] += n
    return want, dict(Counter(paths))


def bn_layer_errs(got: dict, want: dict) -> dict:
    """Relative L2 of each BN layer's new running mean and variance."""
    return {f"{n}.{k}": rel_l2(got[n][k].cpu(), want[n][k])
            for n in want for k in ("mean", "var")}


def cnn_plans(base) -> list:
    """(label, planned config) of the default, ``("fused",)`` and
    ``ALL_PATHS`` h100 plans at the train batch."""
    from repro_torch.runtime.mapper import ALL_PATHS, DEFAULT_PATHS, plan_cnn
    return [(label, base.replace(exec_plan=plan_cnn(
                base, batch=CNN_TRAIN_BATCH, hw="h100", paths=paths)))
            for label, paths in (("+".join(DEFAULT_PATHS), DEFAULT_PATHS),
                                 ("fused", ("fused",)),
                                 ("ALL_PATHS", ALL_PATHS))]


def cnn_inputs(arch: str, side: int, seed: int, dev,
               batch: int = CNN_TRAIN_BATCH, width: float = 1.0) -> tuple:
    """Matrix-mode ``arch`` at ``width`` from ``seed`` on the CPU and on
    ``dev``, and ``batch`` side x side images, labels and a 1e-6 move of
    the images, from the seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import cnn
    base = get_config(arch).replace(ovsf_mode="matrix", width_mult=width)
    p_cpu, s_cpu = cnn.cnn_init(base, seed, "cpu")
    rng = np.random.default_rng(seed + 30)
    shape = (batch, side, side, 3)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32))
    labels = torch.from_numpy(rng.integers(0, base.num_classes, batch))
    noise = torch.from_numpy(rng.standard_normal(shape, np.float32)) * 1e-6
    on = {n: {k: t.to(dev) for k, t in d.items()} for n, d in p_cpu.items()}
    st = {n: {k: t.to(dev) for k, t in d.items()} for n, d in s_cpu.items()}
    return base, (p_cpu, s_cpu), (on, st), x, labels, noise


def cnn_train_phase(seed: int, card: str, dev) -> dict:
    """Phase 13 (6): ``cnn_loss`` in matrix mode, fp32, batch 8, under the
    default, ``("fused",)`` and ``ALL_PATHS`` h100 plans, against the CPU
    port (unplanned, ``materialize``) on the same weights and images: each
    kernel's launches a step equal the plan's, the loss within 1e-4, each
    BN layer's new running mean and variance within 1e-5 relative L2.

    A random-init OVSF ResNet's train-mode gradients are often
    ill-conditioned: train-mode BN divides by a channel's batch std, and
    a channel of large mean and small std (the all-ones code sums positive
    inputs) turns rounding into gradient. How far depends on the weights
    and images: an image move of 1e-6 shifts ResNet-50's 0.6-5% on the
    CPU at every batch and side tried, ResNet-18's 7e-6-1e-2 by seed and
    side (``tools/cnn_conditioning.py``). So ResNet-50 (224 x 224) holds
    its gradients within 1e-3 relative
    L2 (all leaves at once) in eval mode, and its train-mode ones only
    within 3x its own move on the card (or 1e-3), printed; its forward +
    backward wall and device ms (``queued_ms``) are timed. ResNet-18 (64
    x 64) holds its train-mode gradients within 1e-3, once the CPU's move
    shows the comparison is well conditioned (``CNN_WELL_CONDITIONED``):
    it fails if not."""
    res = {}
    for arch, side, gated in CNN_TRAIN_CASES:
        base, (p_cpu, s_cpu), (params, state), x, labels, noise = \
            cnn_inputs(arch, side, seed, dev)
        t0 = time.perf_counter()
        want_loss, want_g, want_st = cnn_grads(p_cpu, s_cpu, base, x, labels)
        if not gated:
            _l, want_eval, _s = cnn_grads(p_cpu, s_cpu, base, x, labels,
                                          train=False)
        else:
            _l, g_cpu, _s = cnn_grads(p_cpu, s_cpu, base, x + noise, labels)
            cpu_moved = grads_rel(g_cpu, want_g)
            print(f"[train cnn {arch}] {side} x {side}, batch "
                  f"{CNN_TRAIN_BATCH}: an image move of 1e-6 moves the CPU's "
                  f"train-mode gradients {cpu_moved:.2e} (at most "
                  f"{CNN_WELL_CONDITIONED:.0e} for a 1e-3 comparison)",
                  flush=True)
            if not cpu_moved <= CNN_WELL_CONDITIONED:
                raise RuntimeError(f"[train cnn {arch}] train-mode gradients"
                                   f" ill-conditioned ({cpu_moved:.2e})")
        cpu_s = time.perf_counter() - t0
        xd, ld = x.to(dev), labels.to(dev)
        out = {"cpu_s": cpu_s, "side": side}
        if gated:
            out["cpu_moved"] = cpu_moved
        for label, cfg in cnn_plans(base):
            tag = f"[train cnn {arch} {label}]"
            want, by_path = cnn_plan_launches(cfg)
            reset_wrapper_counts()
            loss, g, st = cnn_grads(params, state, cfg, xd, ld)
            torch.cuda.synchronize()
            got = {k: v for k, v in wrapper_counts().items() if k in want}
            if got != want or not torch.isfinite(loss):
                raise RuntimeError(f"{tag} launched {got} in a train step, "
                                   f"the plan ({by_path}) says {want}; loss "
                                   f"{loss}")
            _l, g_moved, _s = cnn_grads(params, state, cfg, xd + noise.to(dev),
                                        ld)
            loss_err = abs(float(loss) - float(want_loss)) / abs(
                float(want_loss))
            train_err = grads_rel(g, want_g)
            moved = grads_rel(g_moved, g)
            bn = bn_layer_errs(st, want_st)
            bn_worst = max(bn, key=bn.get)
            row = dict(launches=got, paths=by_path, loss_err=loss_err,
                       train_grad_err=train_err, train_grad_moved=moved,
                       bn_layer_max=bn[bn_worst], bn_worst=bn_worst)
            line = (f"{tag} plan {by_path}: launches a step {got} (the "
                    f"plan's); batch {CNN_TRAIN_BATCH}, {side} x {side}, vs "
                    f"the CPU: loss "
                    f"{loss_err:.2e} (limit 1e-4), BN statistics per layer "
                    f"at most {bn[bn_worst]:.2e} ({bn_worst}; limit 1e-5), "
                    f"train-mode gradients {train_err:.2e} (an image move "
                    f"of 1e-6 moves them {moved:.2e} on the card)")
            if not gated:
                ms = time_ms([lambda: cnn_grads(params, state, cfg, xd, ld)],
                             3)
                dev_ms = queued_ms(lambda: cnn_grads(params, state, cfg, xd,
                                                     ld), 3)
                _l, g_eval, _s = cnn_grads(params, state, cfg, xd, ld,
                                           train=False)
                eval_err = grads_rel(g_eval, want_eval)
                limit = max(1e-3, 3 * moved)
                row.update(ms=ms, queued_ms=dev_ms, eval_grad_err=eval_err)
                line += (f", limit {limit:.2e}; eval-mode gradients "
                         f"{eval_err:.2e} (limit 1e-3); forward + backward "
                         f"{ms:.2f} ms wall, {dev_ms:.2f} ms on the device "
                         f"queued ({card})")
                ok = eval_err <= 1e-3 and train_err <= limit
            else:
                line += ", limit 1e-3"
                ok = train_err <= 1e-3
            print(line, flush=True)
            if not (ok and loss_err <= 1e-4 and bn[bn_worst] <= 1e-5):
                raise RuntimeError(f"{tag} card vs CPU: {row}")
            out[label] = row
        res[arch] = out
        del params, state
        torch.cuda.empty_cache()
    return res


def train_parity(seed: int, dev) -> dict:
    """Phase 13 (4): one train step of TinyLlama at full width,
    ``TRAIN_PARITY_LAYERS`` layers, fp32, B 2, S 64, on the card and on the
    CPU from the same state, both under the config's ``materialize`` (the
    segmented ``ovsf_decompress`` kernel on the card, its plain version on
    the CPU), and on the card again under an explicit ``fused`` plan (the
    CUDA-core ``ovsf_gemm``): the loss within 1e-5 relative, every
    gradient leaf and every updated param within 1e-3 relative L2 of the
    CPU's, for each card path."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train import optim, steps
    cfg = get_config(TRAIN_ARCH).replace(n_layers=TRAIN_PARITY_LAYERS,
                                         dtype="float32")
    cpu = steps.train_state_init(cfg, seed, "cpu")
    card = optim.tree_map(lambda _p, t: t.to(dev), cpu)
    toks = torch.from_numpy(TokenStream(cfg.vocab, 64, 2, seed=seed)
                            .batch_at(0)["tokens"])
    ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
    out, launched = {}, {}
    for name, st, d, c in (
            ("cpu", cpu, "cpu", cfg), ("materialize", card, dev, cfg),
            ("fused", card, dev, fused_cfg(cfg, tuple(toks.shape)))):
        reset_wrapper_counts()
        loss, _m, g = steps.loss_and_grads(c, st["params"],
                                           {"tokens": toks.to(d)})
        new_p, _o, _mm = optim.adamw_update(ocfg, g, st["opt"], st["params"])
        out[name] = (loss, optim.tree_leaves(g), optim.tree_leaves(new_p))
        launched[name] = {k: v for k, v in wrapper_counts().items() if v}
    lh, gh, ph = out.pop("cpu")
    res = {}
    for path, (lc, gc_, pc) in out.items():
        loss_err = abs(float(lc) - float(lh)) / abs(float(lh))
        g_err = max(rel_l2(a, b) for a, b in zip(gc_, gh) if a is not None)
        p_err = max(rel_l2(a.float(), b.float()) for a, b in zip(pc, ph)
                    if a.is_floating_point())
        print(f"[train parity] {cfg.name} fp32, {cfg.n_layers} layers, B 2 "
              f"S 64: card under {path} (launched {launched[path]}) vs the "
              f"CPU under materialize: loss {float(lc):.6f} vs "
              f"{float(lh):.6f} ({loss_err:.2e}, limit 1e-5), gradients "
              f"{g_err:.2e}, updated params {p_err:.2e} (limit 1e-3 "
              "relative L2)", flush=True)
        if not (loss_err <= 1e-5 and g_err <= 1e-3 and p_err <= 1e-3
                and set(launched[path]) == {PATH_KERNEL[path]}):
            raise RuntimeError(f"[train parity] {path}: loss {loss_err}, "
                               f"gradients {g_err}, params {p_err}, "
                               f"launched {launched[path]}")
        res[path] = dict(loss_err=loss_err, grad_err=g_err,
                         param_err=p_err, launched=launched[path])
    return res


def train_supervised(seed: int, dev, tmp: str, arch: str = TRAIN_ARCH,
                     n_layers: int = TRAIN_FAULT_LAYERS,
                     tag: str = "[train supervisor]",
                     exact: bool = False) -> dict:
    """Phase 13 (3): ``supervisor.run`` of ``arch`` at full width,
    ``n_layers`` layers, bf16, B 8, S 128, under the config's own path
    (``materialize``: the segmented ``ovsf_decompress`` kernel), without
    and with a ``FaultPlan`` ``fail`` between two
    checkpoints, both under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: one failure, a restore, and the replayed steps'
    losses equal the uninterrupted run's bit for bit (unless ``exact``,
    within 1e-3 relative where an op of the step warned that it has no
    deterministic implementation; the op is printed). The final
    checkpoint restores with CRC verification bit for bit equal to the
    state in memory, and a flipped byte in one leaf makes ``restore``
    raise naming that leaf."""
    import warnings
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.runtime import supervisor
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.train import optim, steps
    cfg = get_config(arch).replace(n_layers=n_layers)
    ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=2,
                           total_steps=TRAIN_FAULT_STEPS)
    stream = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    runs, logs = {}, []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            # the uninterrupted run needs no checkpoint but its last
            for name, plan, every in (
                    ("clean", None, TRAIN_FAULT_STEPS),
                    ("fault", FaultPlan.parse([f"fail:step={TRAIN_FAULT_AT}"]),
                     TRAIN_FAULT_SAVE_EVERY)):
                state = steps.train_state_init(cfg, seed, dev)
                runs[name] = supervisor.run(
                    steps.make_train_step(cfg, ocfg), state, stream.batch_at,
                    TRAIN_FAULT_STEPS, supervisor.SupervisorConfig(
                        ckpt_dir=os.path.join(tmp, name), save_every=every,
                        log_every=1000),
                    faults=plan, log=logs.append)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0][:120]
                     for w in caught if "deterministic" in str(w.message)})
    (cs, crep), (fs, frep) = runs["clean"], runs["fault"]
    start = TRAIN_FAULT_AT // TRAIN_FAULT_SAVE_EVERY * TRAIN_FAULT_SAVE_EVERY
    want = crep.losses[:TRAIN_FAULT_AT] + crep.losses[start:]
    if frep.failures != 1 or frep.restores < 1 or len(frep.losses) != len(
            want) or not all(math.isfinite(v) for v in frep.losses):
        raise RuntimeError(f"{tag} failures {frep.failures} restores "
                           f"{frep.restores} losses {frep.losses}: {logs}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(frep.losses, want))
    if (rel != 0.0 if exact or not nondet else rel > 1e-3):
        raise RuntimeError(f"{tag} replayed losses {frep.losses} vs the "
                           f"uninterrupted run's {want} (max rel {rel}; ops "
                           f"without a deterministic implementation: "
                           f"{nondet})")
    fault_dir = os.path.join(tmp, "fault")
    got, step = ckpt.restore(fault_dir, template=ckpt.spec_of(fs))
    pairs = list(zip(optim.tree_leaves(got), optim.tree_leaves(fs)))
    if step != TRAIN_FAULT_STEPS or not all(
            a.device == b.device and torch.equal(a, b) for a, b in pairs):
        raise RuntimeError(f"{tag} the final checkpoint (step {step}) does "
                           "not restore bit for bit")
    path = os.path.join(fault_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        leaf = json.load(f)["leaves"][5]
    fp = os.path.join(path, leaf["file"])
    with open(fp, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))
    try:
        ckpt.restore(fault_dir, template=ckpt.spec_of(fs))
    except ValueError as e:
        if repr(leaf["path"]) not in str(e):
            raise RuntimeError(f"{tag} the flipped leaf {leaf['path']} is "
                               f"not named: {e}") from e
    else:
        raise RuntimeError(f"{tag} a flipped byte in {leaf['path']} "
                           "restored without an error")
    print(f"{tag} {cfg.name} bf16, {cfg.n_layers} layers: fail at step "
          f"{TRAIN_FAULT_AT} -> failures {frep.failures}, restores "
          f"{frep.restores}, steps {start}-{TRAIN_FAULT_AT - 1} replayed, "
          f"losses {'equal bit for bit' if rel == 0 else f'within {rel:.1e}'}"
          f" (ops without a deterministic implementation: {nondet or 'none'})"
          f"; the final checkpoint restores bit for bit, a flipped byte in "
          f"{leaf['path']} is refused", flush=True)
    return dict(failures=frep.failures, restores=frep.restores,
                losses=frep.losses, clean_losses=crep.losses,
                max_rel=rel, nondeterministic=nondet,
                flipped_leaf=leaf["path"])


def fused_cfg(cfg, tokens_shape: tuple):
    """``cfg`` with every OVSF weight type planned ``fused`` by the mapper
    for a (B, S) train step (a MoE's three expert types under its one
    collapsed entry ``e``, copied from the reference; ROADMAP C) and the
    plan applied explicitly (``mapper.apply_plan``): the path of the
    ``OvsfGemmFn`` rows. The steps themselves run a config as given, the
    reference's ``materialize`` unless a plan says otherwise."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import mapper
    B, S = tokens_shape
    plan = mapper.plan_model(cfg, ShapeConfig("train_step", S, B, "train"),
                             hw="h100", paths=("fused",))
    return mapper.apply_plan(cfg, plan)


def ovsf_wrapper(cfg) -> str:
    """The kernel wrapper every OVSF linear of ``cfg`` launches: the
    segmented ``ovsf_decompress`` under ``materialize`` (the config's own
    path, unplanned, or a plan without entries: a model with no OVSF
    layer), ``ovsf_gemm`` under a plan of ``fused`` alone."""
    paths = ({p.path for _n, p in cfg.exec_plan.entries}
             if cfg.exec_plan else set()) or {cfg.ovsf.exec_path}
    wrapper = {"materialize": "ovsf_decompress", "fused": "ovsf_gemm"}
    if len(paths) != 1 or next(iter(paths)) not in wrapper:
        raise RuntimeError(f"{cfg.name}: paths {paths}, not one of "
                           f"{sorted(wrapper)}")
    return wrapper[paths.pop()]


def check_ovsf_launches(tag: str, cfg, launches: dict, layouts: dict,
                        by_kernel: dict, per_step: int, n_steps: int,
                        banks: int = 0) -> None:
    """The wrappers' counters over ``n_steps`` train steps of ``cfg``:
    ``per_step`` a step of ``ovsf_wrapper(cfg)``, every one segmented
    (``ovsf_decompress``) or on the tensor-core kernel (``ovsf_gemm``),
    ``banks`` segmented ``ovsf_decompress`` a step besides under either
    path (expert banks, ``train_banks_per_step``), and nothing else of
    ours."""
    w = ovsf_wrapper(cfg)
    want = dict.fromkeys(launches, 0)
    want[w] = per_step * n_steps
    want["ovsf_decompress"] += banks * n_steps
    kind = (layouts["seg"] if w == "ovsf_decompress"
            else by_kernel["tensor_core"])
    if (launches != want or kind != want[w]
            or layouts["seg"] != want["ovsf_decompress"]):
        raise RuntimeError(f"{tag} launched {launches} ({w}: {kind} "
                           f"segmented / tensor-core; ovsf_decompress by "
                           f"layout {layouts}), expected {want}")


def ovsf_linears(tree) -> int:
    """OVSF linears in a param tree: dicts with ``idx`` and 2-d alphas,
    float or quantised (an expert bank's (E, J, d_out) alphas regenerate W
    through one segmented ``ovsf_decompress`` under every plan and launch
    no ``ovsf_gemm``: ``ovsf_banks``)."""
    if isinstance(tree, list):
        return sum(ovsf_linears(t) for t in tree)
    if not isinstance(tree, dict):
        return 0
    al = next((tree[k] for k in ("alphas", "alphas_q8", "alphas_q4")
               if k in tree), None)
    own = int("idx" in tree and al is not None and al.dim() == 2)
    return own + sum(ovsf_linears(v) for v in tree.values())


def train_banks_per_step(cfg, params) -> int:
    """Segmented ``ovsf_decompress`` launches of one train step from expert
    banks (``ovsf_banks``), under every plan but ``spectral``: each bank's
    W once a forward, twice under remat (the forward, then its recompute
    in the backward); its backward launches none."""
    return (2 if cfg.remat else 1) * ovsf_banks(params["blocks"])


def train_gemms_per_step(cfg, params) -> int:
    """OVSF kernel launches of one train step under remat, ``ovsf_gemm``
    (``fused``) or the segmented ``ovsf_decompress`` (``materialize``), one
    an OVSF linear's forward: each stacked block's linears twice (the
    forward, then its recompute in the backward), the encoder's too; the
    hybrid's shared block once an application (applied outside the
    checkpoints, as the reference applies it); the segmented backward
    launches none under either path."""
    from repro_torch.models.transformer import n_attn_apps
    n = 2 * ovsf_linears(params["blocks"])
    n += 2 * ovsf_linears(params.get("encoder", {}).get("blocks", []))
    if cfg.family == "hybrid":
        n += n_attn_apps(cfg) * ovsf_linears(params["shared_attn"])
    return n


def launcher_run(seed: int, card: str, dev, ck: str, arch: str,
                 n_steps: int, save_every: int, tag: str,
                 lr: float = TRAIN_LR, refit_first: bool = False) -> tuple:
    """``python -m repro_torch.launch.train --arch <arch>`` in this process
    at full width and depth (``main``'s argv; B ``TRAIN_BATCH``, S
    ``TRAIN_SEQ``, learning rate ``lr``), so under the config's own
    ``materialize``: exit without an error, finite losses, the last below
    the first (with ``refit_first``: the first batch's loss under the
    trained params below its loss at step 0, and a held-out batch's
    printed), ``train_gemms_per_step`` segmented ``ovsf_decompress``
    launches a step and nothing else of ours (``check_ovsf_launches``),
    the checkpoints every ``save_every`` steps written; then two more
    steps of the trained state (with the launcher's family inputs), the
    second profiled: step wall, device busy ms, idle share; then one under
    an explicitly applied ``fused`` plan (``fused_cfg``), profiled
    (``profiled_step``): as many ``ovsf_gemm``, all tensor-core. Returns
    (result, trained params)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.launch import train as launch_train
    from repro_torch.train import optim, steps
    cfg = get_config(arch)
    argv = ["--arch", arch, "--steps", str(n_steps), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--save-every",
            str(save_every), "--lr", str(lr), "--seed", str(seed),
            "--ckpt", ck]
    print(f"{tag} python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_wrapper_counts()
    t0 = time.perf_counter()
    state, rep = launch_train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wrapper_counts()
    by_kernel = dict(G.ovsf_gemm.launches_by_kernel)
    layouts = dict(G.ovsf_decompress.launches_by_layout)
    peak = torch.cuda.max_memory_allocated(dev)
    per_step = train_gemms_per_step(cfg, state["params"])
    saved = sorted(os.listdir(ck))
    print(f"{tag} {rep.steps_run} steps in {wall:.1f}s, step walls "
          f"{[round(v, 3) for v in rep.step_times]} s, losses "
          f"{[round(v, 4) for v in rep.losses]}", flush=True)
    stream = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    extra = launch_train.family_inputs(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
    refit = {}
    if refit_first:
        ev = steps.make_eval_step(cfg)
        for name, s in (("first", 0), ("held_out", FAMILY_HELD_OUT)):
            refit[name] = float(ev(state["params"], {
                **stream.batch_at(s), **extra})["total_loss"])
        print(f"{tag} the first batch's loss {rep.losses[0]:.4f} at step 0,"
              f" {refit['first']:.4f} under the trained params; a held-out"
              f" batch (step {FAMILY_HELD_OUT}) {refit['held_out']:.4f}",
              flush=True)
    falls = (refit["first"] < rep.losses[0] if refit_first
             else rep.losses[-1] < rep.losses[0])
    if (rep.steps_run != n_steps or rep.failures
            or not all(math.isfinite(v) for v in rep.losses) or not falls
            or saved != [f"step_{s:08d}" for s in
                         range(save_every, n_steps + 1, save_every)]):
        raise RuntimeError(f"{tag} steps {rep.steps_run} failures "
                           f"{rep.failures} losses {rep.losses} "
                           f"checkpoints {saved}")
    check_ovsf_launches(tag, cfg, launches, layouts, by_kernel, per_step,
                        rep.steps_run)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in optim.tree_leaves(state))
    # two more steps of the trained state, as the train step runs them,
    # the gradients and the update timed apart, the first unrecorded
    ocfg = optim.OptConfig(lr=lr, warmup_steps=5, total_steps=n_steps + 3)
    params, opt = state["params"], state["opt"]
    del state
    reset_wrapper_counts()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=warm_schedule()) as prof:
        for s in range(2):
            toks = torch.from_numpy(stream.batch_at(n_steps + s)
                                    ["tokens"]).to(dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _l, _a, grads = steps.loss_and_grads(cfg, params,
                                                 {"tokens": toks, **extra})
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            params, opt, _m = optim.adamw_update(ocfg, grads, opt, params)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            del grads
            prof.step()
    check_ovsf_launches(tag, cfg, wrapper_counts(),
                        G.ovsf_decompress.launches_by_layout,
                        G.ovsf_gemm.launches_by_kernel, per_step, 2)
    events = device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    step_ms = (t3 - t1) * 1e3
    counts = kernel_counts(events)
    mat = dict(step_ms=step_ms, grad_ms=(t2 - t1) * 1e3,
               update_ms=(t3 - t2) * 1e3, busy_ms=busy or None,
               idle_share=1.0 - busy / step_ms if busy > 0 else None,
               kernels=sum(counts.values()),
               own_kernels={k: v for k, v in own_counts(counts).items()
                            if v},
               top=sorted(((e.self_device_time_total / 1e3, e.count,
                            e.key[:60]) for e in events), reverse=True)[:6])
    # one more under an explicit fused plan: the OvsfGemmFn rows' path
    fused = fused_cfg(cfg, (TRAIN_BATCH, TRAIN_SEQ))
    rows = []
    state, _m = profiled_step(steps.make_train_step(fused, ocfg), rows)(
        {"params": params, "opt": opt},
        {**stream.batch_at(n_steps + 2), **extra})
    params = state["params"]
    del state, opt
    fr = rows[0]
    check_ovsf_launches(f"{tag} fused", fused, fr["launches"],
                        fr["layouts"], fr["by_kernel"], per_step, 1)
    res = dict(wall_s=wall, losses=rep.losses, refit=refit,
               step_s=rep.step_times, launches=launches,
               ovsf_per_step=per_step, layouts=layouts,
               peak_allocated_gib=peak / 2**30,
               state_gib=state_bytes / 2**30,
               save_snapshot_s=rep.save_snapshot_s,
               save_write_s=rep.save_write_s, fused=fr,
               fused_launches=fr["launches"]["ovsf_gemm"], **mat)
    print(f"{tag} {cfg.name} bf16, {cfg.n_layers} layers, B {TRAIN_BATCH} "
          f"S {TRAIN_SEQ}, {cfg.ovsf.exec_path}: {rep.steps_run} steps in "
          f"{wall:.1f}s, loss {rep.losses[0]:.4f} -> {rep.losses[-1]:.4f}; "
          f"segmented ovsf_decompress {per_step} a step, no ovsf_gemm "
          f"({launches}); step wall median "
          f"{statistics.median(rep.step_times) * 1e3:.1f} ms (the "
          f"supervisor's clock); peak memory_allocated {peak / 2**30:.2f} "
          f"GiB; state {state_bytes / 2**30:.2f} GiB; saves: host copy "
          f"{[round(v, 2) for v in rep.save_snapshot_s]} s + write "
          f"{[round(v, 2) for v in rep.save_write_s]} s ({card})",
          flush=True)
    print(f"{tag} a profiled step of the trained state ({per_step} "
          f"segmented ovsf_decompress): wall {mat['step_ms']:.1f} ms (loss "
          f"and gradients {mat['grad_ms']:.1f}, AdamW "
          f"{mat['update_ms']:.1f}), device busy {mat['busy_ms']} ms, idle "
          f"share {mat['idle_share']}, {mat['kernels']} kernels (the "
          f"profiler's of ours: {mat['own_kernels']}); top "
          f"{[(round(a, 2), b, c) for a, b, c in mat['top']]}; a step under"
          f" a fused plan ({fr['launches']['ovsf_gemm']} ovsf_gemm, all "
          f"tensor-core): wall {fr['wall_ms']:.1f} ms, device busy "
          f"{fr['busy_ms']:.1f} ms, idle share {fr['idle_share']:.3f}, "
          f"{fr['kernels']} kernels ({card})", flush=True)
    return res, params


def train_launcher(seed: int, card: str, dev, tmp: str) -> tuple:
    """Phase 13 (2): ``launcher_run`` of TinyLlama-1.1B at full width and
    depth, ``TRAIN_STEPS`` steps, checkpoints every ``TRAIN_SAVE_EVERY``,
    under the config's ``materialize``: 2 x 110 segmented
    ``ovsf_decompress`` launches a step (the forward's 5 projections x 22
    layers, again in the backward's recompute; the segmented backward
    launches no kernel), then as many ``ovsf_gemm`` a step under an
    explicit ``fused`` plan. Returns (result, trained params)."""
    return launcher_run(seed, card, dev, os.path.join(tmp, "launcher"),
                        TRAIN_ARCH, TRAIN_STEPS, TRAIN_SAVE_EVERY,
                        "[train launcher]")


def train_serve(params, seed: int, dev) -> dict:
    """Phase 13 (5): the trained params through ``LLMEngine`` paged packed,
    chunk 64, with phase 4's 8 requests, eager and replayed: equal streams,
    every step's logits finite."""
    from repro_torch.configs import get_config
    cfg = get_config(TRAIN_ARCH)
    specs = serve_specs(cfg, seed)
    runs = {}
    for mode in ("eager", "graph"):
        eng, runs[mode] = serve_run(params, cfg, dev, "paged packed",
                                    serve_requests(specs),
                                    f"[train serve {mode}]", mode == "graph",
                                    False)
        eng.core.close()
        del eng
    finite = all(torch.isfinite(lg).all() for r in runs.values()
                 for _cf, lg in r["steps"])
    same = runs["eager"]["tokens"] == runs["graph"]["tokens"]
    print(f"[train serve] the trained params, paged packed: 8/8 finished "
          f"eager and replayed, streams equal {same}, logits finite "
          f"{finite}", flush=True)
    if not (same and finite):
        raise RuntimeError("[train serve] streams differ or logits are not "
                           "finite")
    return dict(tokens=runs["graph"]["tokens"])


def train_phase(seed: int, card: str, dev) -> dict:
    """Phase 13 (module docstring): training on the card."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    secs = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t0
        return out
    rng = np.random.default_rng(seed + 31)
    res = dict(kernels=timed("kernels", run_train_kernel_checks, rng, dev))
    res["cnn"] = timed("cnn", cnn_train_phase, seed, card, dev)
    res["parity"] = timed("parity", train_parity, seed, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        res["supervisor"] = timed("supervisor", train_supervised, seed, dev,
                                  tmp)
        res["launcher"], params = timed("launcher", train_launcher, seed,
                                        card, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["serve"] = timed("serve", train_serve, params, seed, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    res["seconds"] = secs
    print(f"[train] phase passed in {res['wall_s']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return res


# -- phase 14: convert --------------------------------------------------------

CONVERT_ARCH = "tinyllama_1_1b"
# (d_in, d_out) of the projections the converter makes OVSF at full width
# (k and v, 256 wide, stay dense); down pads d_in 5632 to L 8192
CONVERT_LAYER = {"q": (2048, 2048), "o": (2048, 2048), "gate": (2048, 5632),
                 "up": (2048, 5632), "down": (5632, 2048)}
# the depth each alpha storage is served at (int8 at all 22 layers until
# phase 17 came, whose int8 model is served at 22)
CONVERT_LAYERS = {"int8": SERVE_CUT_LAYERS, "int4": SERVE_CUT_LAYERS}
CONVERT_PARITY_LAYERS = 2           # card vs CPU: conversion and logits
CONVERT_FLIP_GAP = 1e-5             # a kept-code flip needs a near-tie
CONVERT_ENGINE_KW = dict(chunk_size=64, paged=True, packed=True,
                         use_mapper=False)


def convert_cfg(alpha_dtype: str, dtype: str = "bfloat16",
                n_layers: int = 0):
    """TinyLlama-1.1B with the converter's OVSF settings: monolithic codes
    (``seg_len`` 0), rho 0.5, iterative selection, alphas stored as
    ``alpha_dtype``, served unplanned under ``materialize``."""
    from repro_torch.configs import get_config
    cfg = get_config(CONVERT_ARCH)
    return cfg.replace(dtype=dtype, n_layers=n_layers or cfg.n_layers,
                       ovsf=dataclasses.replace(
                           cfg.ovsf, enable=True, seg_len=0, rho=0.5,
                           strategy="iterative", exec_path="materialize",
                           alpha_dtype=alpha_dtype))


def convert_model(dense: dict, cfg, n_layers: int = 0) -> tuple:
    """The converter over a dense model's tree (the reference has no
    whole-model converter; this walk is the caller's): every linear of the
    first ``n_layers`` blocks (0: all) that ``cfg`` makes OVSF through
    ``layers.linear_convert_to_ovsf`` (fp32 in, the config's rho, strategy,
    segment length and alpha storage), every other float leaf cast to the
    model dtype (the fp32 ``alpha_scale`` kept). Returns (params, seconds
    by weight type, each conversion's time summed)."""
    from repro_torch.models.layers import linear_convert_to_ovsf, ovsf_eligible
    oc, dt = cfg.ovsf, cfg.act_dtype

    def cast(tree):
        if isinstance(tree, dict):
            return {k: v if k == "alpha_scale" else cast(v)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(dt) if tree.is_floating_point() else tree

    secs = {}
    blocks = []
    for blk in dense["blocks"][:n_layers or len(dense["blocks"])]:
        nb = {}
        for grp, sub in blk.items():
            if grp not in ("attn", "mlp"):
                nb[grp] = cast(sub)
                continue
            nb[grp] = {}
            for k, p in sub.items():
                name = f"{grp}_{k}"
                if "w" not in p or not ovsf_eligible(cfg, name, *p["w"].shape):
                    nb[grp][k] = cast(p)
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nb[grp][k] = cast(linear_convert_to_ovsf(
                    p, oc.rho_for(name), oc.strategy, seg=oc.seg_len,
                    alpha_dtype=oc.alpha_dtype))
                torch.cuda.synchronize()
                secs[k] = secs.get(k, 0.0) + time.perf_counter() - t0
        blocks.append(nb)
    out = {k: cast(v) for k, v in dense.items() if k != "blocks"}
    out["blocks"] = blocks
    return out, secs


def reconstruction_errors(dense: dict, params: dict, cfg) -> dict:
    """Per weight type, the relative Frobenius error of the converted W
    (``core.ovsf.decompress_matrix``, plain tensor code) against the dense
    fp32 W: the largest over the converted layers."""
    from repro_torch.core import ovsf
    out = {}
    for blk, dblk in zip(params["blocks"], dense["blocks"]):
        for grp in ("attn", "mlp"):
            for k, p in blk[grp].items():
                if "idx" not in p:
                    continue
                w = dblk[grp][k]["w"]
                spec = ovsf.OVSFSpec(*w.shape, rho=cfg.ovsf.rho, seg=0)
                rec = ovsf.decompress_matrix(p, spec)
                rel = float((rec - w).norm() / w.norm())
                out[k] = max(out.get(k, 0.0), rel)
    return out


def run_convert_kernel_checks(rng, dev) -> dict:
    """Phase 3, for phase 14's model: ``ovsf_decompress``'s int8 / int4
    epilogue (``decompress_row``) at the converted shapes (q and o, gate
    and up, down), the ragged 1000 -> 40 and repeated code ids (200 -> 24).
    Returns the rows and, per storage, one converted layer's five calls
    summed."""
    shapes = sorted(set(CONVERT_LAYER.values()))
    rows = [decompress_row(rng, dev, d_in, N, torch.float32, repeat, adt,
                           "[convert kernel]")
            for d_in, N, repeat in [(d, n, False) for d, n in shapes]
            + [(1000, 40, False), (200, 24, True)]
            for adt in ("int8", "int4")]
    summary = {}
    for adt in ("int8", "int4"):
        mine = [r for r in rows if r["alpha_dtype"] == adt]
        pick = {(r["d_in"], r["N"]): r for r in mine
                if not r["repeated_ids"]}
        layer = [pick[kn] for kn in CONVERT_LAYER.values()]
        sm = {k: sum(r[k] for r in layer) for k in
              ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
        sm["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                         for r in layer) else "operations")
        sm["max_abs_err"] = max(r["max_abs_err"] for r in mine)
        summary[adt] = sm
        print(f"[convert kernel] ovsf_decompress {adt} layer (q, o, gate, "
              f"up, down): {sm['ms']:.4f}ms, bound {sm['bound_ms']:.4f}ms "
              f"({sm['bound_by']}), plain {sm['plain_ms']:.4f}ms, matmul "
              f"S^T alphas {sm['library_ms']:.4f}ms", flush=True)
    return dict(rows=rows, summary=summary)


def convert_cpu_parity(dense: dict, seed: int, dev) -> dict:
    """Phase 14 (2): the first ``CONVERT_PARITY_LAYERS`` blocks converted on
    the card and on the CPU from the same fp32 weights, fp32 and int8
    alphas: the kept code ids first (a flip passes only where the CPU's
    n_keep-th and (n_keep+1)-th code scores lie within
    ``CONVERT_FLIP_GAP`` relative: the score sums reduce in another order
    on the card), then the stored alphas of every leaf with equal ids:
    fp32 within 1e-6 relative, int8 within one quantum with equal scales.
    Then the card's converted params (int8 and int4, fp32 model) and their
    CPU copy run one packed paged step: logits within 1e-3 relative L2."""
    from repro_torch.core import ovsf
    from repro_torch.models import registry as R
    n = CONVERT_PARITY_LAYERS
    cpu_dense = R.params_to(dict(dense, blocks=dense["blocks"][:n]), "cpu")
    res = {}
    for adt in ("", "int8"):
        cfg = convert_cfg(adt, "float32", n)
        card, _ = convert_model(dense, cfg, n)
        host, _ = convert_model(cpu_dense, cfg, n)
        flips = worst = 0.0
        leaves = 0
        for blk, cblk, dblk in zip(card["blocks"], host["blocks"],
                                   cpu_dense["blocks"]):
            for grp in ("attn", "mlp"):
                for k, p in blk[grp].items():
                    if "idx" not in p:
                        continue
                    leaves += 1
                    hp = cblk[grp][k]
                    if not torch.equal(p["idx"].cpu(), hp["idx"]):
                        w = dblk[grp][k]["w"]
                        al = ovsf.regress_alphas(w.t())
                        score = torch.sort((al * al).sum(0),
                                           descending=True).values
                        kk = p["idx"].numel()
                        gap = float((score[kk - 1] - score[kk])
                                    / score[kk - 1])
                        moved = len(set(p["idx"].tolist())
                                    ^ set(hp["idx"].tolist())) // 2
                        print(f"[convert parity] {adt or 'fp32'} {grp}_{k}:"
                              f" {moved} kept codes flipped, cut gap "
                              f"{gap:.2e}", flush=True)
                        if gap > CONVERT_FLIP_GAP:
                            raise RuntimeError(
                                f"[convert parity] {grp}_{k}: code flip at "
                                f"a cut gap {gap:.2e} > {CONVERT_FLIP_GAP}")
                        flips += moved
                        continue
                    al, scale, _a = ovsf.alpha_params(p)
                    hal, hscale, _b = ovsf.alpha_params(hp)
                    if adt:
                        d = float((al.cpu().int() - hal.int()).abs().max())
                        if d > 1 or not torch.equal(scale.cpu(), hscale):
                            raise RuntimeError(
                                f"[convert parity] {grp}_{k}: int8 alphas "
                                f"{d} quanta apart or scales differ")
                    else:
                        d = float((al.cpu() - hal).abs().max()
                                  / hal.abs().max())
                        if d > 1e-6:
                            raise RuntimeError(
                                f"[convert parity] {grp}_{k}: fp32 alphas "
                                f"{d:.2e} relative apart")
                    worst = max(worst, d)
        print(f"[convert parity] {n} full-width layers converted on the "
              f"card and the CPU, alphas {adt or 'fp32'}: {leaves} leaves, "
              f"{flips:g} kept codes flipped; alphas of equal ids "
              + (f"at most {worst:g} quanta apart" if adt else
                 f"{worst:.2e} relative apart"), flush=True)
        res[adt or "fp32"] = dict(leaves=leaves, flips=flips, worst=worst)
        del card, host
    for adt in ("int8", "int4"):
        cfg = convert_cfg(adt, "float32", n)
        params, _ = convert_model(dense, cfg, n)
        gpu = paged_step_logits(params, cfg, dev, seed)
        cpu = paged_step_logits(R.params_to(params, "cpu"), cfg,
                                torch.device("cpu"), seed)
        if not torch.isfinite(gpu).all():
            raise RuntimeError(f"[convert parity] {adt} logits not finite")
        rel = float((gpu - cpu).norm() / cpu.norm())
        print(f"[convert parity] converted {adt}, {n} layers, fp32 packed "
              f"paged step (61 tokens): card vs CPU logits rel L2 "
              f"{rel:.3e} (limit 1e-3)", flush=True)
        if not rel <= 1e-3:
            raise RuntimeError(f"[convert parity] {adt}: {rel:.3e} > 1e-3")
        res[f"logits_{adt}"] = rel
        del params
    del cpu_dense
    return res


def convert_serve(params, cfg, seed: int, card: str, dev) -> dict:
    """Phase 14 (3): the converted model through ``family_serve`` with the
    main path's engine unplanned (``CONVERT_ENGINE_KW``): every step
    launches 5 ``ovsf_decompress`` a layer (the epilogue of the stored
    storage) and one ``paged_flash_decode`` a layer, nothing else of ours;
    the engine holds no plan, so every OVSF layer runs ``materialize``."""
    adt = cfg.ovsf.alpha_dtype
    tag = f"[convert {adt} paged packed]"
    n_ovsf = ovsf_per_layer(params)
    if n_ovsf != len(CONVERT_LAYER):
        raise RuntimeError(f"{tag} {n_ovsf} OVSF linears a block, expected "
                           f"{len(CONVERT_LAYER)}")

    def unplanned(eng, _key):
        if eng.cfg.exec_plan is not None or eng.cfg.ovsf.exec_path != \
                "materialize":
            raise RuntimeError(f"{tag} the engine planned {eng.cfg.exec_plan}"
                               f" / {eng.cfg.ovsf.exec_path}")
        return {}
    return family_serve(params, cfg, seed, card, dev, tag,
                        {"ovsf_decompress": n_ovsf * cfg.n_layers,
                         "paged_flash_decode": cfg.n_layers}, unplanned,
                        engine_kw=CONVERT_ENGINE_KW)


def convert_phase(seed: int, card: str, dev, kernels: dict) -> dict:
    """Phase 14 (module docstring): dense TinyLlama-1.1B converted to
    monolithic int8 / int4 alphas and served under ``materialize``;
    ``kernels``: phase 3's rows of the epilogue at its shapes
    (``run_convert_kernel_checks``), kept with the phase's results."""
    from repro_torch.core.ovsf import alpha_params
    from repro_torch.models import registry as R
    t_phase = time.perf_counter()
    res = dict(kernels=kernels)
    cfg = convert_cfg("int8")
    dense_cfg = cfg.replace(dtype="float32", ovsf=dataclasses.replace(
        cfg.ovsf, enable=False))
    dense = R.model_init(dense_cfg, seed, dev)
    torch.cuda.synchronize()
    dense_gb = R.param_count(dense) * 4 / 1e9
    models, res["conversion"] = {}, {}
    depths = {adt: min(d or len(dense["blocks"]), len(dense["blocks"]))
              for adt, d in CONVERT_LAYERS.items()}
    for adt, depth in depths.items():
        c = convert_cfg(adt, "bfloat16", depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        models[adt], secs = convert_model(dense, c, depth)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stored = {alpha_params(p)[2] for blk in models[adt]["blocks"]
                  for g in ("attn", "mlp") for p in blk[g].values()
                  if "idx" in p}
        if stored != {adt}:
            raise RuntimeError(f"[convert] {adt}: the model stores {stored}")
        errs = reconstruction_errors(dense, models[adt], c)
        res["conversion"][adt] = dict(layers=c.n_layers, wall_s=wall,
                                      seconds_by_type=secs, rel_err=errs)
        print(f"[convert] {CONVERT_ARCH} dense fp32 ({dense_gb:.2f} GB, "
              f"seed {seed}) -> monolithic {adt} alphas, rho 0.5, iterative,"
              f" {c.n_layers} layers x {len(CONVERT_LAYER)} projections: "
              f"{wall:.2f}s on the card (by type "
              + ", ".join(f"{k} {v:.2f}s" for k, v in secs.items())
              + "); relative Frobenius error of W, the worst layer: "
              + ", ".join(f"{k} {v:.4f}" for k, v in errs.items())
              + f" ({card})", flush=True)
    res["parity"] = convert_cpu_parity(dense, seed, dev)
    before = torch.cuda.memory_reserved(dev) / 2**20
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[convert] dense model freed: memory_reserved {before:.0f} -> "
          f"{torch.cuda.memory_reserved(dev) / 2**20:.0f} MiB", flush=True)
    for adt, depth in depths.items():
        res[adt] = convert_serve(models.pop(adt),
                                 convert_cfg(adt, "bfloat16", depth), seed,
                                 card, dev)
        gc.collect()
        torch.cuda.empty_cache()
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"[convert] phase passed in {res['wall_s']:.1f}s", flush=True)
    return res


# -- phase 15: family training ------------------------------------------------

FAMILY_LAUNCH_ARCH = "zamba2_1_2b"  # launch.train at full width and depth
FAMILY_LAUNCH_STEPS = 4             # its steps; one checkpoint, at the end
# phase 15's learning rate: the launcher's default. The loss is gated on
# the first batch, refitted: at initialisation Zamba2-1.2B's batches'
# losses spread by 0.1, more than 8-12 steps move a held-out one at any
# rate from 1e-4 to 3e-3 (PERF.md, section 6: family training)
FAMILY_LR = 3e-4
FAMILY_HELD_OUT = 1000              # the held-out batch's step
# the other families' train steps on the card: full width, depth cut for
# the script's time (0: uncut), ``FAMILY_CUT_STEPS`` steps each
FAMILY_LAYERS = {"olmoe_1b_7b": 4, "falcon_mamba_7b": 4,
                 "llava_next_34b": 2, "whisper_tiny": 0}
FAMILY_CUT_STEPS = 4
FAMILY_REPLAY_ARCH = "olmoe_1b_7b"  # the supervisor's replay at full width
FAMILY_REPLAY_LAYERS = 1            # 2 took 55.8 s, its 6 GB saves the most
# card vs CPU: one fp32 step, B 2, S 64, full width at these depths (the
# hybrid at one full group of 6, so that its shared block runs). LLaVA's
# step left the list when phase 17 came, for the script's time: its CPU
# side took 32-34 s at 1 layer (the 64000 x 7168 embedding and head, not
# the depth); its trunk is the dense one phase 13 holds, its image prefix
# is held card vs CPU by phase 12
FAMILY_PARITY_LAYERS = {"olmoe_1b_7b": 2, "falcon_mamba_7b": 2,
                        "zamba2_1_2b": 6, "whisper_tiny": 0}
FAMILY_PARITY_BATCH, FAMILY_PARITY_SEQ = 2, 64
FAMILY_FLIP_GAP = 1e-5              # a routing flip needs a near-tie
# each family's OVSF projections in a train step: (name, d_in, d_out, the
# count of that shape in a layer); the hybrid's are one Mamba-2 block's and
# the shared block's. Whisper-tiny has none: every matrix has a side of
# 384, below ``min_dim`` 512
FAMILY_TRAIN_GEMMS = {
    "olmoe_1b_7b": (("q k v o", 2048, 2048, 4),),
    "falcon_mamba_7b": (("in_proj", 4096, 16384, 1),
                        ("out_proj", 8192, 4096, 1)),
    "zamba2_1_2b": (("in_proj", 2048, 8384, 1), ("out_proj", 4096, 2048, 1),
                    ("shared q k v o", 2048, 2048, 4),
                    ("shared gate up", 2048, 8192, 2),
                    ("shared down", 8192, 2048, 1)),
    "llava_next_34b": (("q o", 7168, 7168, 2), ("k v", 7168, 1024, 2),
                       ("gate up", 7168, 20480, 2), ("down", 20480, 7168, 1)),
}


def run_family_train_kernel_checks(rng, dev) -> dict:
    """Phase 15 (1): ``ovsf_gemm`` forward + backward (``OvsfGemmFn``) at
    each family's training projections, M = B S = 1024, bf16
    (``train_gemm_row``, as phase 13's TinyLlama rows), each distinct
    (d_in, d_out) once. A family's summary sums its projections, each
    shape times its count in a layer."""
    M = TRAIN_BATCH * TRAIN_SEQ
    rows: dict = {}
    for fam, projs in FAMILY_TRAIN_GEMMS.items():
        for name, K, N, _n in projs:
            if (K, N) not in rows:
                rows[(K, N)] = train_gemm_row(
                    rng, dev, M, K, N, f"[family train kernel] ovsf_gemm "
                    f"{fam} {name} M={M} {K}->{N} bf16")
    summary = {}
    for fam, projs in FAMILY_TRAIN_GEMMS.items():
        mine = [(n, rows[(K, N)]) for _nm, K, N, n in projs]
        tot = {k: sum(n * r[k] for n, r in mine) for k in
               ("ms", "forward_ms", "forward_bound_ms", "plain_ms",
                "library_ms", "bound_ms")}
        tot["max_abs_err"] = max(r["max_abs_err"] for _n, r in mine)
        tot["bound_by"] = max(mine, key=lambda nr: nr[1]["bound_ms"])[1][
            "bound_by"]
        summary[fam] = tot
        print(f"[family train kernel] {fam}: a layer's projections, forward"
              f" + backward {tot['ms']:.4f} ms (the kernel's forward "
              f"{tot['forward_ms']:.4f}, bound {tot['forward_bound_ms']:.4f})"
              f", plain {tot['plain_ms']:.4f}, matmul on dense W "
              f"{tot['library_ms']:.4f}, bound {tot['bound_ms']:.4f} ms "
              f"({tot['bound_by']}; {tot['ms'] / tot['bound_ms']:.1f}x)",
              flush=True)
    return dict(rows=list(rows.values()), summary=summary)


def routing_flips(card: list, cpu: list, k: int) -> tuple:
    """Card vs CPU routing of one train step's MoE blocks (``card``,
    ``cpu``: one ``routing_recorder`` record a block, in order): the first
    block whose ordered top-k or kept mask differs, and each token there
    whose ordered choices differ, with the smallest gap between adjacent
    sorted probabilities from the first differing rank to rank k + 1 on
    each side (a swap needs a near-tie among them). Later blocks read what
    the difference changed and are not compared. Returns (flips, the
    block or None); a block that differs only in its kept masks raises."""
    for layer, (a, b) in enumerate(zip(card, cpu)):
        if torch.equal(a["gate_idx"], b["gate_idx"]):
            if not torch.equal(a["keep"], b["keep"]):
                raise RuntimeError(f"[family parity] block {layer}: the "
                                   "kept masks differ with equal routing")
            continue
        flips = []
        diff = (a["gate_idx"] != b["gate_idx"]).any(-1)
        for grp, t in diff.nonzero().tolist():
            first = int((a["gate_idx"][grp, t] != b["gate_idx"][grp, t])
                        .nonzero()[0])
            gap = []
            for p in (a["probs"], b["probs"]):
                v = p[grp, t].sort(descending=True).values
                gap.append(float((v[first:k] - v[first + 1:k + 1]).min()))
            flips.append(dict(layer=layer, group=grp, token=t, rank=first,
                              gap_card=gap[0], gap_cpu=gap[1]))
        return flips, layer
    return [], None


def family_parity(seed: int, dev) -> dict:
    """Phase 15 (2): one fp32 train step of each family at full width and
    ``FAMILY_PARITY_LAYERS`` layers (remat off; B 2, S 64; random frames
    and image embeddings from the seed), on the card (an explicit
    ``fused`` plan, ``fused_cfg``: the CUDA-core ``ovsf_gemm``; expert
    banks regenerated) and on the CPU
    from the same state, under ``spectral`` there (the exact
    activation-transform identity as plain tensor code: at these widths
    ``materialize``'s dense W and its gradient took 23-45 s a family on
    the CPU): the loss within 1e-5 relative,
    every gradient leaf and updated param within 1e-3 relative L2. The
    MoE's routing is compared first (``routing_flips``): a flip whose gap
    exceeds ``FAMILY_FLIP_GAP`` on either side fails; a permitted flip is
    printed, the step's gradient gate waived and its loss held to 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import moe
    from repro_torch.train import optim, steps
    cpu_dev = torch.device("cpu")
    B, S = FAMILY_PARITY_BATCH, FAMILY_PARITY_SEQ
    res = {}
    for arch, n in FAMILY_PARITY_LAYERS.items():
        cfg = get_config(arch).replace(dtype="float32", remat=False)
        if n:
            cfg = cfg.replace(n_layers=n)
        card = steps.train_state_init(cfg, seed, dev)
        cpu = optim.tree_map(lambda _p, t: t.to(cpu_dev), card)
        rng = np.random.default_rng(seed + 15)
        batch = {"tokens": TokenStream(cfg.vocab, S, B, seed=seed)
                 .batch_at(0)["tokens"]}
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model), np.float32)
        if cfg.family == "vlm":
            batch["image_embeds"] = 0.1 * rng.standard_normal(
                (B, min(cfg.vlm_image_tokens, S // 2), cfg.d_model),
                np.float32)
        ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
        out, secs = {}, {}
        spectral = cfg.replace(ovsf=dataclasses.replace(
            cfg.ovsf, exec_path="spectral"))
        for name, st, d in (("card", card, dev), ("cpu", cpu, cpu_dev)):
            records, recording = routing_recorder()
            route, moe.route = moe.route, recording
            try:
                c = fused_cfg(spectral, (B, S)) if name == "card" \
                    else spectral
                b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
                t0 = time.perf_counter()
                loss, m, g = steps.loss_and_grads(c, st["params"], b)
                new_p, _o, _m = optim.adamw_update(ocfg, g, st["opt"],
                                                   st["params"])
                loss = float(loss)
                secs[name] = time.perf_counter() - t0
            finally:
                moe.route = route
            out[name] = (loss, float(m["aux"]), optim.tree_leaves(g),
                         optim.tree_leaves(new_p), records)
            del st, g, new_p, b
        del card, cpu
        (lc, ac, gc_, pc, rc), (lh, ah, gh, ph, rh) = out["card"], out["cpu"]
        flips, block = routing_flips(rc, rh, cfg.top_k) if rc else ([], None)
        loss_err = abs(lc - lh) / abs(lh)
        aux_err = abs(ac - ah) / abs(ah) if ah else abs(ac)
        g_err = max(rel_l2(a, b) for a, b in zip(gc_, gh) if a is not None)
        p_err = max(rel_l2(a.float(), b.float()) for a, b in zip(pc, ph)
                    if a.is_floating_point())
        big = [f for f in flips if max(f["gap_card"], f["gap_cpu"])
               > FAMILY_FLIP_GAP]
        loss_limit = 1e-4 if flips else 1e-5
        print(f"[family parity] {arch} fp32, {cfg.n_layers} layers, B {B} S "
              f"{S}: loss {lc:.6f} vs CPU {lh:.6f} ({loss_err:.2e}, limit "
              f"{loss_limit:.0e}), aux {ac:.6f} vs {ah:.6f} ({aux_err:.2e}),"
              f" gradients {g_err:.2e}, updated params {p_err:.2e} (limit "
              f"1e-3{', waived: a near-tie flip' if flips else ''}); "
              f"routing flips {flips} (first differing block {block}); card"
              f" {secs['card']:.1f}s, CPU {secs['cpu']:.1f}s", flush=True)
        if big or not (loss_err <= loss_limit and (
                flips or (g_err <= 1e-3 and p_err <= 1e-3))):
            raise RuntimeError(f"[family parity] {arch}: loss {loss_err}, "
                               f"gradients {g_err}, params {p_err}, flips "
                               f"{flips} (gap limit {FAMILY_FLIP_GAP})")
        res[arch] = dict(layers=cfg.n_layers, loss_err=loss_err,
                         aux_err=aux_err, grad_err=g_err, param_err=p_err,
                         flips=flips, card_s=secs["card"], cpu_s=secs["cpu"])
        gc.collect()
        torch.cuda.empty_cache()
    return res


def family_train_cut(seed: int, card: str, dev) -> dict:
    """Phase 15 (5): OLMoE-1B-7B, Falcon-Mamba-7B, LLaVA-NeXT-34B (full
    width, ``FAMILY_LAYERS`` deep) and Whisper-tiny (uncut) through
    ``steps.make_train_step``, bf16, B 8, S 128, remat, under the config's
    ``materialize``, ``FAMILY_CUT_STEPS`` steps at ``FAMILY_LR`` with the
    launcher's family inputs: finite losses, the loss of the first batch
    after the steps (``make_eval_step``) below its loss at the first step
    (see ``FAMILY_LR``; a held-out batch's printed),
    ``train_gemms_per_step`` segmented ``ovsf_decompress`` launches a step
    and nothing else of ours (Whisper none); then one more step under an
    explicit ``fused`` plan (``fused_cfg``): as many ``ovsf_gemm``, all
    tensor-core. Step wall and peak ``memory_allocated`` printed."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.launch.train import family_inputs
    from repro_torch.train import optim, steps
    res = {}
    for arch, n in FAMILY_LAYERS.items():
        cfg = get_config(arch)
        if n:
            cfg = cfg.replace(n_layers=n)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        state = steps.train_state_init(cfg, seed, dev)
        per_step = train_gemms_per_step(cfg, state["params"])
        banks = train_banks_per_step(cfg, state["params"])
        state_gib = sum(t.numel() * t.element_size() for t in
                        optim.tree_leaves(state)) / 2**30
        # the cosine's end well past the run: the rate stays near its peak
        fn = steps.make_train_step(cfg, optim.OptConfig(
            lr=FAMILY_LR, warmup_steps=1, total_steps=4 * FAMILY_CUT_STEPS))
        stream = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
        extra = family_inputs(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)
        losses, walls = [], []
        reset_wrapper_counts()
        for s in range(FAMILY_CUT_STEPS):
            t0 = time.perf_counter()
            state, m = fn(state, {**stream.batch_at(s), **extra})
            losses.append(float(m["total_loss"]))
            walls.append(time.perf_counter() - t0)
        launches = wrapper_counts()
        tag = f"[family train] {arch}"
        check_ovsf_launches(tag, cfg, launches,
                            G.ovsf_decompress.launches_by_layout,
                            G.ovsf_gemm.launches_by_kernel, per_step,
                            FAMILY_CUT_STEPS, banks)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        ev = steps.make_eval_step(cfg)
        after, held = (float(ev(state["params"], {
            **stream.batch_at(s), **extra})["total_loss"])
            for s in (0, FAMILY_HELD_OUT))
        # one step under an explicit fused plan: the OvsfGemmFn rows' path
        fused = fused_cfg(cfg, (TRAIN_BATCH, TRAIN_SEQ))
        reset_wrapper_counts()
        t0 = time.perf_counter()
        state, _m = steps.make_train_step(fused, optim.OptConfig(
            lr=FAMILY_LR, warmup_steps=1, total_steps=4 * FAMILY_CUT_STEPS))(
            state, {**stream.batch_at(FAMILY_CUT_STEPS), **extra})
        torch.cuda.synchronize()
        fused_wall = time.perf_counter() - t0
        fused_launches = wrapper_counts()
        check_ovsf_launches(f"{tag} fused", fused, fused_launches,
                            G.ovsf_decompress.launches_by_layout,
                            G.ovsf_gemm.launches_by_kernel, per_step, 1,
                            banks)
        print(f"{tag} bf16, {cfg.n_layers} layers, B {TRAIN_BATCH} S "
              f"{TRAIN_SEQ}, {cfg.ovsf.exec_path}: loss "
              f"{' '.join(f'{v:.4f}' for v in losses)}; the first batch's "
              f"{losses[0]:.4f} -> {after:.4f}, a held-out batch's "
              f"{held:.4f}; segmented ovsf_decompress {per_step} a step"
              + (f" and {banks} for the expert banks" if banks else "")
              + f" ({launches}); step wall median "
              f"{statistics.median(walls[1:]) * 1e3:.1f} ms (first "
              f"{walls[0] * 1e3:.1f}); a step under a fused plan "
              f"{fused_wall * 1e3:.1f} ms, {per_step} ovsf_gemm, all "
              f"tensor-core"
              + (f", {banks} segmented ovsf_decompress" if banks else "")
              + f"; state {state_gib:.2f} GiB, peak "
              f"memory_allocated {peak:.2f} GiB ({card})", flush=True)
        if (not all(math.isfinite(v) for v in losses + [after])
                or not after < losses[0]):
            raise RuntimeError(f"{tag}: losses {losses}, the first batch's "
                               f"after {after}")
        res[arch] = dict(layers=cfg.n_layers, losses=losses,
                         first_batch_after=after, held_out=held,
                         step_s=walls, launches=launches,
                         ovsf_per_step=per_step, bank_launches=banks,
                         fused_launches=fused_launches["ovsf_gemm"],
                         fused_step_s=fused_wall, state_gib=state_gib,
                         peak_allocated_gib=peak)
        del state, fn
        gc.collect()
        torch.cuda.empty_cache()
    return res


def family_train_phase(seed: int, card: str, dev) -> dict:
    """Phase 15 (module docstring): the MoE, SSM, hybrid, encoder-decoder
    and VLM families' training on the card."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    secs = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return out
    rng = np.random.default_rng(seed + 47)
    res = dict(kernels=timed("kernels", run_family_train_kernel_checks, rng,
                             dev))
    # OLMoE's expert banks on the card: the segmented kernel alone
    with no_plain_banks("[family train]"):
        res["parity"] = timed("parity", family_parity, seed, dev)
        tmp = tempfile.mkdtemp(prefix="chip_smoke_family_train_")
        try:
            res["supervisor"] = timed(
                "supervisor", train_supervised, seed, dev, tmp,
                FAMILY_REPLAY_ARCH, FAMILY_REPLAY_LAYERS,
                "[family supervisor]", True)
            res["launcher"], params = timed(
                "launcher", launcher_run, seed, card, dev,
                os.path.join(tmp, "launcher"), FAMILY_LAUNCH_ARCH,
                FAMILY_LAUNCH_STEPS, FAMILY_LAUNCH_STEPS,
                "[family launcher]", FAMILY_LR, True)
            del params
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        res["cut"] = timed("cut", family_train_cut, seed, card, dev)
    res["wall_s"] = time.perf_counter() - t_phase
    res["seconds"] = secs
    print(f"[family train] phase passed in {res['wall_s']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return res


# -- phase 16: training with quantised alphas; stacked Whisper-tiny ----------

QUANT_ARCH = "tinyllama_1_1b"
QUANT_STEPS = 12                    # the full-width int8 run's steps ...
QUANT_SAVE_EVERY = 10               # ... checkpoints at 10 and 12 (the end)
QUANT_FAIL_AT = 11                  # a fail at 11 restores 10 and replays it
QUANT_INT4_LAYERS = 4               # the int4 run's depth (full width)
QUANT_INT4_STEPS = 3
# card vs CPU: one fp32 step, B 2, S 64, full width: (arch, layers, alpha
# storage); Zamba2 at one full hybrid group of 6, its shared block in it
QUANT_PARITY = (("tinyllama_1_1b", 2, "int8"), ("tinyllama_1_1b", 2, "int4"),
                ("zamba2_1_2b", 6, "int8"))
QUANT_CONVERT_LAYERS = 2            # a converted model trained under
QUANT_CONVERT_STEPS = 2             # materialize: ovsf_decompress's epilogue
# the stacked Whisper-tiny engine: the contiguous packed step, chunk 64, 4
# slots, phase 4's 8 requests (prompts of 8-149 tokens, 16 new each)
WHISPER_STACK_KW = dict(batch_slots=4, buffer_len=256, chunk_size=64,
                        packed=True)
# Whisper-tiny's published OVSF settings compress none of its matrices
# (every one has a side of 384, below ``min_dim`` 512), so two variants
# from ``make_alpha_variant`` would be the same model: the stacked run
# lowers ``min_dim`` to 384, making each attention and MLP projection of
# the encoder and the decoder OVSF (rho 0.5, 16-long segments; the cross
# projections stay dense, outside ``targets``), at the published widths
WHISPER_STACK_MIN_DIM = 384
WHISPER_STACK_NAMES = ("w-a", "w-b")


def quant_gemm_row(rng, dev, M: int, K: int, N: int, adt: str,
                   tag: str) -> dict:
    """``OvsfGemmFn`` over int8 / int4 alphas (16-long segments, a scale a
    segment, as the model stores them) at (M, K -> N): y, dx and d scale
    against autograd through the plain version (dequantise, dense W, fp32
    product), in fp32 (the CUDA-core kernel) and bf16 (the tensor-core
    kernel's ``QUANT`` epilogue), each launch on its kernel and alpha
    storage; bf16 timed as ``train_gemm_row``, the library call matmul
    forward + backward on the dequantised dense W."""
    from repro_torch.core.ovsf import dequantize_alphas, quantize_alphas
    from repro_torch.kernels import ops
    from repro_torch.kernels.ovsf_gemm import ovsf_gemm, ovsf_gemm_plain
    from repro_torch.kernels.ref import ovsf_decompress_ref
    errs = {}
    for dt, kernel in ((torch.float32, "cuda_core"),
                       (torch.bfloat16, "tensor_core")):
        x, al, idx, _nk = gemm_case(rng, 16, M, K, N, dt, dev)
        q, s = quantize_alphas(al.float(), idx.shape[0], adt)
        g = torch.randn((M, N), device=dev, dtype=dt)

        def kern(a, b, q=q, idx=idx):
            return ops.ovsf_gemm_fn(a, q, idx, alpha_scale=b,
                                    alpha_dtype=adt)

        def plain(a, b, q=q, idx=idx):
            return ovsf_gemm_plain(a, q, idx, alpha_scale=b, alpha_dtype=adt)
        n_k = ovsf_gemm.launches_by_kernel[kernel]
        n_a = ovsf_gemm.launches_by_alpha[adt]
        errs[dt] = grad_check(f"{tag} {str(dt).split('.')[-1]}", kern, plain,
                              [x, s], g, dt, ("y", "dx", "d scale"))
        if (ovsf_gemm.launches_by_kernel[kernel] != n_k + 1
                or ovsf_gemm.launches_by_alpha[adt] != n_a + 1):
            raise RuntimeError(f"{tag} {dt}: not one {adt} launch of the "
                               f"{kernel} kernel")
    J = q.shape[0]
    ms = fwd_bwd_ms(kern, [x, s], g)
    plain_ms = fwd_bwd_ms(plain, [x, s], g, 2)
    fwd = forward_ms(kern, [x, s])
    W = ovsf_decompress_ref(dequantize_alphas(q, s, adt), idx, K).to(x.dtype)
    lib_ms = fwd_bwd_ms(torch.matmul, [x, W], g)
    bd = ovsf_train_bound(M, K, N, J, K * 4, torch.bfloat16,
                          idx.numel() * 4, q.numel() + s.numel() * 4)
    t_ops, t_mem = bd["train"]
    row = dict(case=tag, alpha_dtype=adt, M=M, K=K, N=N, J=J,
               max_abs_err=errs[torch.bfloat16],
               max_abs_err_fp32=errs[torch.float32], ms=ms, forward_ms=fwd,
               backward_ms=ms - fwd, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(t_ops, t_mem),
               bound_by="operations" if t_ops >= t_mem else "bytes",
               forward_bound_ms=max(bd["forward"]))
    print(f"{tag}: y, dx, d scale within {TOL[torch.float32]} (fp32, "
          f"CUDA-core kernel; max abs err {errs[torch.float32]:.3e}) and "
          f"{TOL[torch.bfloat16]} (bf16, tensor-core kernel; "
          f"{errs[torch.bfloat16]:.3e}) relative L2 of autograd through the "
          f"plain version; bf16 forward + backward {ms:.4f} ms (the "
          f"kernel's forward {fwd:.4f} ms, bound "
          f"{row['forward_bound_ms']:.4f}; the backward {ms - fwd:.4f}), "
          f"plain {plain_ms:.4f} ms, matmul on the dequantised dense W "
          f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    return row


def quant_decompress_row(rng, dev, d_in: int, N: int, adt: str,
                         tag: str) -> dict:
    """``OvsfDecompressFn`` over int8 / int4 alphas (monolithic codes, J =
    L / 2, one scale, row 4q's shapes): W (the kernel's epilogue) and the
    scale's gradient (dA = S dW through the ``fwht`` kernel, reduced over
    the stored integers) against autograd through the plain version, fp32;
    forward + backward device ms beside the plain version's and matmul
    S^T A forward + backward (S prebuilt, A dequantised); bound: q, ids, W
    written, dW read once, or the transform's 2 N L log2 L adds and the
    2 J N multiplies at the fp32 rate."""
    from repro_torch.core.ovsf import (dequantize_alphas, hadamard_matrix,
                                       quantize_alphas)
    from repro_torch.kernels import ops
    from repro_torch.kernels.fwht import fwht
    from repro_torch.kernels.ovsf_gemm import (ovsf_decompress,
                                               ovsf_decompress_plain)
    al, idx, L = decompress_case(rng, d_in, N, torch.float32, dev)
    q, s = quantize_alphas(al, 1, adt)
    J = L // 2
    G = torch.randn((d_in, N), device=dev)

    def kern(b):
        return ops.ovsf_decompress_fn(q, idx, d_in, alpha_scale=b,
                                      alpha_dtype=adt)

    def plain(b):
        return ovsf_decompress_plain(q, idx, d_in, alpha_scale=b,
                                     alpha_dtype=adt)
    n_d, n_f = ovsf_decompress.launches, fwht.launches
    err = grad_check(tag, kern, plain, [s], G, torch.float32,
                     ("W", "d scale"))
    if (ovsf_decompress.launches, fwht.launches) != (n_d + 1, n_f + 1):
        raise RuntimeError(f"{tag}: not one ovsf_decompress and one fwht "
                           "launch")
    ms = fwd_bwd_ms(kern, [s], G)
    plain_ms = fwd_bwd_ms(plain, [s], G, 2)
    fwd = forward_ms(kern, [s])
    St = hadamard_matrix(L, torch.float32, dev)[idx.long(), :d_in].t() \
        .contiguous()
    A = dequantize_alphas(q, s, adt)
    lib_ms = fwd_bwd_ms(lambda a: St @ a, [A], G)
    bytes_ = q.numel() + idx.numel() * 4 + 8 + 2 * d_in * N * 4
    ops_ = 2 * N * L * math.log2(L) + 2 * J * N
    t_bound, by = bound(bytes_, ops_, torch.float32)
    row = dict(case=tag, alpha_dtype=adt, d_in=d_in, L=L, J=J, N=N,
               max_abs_err=err, ms=ms, forward_ms=fwd, backward_ms=ms - fwd,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=t_bound,
               bound_by=by)
    print(f"{tag}: W and d scale within {TOL[torch.float32]} relative L2 of "
          f"autograd through the plain version (max abs err {err:.3e}); "
          f"forward + backward {ms:.4f} ms (forward {fwd:.4f}), plain "
          f"{plain_ms:.4f} ms, matmul S^T A forward + backward "
          f"{lib_ms:.4f} ms, bound {t_bound:.4f} ms ({by})", flush=True)
    return row


def layer_summary(rows: list, keys: tuple) -> dict:
    """A layer's rows summed (``keys``); the largest error; the bound's
    kind of the largest bound."""
    out = {k: sum(r[k] for r in rows) for k in keys}
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    return out


def run_quant_train_kernel_checks(rng, dev) -> dict:
    """Phase 16 (1): ``OvsfGemmFn`` over int8 and int4 alphas at
    TinyLlama-1.1B's five projections, M = B S = 1024 (``quant_gemm_row``),
    and ``OvsfDecompressFn`` over them at the converted layer's shapes
    (``quant_decompress_row``); a layer's summary per storage."""
    M = TRAIN_BATCH * TRAIN_SEQ
    res = dict(gemm={}, decompress={})
    for adt in ("int8", "int4"):
        rows = [quant_gemm_row(rng, dev, M, K, N, adt,
                               f"[quant train kernel] ovsf_gemm {adt} {name} "
                               f"M={M} {K}->{N}")
                for name, (K, N) in TRAIN_LAYER.items()]
        sm = layer_summary(rows, ("ms", "forward_ms", "forward_bound_ms",
                                  "plain_ms", "library_ms", "bound_ms"))
        res["gemm"][adt] = dict(sm, rows=rows)
        drows = [quant_decompress_row(rng, dev, d_in, N, adt,
                                      f"[quant train kernel] ovsf_decompress"
                                      f" {adt} {name} {d_in}->{N}")
                 for name, (d_in, N) in CONVERT_LAYER.items()]
        dm = layer_summary(drows, ("ms", "forward_ms", "plain_ms",
                                   "library_ms", "bound_ms"))
        res["decompress"][adt] = dict(dm, rows=drows)
        print(f"[quant train kernel] {adt}, a layer (q, o, gate, up, down): "
              f"OvsfGemmFn forward + backward {sm['ms']:.4f} ms (the "
              f"kernel's forward {sm['forward_ms']:.4f}), bound "
              f"{sm['bound_ms']:.4f} ms ({sm['bound_by']}; "
              f"{sm['ms'] / sm['bound_ms']:.1f}x), plain "
              f"{sm['plain_ms']:.4f}, matmul on the dense W "
              f"{sm['library_ms']:.4f}; OvsfDecompressFn (converted shapes) "
              f"{dm['ms']:.4f} ms (forward {dm['forward_ms']:.4f}), bound "
              f"{dm['bound_ms']:.4f} ({dm['bound_by']}), plain "
              f"{dm['plain_ms']:.4f}, matmul S^T A {dm['library_ms']:.4f}",
              flush=True)
        torch.cuda.empty_cache()
    return res


def int_leaves(tree) -> list:
    """The integer leaves of a param tree (quantised alphas, code ids)."""
    from repro_torch.train import optim
    return [t for t in optim.tree_leaves(tree)
            if t is not None and not t.is_floating_point()]


def quant_cfg(arch: str, adt: str, **kw):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, alpha_dtype=adt),
                       **kw)


def profiled_step(fn, rows: list):
    """``fn`` (a train step) with each call profiled on the device alone:
    its wall (synchronised at both ends), device busy ms, idle share,
    kernels, and the wrappers' counts, ``ovsf_gemm``'s launches by alpha
    storage and kernel and ``ovsf_decompress``'s by layout, one row a call
    in ``rows``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ovsf_gemm as G

    def step(state, batch):
        reset_wrapper_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(state, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, kernels = kineto_device(prof)
        rows.append(dict(wall_ms=wall, busy_ms=busy,
                         idle_share=1.0 - busy / wall, kernels=kernels,
                         launches=wrapper_counts(),
                         by_alpha=dict(G.ovsf_gemm.launches_by_alpha),
                         by_kernel=dict(G.ovsf_gemm.launches_by_kernel),
                         layouts=dict(G.ovsf_decompress.launches_by_layout)))
        return out
    return step


def kineto_device(prof) -> tuple:
    """(device busy ms, kernels) of a stopped profile, read straight from
    its kineto records: every device record's duration but the schedule's
    ``ProfilerStep`` range, and the kernels among them (copies and memsets
    left out, as ``kernel_counts``), without ``key_averages``' parse (about
    5 s for a train step's ~21000 kernels; the same sums)."""
    busy = kernels = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith("ProfilerStep"):
            continue
        busy += e.duration_ns()
        kernels += not name.lower().startswith(("memcpy", "memset"))
    return busy / 1e6, kernels


def check_quant_steps(tag: str, cfg, rows: list, per_step: int) -> None:
    """Every profiled step of ``cfg`` launched ``per_step`` of its OVSF
    wrapper (``check_ovsf_launches``) and nothing else of ours; under
    ``fused`` every ``ovsf_gemm`` over the config's alpha storage."""
    adt = cfg.ovsf.alpha_dtype
    for r in rows:
        check_ovsf_launches(tag, cfg, r["launches"], r["layouts"],
                            r["by_kernel"], per_step, 1)
        if r["by_alpha"][adt] != r["launches"]["ovsf_gemm"]:
            raise RuntimeError(f"{tag} ovsf_gemm by alpha storage "
                               f"{r['by_alpha']}, expected all {adt}")


def quant_fused_step(tag: str, cfg, state: dict, batch: dict,
                     per_step: int) -> tuple:
    """One more train step of ``state`` under an explicit ``fused`` plan
    (``fused_cfg``: the ``OvsfGemmFn`` rows' path, the tensor-core
    kernel's ``QUANT`` epilogue), profiled: (its row, the new state)."""
    from repro_torch.train import optim, steps
    fused = fused_cfg(cfg, (TRAIN_BATCH, TRAIN_SEQ))
    rows = []
    state, _m = profiled_step(steps.make_train_step(fused, optim.OptConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=10)), rows)(state, batch)
    check_quant_steps(f"{tag} fused", fused, rows, per_step)
    r = rows[0]
    print(f"{tag} a step under a fused plan: wall {r['wall_ms']:.1f} ms, "
          f"device busy {r['busy_ms']:.1f} ms, idle share "
          f"{r['idle_share']:.3f}, {r['kernels']} kernels, ovsf_gemm "
          f"{r['launches']['ovsf_gemm']} (all {cfg.ovsf.alpha_dtype}, "
          "tensor-core)", flush=True)
    return r, state


def quant_train_full(seed: int, card: str, dev, tmp: str) -> dict:
    """Phase 16 (2): TinyLlama-1.1B at full width and depth with int8
    alphas (bf16, B 8, S 128, remat, the config's ``materialize``) through
    ``steps.make_train_step`` under ``runtime.supervisor.run``, as
    ``launch.train`` builds its loop: ``QUANT_STEPS`` steps, checkpoints at
    ``QUANT_SAVE_EVERY`` and the end, a ``fail`` at ``QUANT_FAIL_AT`` that
    restores the first and replays, under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``. Gates: one
    failure and one restore, the replayed step's loss bit for bit the
    first pass's, finite losses, 220 segmented ``ovsf_decompress`` a step
    (its int8 epilogue) and nothing else of ours (``check_quant_steps``),
    the int8 alphas and ids bit for bit as initialised, the first batch's
    loss lower under the trained params (phase 15's rule; the last loss
    and a held-out batch's printed). Each step's wall, device busy and
    idle share, the peak memory and the saves' seconds printed. Then one
    step under an explicit ``fused`` plan (``quant_fused_step``): 220
    int8 ``ovsf_gemm``, all tensor-core."""
    import warnings
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.runtime import supervisor
    from repro_torch.runtime.faults import FaultPlan
    from repro_torch.train import optim, steps
    tag = "[quant train]"
    cfg = quant_cfg(QUANT_ARCH, "int8")
    ocfg = optim.OptConfig(lr=FAMILY_LR, warmup_steps=2,
                           total_steps=QUANT_STEPS)
    stream = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = steps.train_state_init(cfg, seed, dev)
    per_step = train_gemms_per_step(cfg, state["params"])
    ints0 = [t.clone() for t in int_leaves(state["params"])]
    state_gib = sum(t.numel() * t.element_size()
                    for t in optim.tree_leaves(state)) / 2**30
    rows, logs = [], []
    fn = profiled_step(steps.make_train_step(cfg, ocfg), rows)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            state, rep = supervisor.run(
                fn, state, stream.batch_at, QUANT_STEPS,
                supervisor.SupervisorConfig(
                    ckpt_dir=os.path.join(tmp, "quant"),
                    save_every=QUANT_SAVE_EVERY, log_every=1000),
                faults=FaultPlan.parse([f"fail:step={QUANT_FAIL_AT}"]),
                log=logs.append)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    nondet = sorted({str(w.message).split(" does not have")[0][:120]
                     for w in caught if "deterministic" in str(w.message)})
    # steps 0 .. QUANT_FAIL_AT - 1, then QUANT_SAVE_EVERY again onwards
    first, again = rep.losses[QUANT_SAVE_EVERY], rep.losses[QUANT_FAIL_AT]
    ints_equal = all(torch.equal(a, b) for a, b in
                     zip(ints0, int_leaves(state["params"])))
    ev = steps.make_eval_step(cfg)
    refit, held = (float(ev(state["params"], stream.batch_at(s))
                         ["total_loss"]) for s in (0, FAMILY_HELD_OUT))
    walls = [r["wall_ms"] for r in rows]
    print(f"{tag} {cfg.name} int8 alphas, bf16, {cfg.n_layers} layers, B "
          f"{TRAIN_BATCH} S {TRAIN_SEQ}: {rep.steps_run} steps run in "
          f"{wall:.1f}s under the supervisor (failures {rep.failures}, "
          f"restores {rep.restores}); losses "
          f"{[round(v, 4) for v in rep.losses]}; step {QUANT_SAVE_EVERY} "
          f"first {first!r}, replayed {again!r} (ops without a deterministic"
          f" implementation: {nondet or 'none'}); the first batch's loss "
          f"{rep.losses[0]:.4f} -> {refit:.4f} under the trained params, the"
          f" last {rep.losses[-1]:.4f}, a held-out batch (step "
          f"{FAMILY_HELD_OUT}) {held:.4f}; int8 alphas and ids bit for bit "
          f"as initialised: {ints_equal}", flush=True)
    for i, r in enumerate(rows):
        print(f"{tag} step {i}: wall {r['wall_ms']:.1f} ms (profiled), "
              f"device busy {r['busy_ms']:.1f} ms, idle share "
              f"{r['idle_share']:.3f}, {r['kernels']} kernels, "
              f"ovsf_decompress {r['launches']['ovsf_decompress']} "
              f"({r['layouts']['seg']} segmented)", flush=True)
    print(f"{tag} segmented ovsf_decompress {per_step} a step; step wall "
          f"median "
          f"{statistics.median(walls):.1f} ms, device busy median "
          f"{statistics.median(r['busy_ms'] for r in rows):.1f} ms; peak "
          f"memory_allocated {peak:.2f} GiB; state {state_gib:.2f} GiB; "
          f"saves: host copy {[round(v, 2) for v in rep.save_snapshot_s]} s"
          f" + write {[round(v, 2) for v in rep.save_write_s]} s ({card})",
          flush=True)
    check_quant_steps(tag, cfg, rows, per_step)
    fused_row, state = quant_fused_step(tag, cfg, state,
                                        stream.batch_at(QUANT_STEPS),
                                        per_step)
    if (rep.failures != 1 or rep.restores != 1
            or len(rep.losses) != QUANT_STEPS + QUANT_FAIL_AT
            - QUANT_SAVE_EVERY or first != again
            or not all(math.isfinite(v) for v in rep.losses)
            or not ints_equal or not refit < rep.losses[0]):
        raise RuntimeError(f"{tag} failures {rep.failures} restores "
                           f"{rep.restores} losses {rep.losses} (replayed "
                           f"{again!r} vs {first!r}), integers equal "
                           f"{ints_equal}, refit {refit}: {logs}")
    total = sum(r["launches"]["ovsf_decompress"] for r in rows)
    return dict(layers=cfg.n_layers, losses=rep.losses, steps=rows,
                wall_s=wall, failures=rep.failures, restores=rep.restores,
                replayed=[first, again], nondeterministic=nondet,
                refit_first=refit, held_out=held, ovsf_per_step=per_step,
                ovsf_decompress=total, fused=fused_row,
                ovsf_gemm=fused_row["launches"]["ovsf_gemm"],
                peak_allocated_gib=peak,
                state_gib=state_gib, save_snapshot_s=rep.save_snapshot_s,
                save_write_s=rep.save_write_s)


def quant_train_int4(seed: int, card: str, dev) -> dict:
    """Phase 16 (3): the same step with int4 alphas at full width and
    ``QUANT_INT4_LAYERS`` layers, ``QUANT_INT4_STEPS`` steps through
    ``make_train_step`` (``materialize``): finite losses, the launches a
    step (segmented ``ovsf_decompress``, its int4 epilogue), the integers
    unchanged; each step profiled; then one step under an explicit
    ``fused`` plan (all int4, tensor-core)."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train import optim, steps
    tag = "[quant train int4]"
    cfg = quant_cfg(QUANT_ARCH, "int4", n_layers=QUANT_INT4_LAYERS)
    state = steps.train_state_init(cfg, seed, dev)
    per_step = train_gemms_per_step(cfg, state["params"])
    ints0 = [t.clone() for t in int_leaves(state["params"])]
    rows = []
    fn = profiled_step(steps.make_train_step(cfg, optim.OptConfig(
        lr=TRAIN_LR, warmup_steps=1, total_steps=QUANT_INT4_STEPS)), rows)
    stream = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    losses = []
    for s in range(QUANT_INT4_STEPS):
        state, m = fn(state, stream.batch_at(s))
        losses.append(float(m["total_loss"]))
    ints_equal = all(torch.equal(a, b) for a, b in
                     zip(ints0, int_leaves(state["params"])))
    print(f"{tag} {cfg.name} int4 alphas, bf16, {cfg.n_layers} layers: "
          f"losses {[round(v, 4) for v in losses]}; segmented "
          f"ovsf_decompress {per_step} a step; walls {[round(r['wall_ms'], 1) for r in rows]} ms, device "
          f"busy {[round(r['busy_ms'], 1) for r in rows]} ms, idle "
          f"{[round(r['idle_share'], 3) for r in rows]}; int4 alphas and ids"
          f" bit for bit as initialised: {ints_equal} ({card})", flush=True)
    check_quant_steps(tag, cfg, rows, per_step)
    if not (all(math.isfinite(v) for v in losses) and ints_equal):
        raise RuntimeError(f"{tag} losses {losses}, integers equal "
                           f"{ints_equal}")
    fused_row, state = quant_fused_step(
        tag, cfg, state, stream.batch_at(QUANT_INT4_STEPS), per_step)
    return dict(layers=cfg.n_layers, losses=losses, steps=rows,
                ovsf_per_step=per_step,
                ovsf_decompress=sum(r["launches"]["ovsf_decompress"]
                                    for r in rows),
                fused=fused_row, ovsf_gemm=fused_row["launches"]["ovsf_gemm"])


def quant_converted_train(seed: int, card: str, dev) -> dict:
    """Phase 16 (4): TinyLlama-1.1B built dense at full width and
    ``QUANT_CONVERT_LAYERS`` layers, converted (phase 14's converter) to
    monolithic int8 and int4 alphas, trained ``QUANT_CONVERT_STEPS`` steps
    (bf16, B 8, S 128, remat) with every OVSF layer planned
    ``materialize``: ``OvsfDecompressFn`` over the quantised storage, its
    forward the decompress kernel's epilogue and its backward the ``fwht``
    kernel. Gates: finite losses, the integers unchanged, per step 2
    ``ovsf_decompress`` and 1 ``fwht`` an OVSF linear (remat generates W
    again in the backward) and nothing else of ours."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.models import registry as R
    from repro_torch.runtime import mapper
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import optim, steps
    res = {}
    dense_cfg = convert_cfg("", "float32", QUANT_CONVERT_LAYERS)
    dense_cfg = dense_cfg.replace(ovsf=dataclasses.replace(dense_cfg.ovsf,
                                                           enable=False))
    dense = R.model_init(dense_cfg, seed, dev)
    for adt in ("int8", "int4"):
        tag = f"[quant converted {adt}]"
        cfg = convert_cfg(adt, "bfloat16", QUANT_CONVERT_LAYERS)
        params, _secs = convert_model(dense, cfg)
        plan = mapper.plan_model(cfg, ShapeConfig(
            "train_step", TRAIN_SEQ, TRAIN_BATCH, "train"), hw="h100",
            paths=("materialize",))
        cfg = mapper.apply_plan(cfg, plan)
        state = {"params": params, "opt": optim.adamw_init(params)}
        n_lin = ovsf_linears(params["blocks"])
        ints0 = [t.clone() for t in int_leaves(params)]
        fn = steps.make_train_step(cfg, optim.OptConfig(
            lr=TRAIN_LR, warmup_steps=1, total_steps=QUANT_CONVERT_STEPS))
        stream = TokenStream(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
        losses, per = [], []
        for s in range(QUANT_CONVERT_STEPS):
            reset_wrapper_counts()
            state, m = fn(state, stream.batch_at(s))
            losses.append(float(m["total_loss"]))
            per.append(wrapper_counts())
        ints_equal = all(torch.equal(a, b) for a, b in
                         zip(ints0, int_leaves(state["params"])))
        want = dict.fromkeys(per[0], 0)
        want.update(ovsf_decompress=2 * n_lin, fwht=n_lin)
        paths = sorted({p.path for _n, p in plan.entries})
        print(f"{tag} {cfg.name} converted (monolithic codes), bf16, "
              f"{cfg.n_layers} layers, plan {paths}: losses "
              f"{[round(v, 4) for v in losses]}; launches a step {per[0]}; "
              f"integers bit for bit as converted: {ints_equal} ({card})",
              flush=True)
        if (paths != ["materialize"] or any(p != want for p in per)
                or not all(math.isfinite(v) for v in losses)
                or not ints_equal):
            raise RuntimeError(f"{tag} plan {paths}, launches {per} (want "
                               f"{want}), losses {losses}, integers equal "
                               f"{ints_equal}")
        res[adt] = dict(losses=losses, launches=per,
                        ovsf_decompress=sum(p["ovsf_decompress"]
                                            for p in per))
        del state, params, fn
    del dense
    return res


def quant_parity(seed: int, dev) -> dict:
    """Phase 16 (5): one fp32 train step (remat off, B 2, S 64) of each of
    ``QUANT_PARITY`` at full width, on the card (an explicit ``fused``
    plan, ``fused_cfg``: the CUDA-core ``ovsf_gemm`` over the quantised
    storage) and on the CPU
    (``spectral``, as phase 15) from the same state, TF32 off: the loss
    within 1e-5 relative, every gradient leaf (the scales' included) and
    every updated float param within 1e-3 relative L2, and every integer
    leaf after the update bit for bit as before it, on both sides."""
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train import optim, steps
    cpu_dev = torch.device("cpu")
    B, S = FAMILY_PARITY_BATCH, FAMILY_PARITY_SEQ
    res = {}
    for arch, n, adt in QUANT_PARITY:
        cfg = quant_cfg(arch, adt, n_layers=n, dtype="float32", remat=False)
        card = steps.train_state_init(cfg, seed, dev)
        cpu = optim.tree_map(lambda _p, t: t.to(cpu_dev), card)
        toks = torch.from_numpy(TokenStream(cfg.vocab, S, B, seed=seed)
                                .batch_at(0)["tokens"])
        ocfg = optim.OptConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
        spectral = cfg.replace(ovsf=dataclasses.replace(
            cfg.ovsf, exec_path="spectral"))
        out, secs = {}, {}
        for name, st, d in (("card", card, dev), ("cpu", cpu, cpu_dev)):
            c = fused_cfg(spectral, (B, S)) if name == "card" else spectral
            t0 = time.perf_counter()
            loss, _m, g = steps.loss_and_grads(c, st["params"],
                                               {"tokens": toks.to(d)})
            new_p, _o, _mm = optim.adamw_update(ocfg, g, st["opt"],
                                                st["params"])
            loss = float(loss)
            secs[name] = time.perf_counter() - t0
            same = all(torch.equal(a, b) for a, b in
                       zip(int_leaves(st["params"]), int_leaves(new_p)))
            out[name] = (loss, optim.tree_leaves(g),
                         optim.tree_leaves(new_p), same)
            del st, g
        del card, cpu
        (lc, gc_, pc, sc), (lh, gh, ph, sh) = out["card"], out["cpu"]
        loss_err = abs(lc - lh) / abs(lh)
        g_err = max(rel_l2(a, b) for a, b in zip(gc_, gh) if a is not None)
        p_err = max(rel_l2(a.float(), b.float()) for a, b in zip(pc, ph)
                    if a.is_floating_point())
        ints = all(torch.equal(a.cpu(), b) for a, b in zip(pc, ph)
                   if not a.is_floating_point())
        n_scale = sum(1 for a in gc_ if a is not None and a.dim() == 2
                      and a.shape[-1] == 1)
        print(f"[quant parity] {arch} {adt} alphas, fp32, {cfg.n_layers} "
              f"layers, B {B} S {S}: loss {lc:.6f} vs CPU {lh:.6f} "
              f"({loss_err:.2e}, limit 1e-5), gradients {g_err:.2e} (the "
              f"scales' among {n_scale} (n_seg, 1) leaves), updated params "
              f"{p_err:.2e} (limit 1e-3 relative L2); integer leaves "
              f"unchanged by the update: card {sc}, CPU {sh}, card = CPU "
              f"{ints}; card {secs['card']:.1f}s, CPU {secs['cpu']:.1f}s",
              flush=True)
        if not (loss_err <= 1e-5 and g_err <= 1e-3 and p_err <= 1e-3
                and sc and sh and ints):
            raise RuntimeError(f"[quant parity] {arch} {adt}: loss "
                               f"{loss_err}, gradients {g_err}, params "
                               f"{p_err}, integers {sc} {sh} {ints}")
        res[f"{arch} {adt}"] = dict(layers=cfg.n_layers, loss_err=loss_err,
                                    grad_err=g_err, param_err=p_err,
                                    card_s=secs["card"], cpu_s=secs["cpu"])
        gc.collect()
        torch.cuda.empty_cache()
    return res


def whisper_stack_flash(rng, dev) -> dict:
    """Row 5m's shapes: a chunk-free contiguous packed step of the stacked
    Whisper-tiny engine (4 tokens, one a slot) reads each token's slot
    rows (self: T = the 256-row buffer, per-row positions) and its slot's
    1500 cross rows (pos 1500, every row); ``flash_row`` for each, bf16 and
    fp32."""
    cases = {"self": ("whisper stacked self read", 4, 6, 6, 64, 256, None),
             "cross": ("whisper stacked cross read", 4, 6, 6, 64, 1500,
                       (1500,) * 4)}
    out = {}
    for key, (label0, B, H, Hkv, hd, T, pos) in cases.items():
        rows = [flash_row(rng, dev, label0, B, H, Hkv, hd, T, pos, dt)
                for dt in (torch.bfloat16, torch.float32)]
        out[key] = dict(rows[0], max_abs_err=max(r["max_abs_err"]
                                                 for r in rows), cases=rows)
    sm = {k: out["self"][k] + out["cross"][k] for k in
          ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
    sm["max_abs_err"] = max(out[k]["max_abs_err"] for k in out)
    sm["bound_by"] = max(out.values(), key=lambda r: r["bound_ms"])[
        "bound_by"]
    return dict(out, summary=sm)


def whisper_stack_cfg(dtype: str):
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER_ARCH)
    return cfg.replace(dtype=dtype, ovsf=dataclasses.replace(
        cfg.ovsf, min_dim=WHISPER_STACK_MIN_DIM))


def whisper_stack_run(seed: int, card: str, dev, dtype: str) -> dict:
    """Two Whisper-tiny variants (the launcher's seeded loader and its
    ``make_alpha_variant``) registered under one architecture signature,
    served by the gateway's one stacked engine (``WHISPER_STACK_KW``, every
    step replayed from CUDA graphs) with phase 4's 8 requests alternating
    between them: every request finishes once; per engine step one
    ``flash_decode_attn`` a layer for the self reads and one for the packed
    cross reads (every row unmasked) and no other kernel of ours. Then four
    requests (two a variant) decode: ``DECODE_STEPS`` chunk-free steps
    timed, and their launches counted."""
    from repro_torch.kernels.decode_attn import flash_decode_attn
    from repro_torch.launch.gateway import make_loader
    from repro_torch.serving import ModelRegistry, Request
    from repro_torch.serving.model_registry import alpha_bank_bytes
    tag = f"[whisper stacked {'fp32' if dtype == 'float32' else 'bf16'}]"
    cfg = whisper_stack_cfg(dtype)
    reg = ModelRegistry()
    for k, alias in enumerate(WHISPER_STACK_NAMES):
        reg.register(alias, cfg, make_loader(cfg, seed, k, dev),
                     tags=(WHISPER_ARCH, f"variant-{k}"))
    specs = [(rid, WHISPER_STACK_NAMES[rid % 2], prompt, 16, sp)
             for rid, prompt, sp in serve_specs(cfg, seed)]
    gw, streams, wall, per = gateway_drive(reg, dev, specs, tag,
                                           engine_kw=WHISPER_STACK_KW)
    # gateway_drive zeroed the counters just before the run
    unmasked = flash_decode_attn.launches_unmasked
    eng = gw.engine_for(WHISPER_STACK_NAMES[0])
    c = per[eng.model_label]
    banks = alpha_bank_bytes(reg.entries[WHISPER_STACK_NAMES[0]].params)
    want = dict.fromkeys(c["launches"], 0)
    want["flash_decode_attn"] = 2 * cfg.n_layers * c["steps"]
    keys = sorted(eng.core.graphs.keys())
    if (eng is not gw.engine_for(WHISPER_STACK_NAMES[1])
            or eng.variants != 2 or not banks or c["launches"] != want
            or unmasked != cfg.n_layers * c["steps"]
            or keys != sorted(eng.core.step_shapes)):
        raise RuntimeError(f"{tag} engine {eng.model_label} variants "
                           f"{eng.variants}, alpha banks {banks} B, launches "
                           f"{c} (want {want}; unmasked {unmasked}), graphs "
                           f"{keys}, step shapes {eng.core.step_shapes}")
    rng = np.random.default_rng(seed + 53)
    for j in range(4):
        eng.submit(Request(300 + j, rng.integers(0, cfg.vocab, 24,
                                                 dtype=np.int32),
                           max_new_tokens=4 * DECODE_STEPS,
                           model=WHISPER_STACK_NAMES[j % 2]))
    for _ in range(12):
        eng.step()
        if all(s is not None and s.out_tokens for s in eng.slots):
            break
    else:
        raise RuntimeError(f"{tag} the four requests never all decoded")
    torch.cuda.synchronize()
    reset_wrapper_counts()
    u0 = flash_decode_attn.launches_unmasked
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / DECODE_STEPS * 1e3
    per_step = {w: n / DECODE_STEPS for w, n in wrapper_counts().items()}
    cross = (flash_decode_attn.launches_unmasked - u0) / DECODE_STEPS
    print(f"{tag} {cfg.name} uncut ({cfg.n_layers} + {cfg.encoder_layers} "
          f"layers, d {cfg.d_model}), OVSF min_dim {cfg.ovsf.min_dim}: "
          f"variants {WHISPER_STACK_NAMES} in one stacked engine "
          f"({eng.model_label}; alpha banks {banks / 2**20:.2f} MiB a "
          f"variant); 8 requests finished once in {wall:.2f}s, {c['steps']}"
          f" steps ({c['chunk_free']} chunk-free), launches {c['launches']}"
          f" ({unmasked} unmasked: the cross reads); graphs {keys}; "
          f"chunk-free step {step_ms:.3f} ms, flash_decode_attn a step "
          f"{per_step['flash_decode_attn']:.1f} ({cross:.1f} cross), "
          f"ovsf_gemm {per_step['ovsf_gemm']:.1f} ({card})", flush=True)
    close_gateway(gw)
    return dict(reg=reg, specs=specs, streams=streams, wall_s=wall,
                counts=c, unmasked=unmasked, graphs=keys, step_ms=step_ms,
                per_step=per_step, cross_per_step=cross,
                alpha_bank_bytes=banks)


def whisper_stack_phase(seed: int, card: str, dev) -> dict:
    """Phase 16 (6): the stacked Whisper-tiny pair in fp32 (TF32 off), every
    stream equal to a dedicated single-model engine's on its variant with
    every layer ``spectral`` (``dedicated_streams``; hazard H1), then in
    bf16, its streams printed."""
    res = {}
    for dtype in ("float32", "bfloat16"):
        run = whisper_stack_run(seed, card, dev, dtype)
        reg, specs = run.pop("reg"), run.pop("specs")
        if dtype == "float32":
            ded = dedicated_streams(reg, WHISPER_STACK_NAMES, dev, specs,
                                    "[whisper stacked fp32]",
                                    engine_kw=WHISPER_STACK_KW)
            same = sum(run["streams"][r] == ded[r] for r in ded)
            print(f"[whisper stacked fp32] {same} of {len(ded)} streams "
                  "equal dedicated spectral engines", flush=True)
            if run["streams"] != ded:
                raise RuntimeError(f"[whisper stacked fp32] streams "
                                   f"{run['streams']} differ from the "
                                   f"dedicated engines' {ded}")
            run["equal_dedicated"] = True
        else:
            print("[whisper stacked bf16] streams "
                  + "; ".join(f"{rid} ({specs[rid][1]}) {toks}"
                              for rid, toks in sorted(run["streams"]
                                                      .items())), flush=True)
        del reg
        gc.collect()
        torch.cuda.empty_cache()
        res[dtype] = run
    return res


def quant_train_phase(seed: int, card: str, dev) -> dict:
    """Phase 16 (module docstring): training with quantised alphas, and the
    stacked Whisper-tiny pair."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    secs = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return out
    rng = np.random.default_rng(seed + 61)
    res = dict(kernels=timed("kernels", run_quant_train_kernel_checks, rng,
                             dev))
    res["flash"] = timed("flash", whisper_stack_flash, rng, dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_quant_train_")
    try:
        res["full"] = timed("full", quant_train_full, seed, card, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["int4"] = timed("int4", quant_train_int4, seed, card, dev)
    res["converted"] = timed("converted", quant_converted_train, seed, card,
                             dev)
    res["parity"] = timed("parity", quant_parity, seed, dev)
    res["whisper"] = timed("whisper", whisper_stack_phase, seed, card, dev)
    res["wall_s"] = time.perf_counter() - t_phase
    res["seconds"] = secs
    print(f"[quant train] phase passed in {res['wall_s']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return res


# -- phase 17: the reference's materialize path for the LMs -------------------

# TinyLlama-1.1B's five OVSF projections (d_in, d_out), segmented codes of 16
# with 8 kept a segment: the segmented ovsf_decompress kernel's layer
SEG_LAYER = TRAIN_LAYER
SEG_L0, SEG_KEEP = 16, 8
# its ragged cases: (d_in, d_out, L0, n_keep, repeated ids): L0 8 and 32,
# n_keep 5 and L0, d_out off the 32-column tile, ids that repeat
SEG_RAGGED = ((1000, 77, 8, 5, False), (2048, 100, 32, 5, False),
              (512, 40, 16, 8, True), (256, 34, 32, 32, True))
SEG_STORAGES = ("fp32", "bf16", "int8", "int4")
# OLMoE-1B-7B's three expert banks of a layer (E, d_in, d_out): gate, up
# (2048 -> 1024) and down (1024 -> 2048), 64 experts sharing each bank's
# ids, L0 16, 8 kept: one launch a bank (phase 10's path), float storage
SEG_BANKS = ((64, 2048, 1024), (64, 2048, 1024), (64, 1024, 2048))
SEG_BANK_STORAGES = ("bf16", "fp32")
# the unplanned engine: the main path's paged packed step, the mapper off,
# so every OVSF layer runs the config's materialize
MAT_ENGINE_KW = dict(chunk_size=64, paged=True, packed=True,
                     use_mapper=False)
MAT_LAYERS = {"": 0, "int8": 0, "int4": SERVE_CUT_LAYERS}   # 0: all 22
MAT_FP32_LAYERS = SERVE_FP32_LAYERS      # fp32 streams against fused
MAT_PARITY_LAYERS = 2                    # card vs CPU logits, fp32


def seg_case(rng, d_in: int, N: int, L0: int, nk: int, storage: str, dev,
             repeat: bool = False, E: int = 0):
    """Inputs of one segmented ``ovsf_decompress`` call: (stored alphas,
    kwargs with the scales, ids, fp32 alphas). Each segment's ids drawn
    on their own (with replacement and one forced repeat when
    ``repeat``); unit-scale W; int8 / int4 with a scale a segment, as the
    LM configs store them; ``E`` > 0: a bank of E alpha sets (E, J, N)
    sharing the ids, float storage."""
    from repro_torch.core.ovsf import quantize_alphas
    ns = d_in // L0
    idx = np.stack([np.sort(rng.choice(L0, nk, replace=repeat))
                    for _ in range(ns)]).astype(np.int32)
    if repeat:
        idx[0, :2] = idx[0, 0]
    if E:           # drawn on the card: a bank holds 10^7-10^8 alphas
        al = torch.randn((E, ns * nk, N), device=dev,
                         generator=torch.Generator(dev).manual_seed(
                             int(rng.integers(2**31)))) / math.sqrt(nk)
    else:
        al = torch.from_numpy(rng.standard_normal((ns * nk, N), np.float32)
                              / math.sqrt(nk)).to(dev)
    kw = {}
    stored = al.bfloat16() if storage == "bf16" else al
    if storage in ("int8", "int4"):
        stored, sc = quantize_alphas(al, ns, storage)
        kw = dict(alpha_scale=sc, alpha_dtype=storage)
    return stored, kw, torch.from_numpy(idx).to(dev), al


def seg_decompress_row(rng, dev, d_in: int, N: int, L0: int, nk: int,
                       storage: str, repeat: bool = False,
                       tag: str = "[kernel]", E: int = 0) -> dict:
    """One segmented ``ovsf_decompress`` call (``seg_case``; ``E`` > 0: an
    expert bank of E alpha sets, one launch) against its plain version:
    fp32 W (fp32 and quantised alphas) within rtol = atol = 2e-3 and, on
    distinct ids, bit for bit; bf16 W within 2e-2 relative L2 of the plain
    version (which rounds each butterfly stage in bf16, as the reference's
    jnp) and, on distinct ids, bit for bit the plain version over the fp32
    alphas rounded once (the kernel's fp32 sums); a second launch equal to
    the first; one segmented launch each, W row-major. Device ms by graph
    replay (inputs rotated past L2), the plain version's, and one
    ``torch.bmm`` of a prebuilt (n_seg, L0, n_keep) sign tensor (repeated
    over a bank's E) by the (E n_seg, n_keep, d_out) alphas (the library
    call; dequantised beforehand). Bound: the stored alphas, ids and
    scales read and W written once, or the E d_in d_out log2 L0 transform
    adds (and J d_out dequantising multiplies) at the fp32 rate."""
    from repro_torch.core.ovsf import dequantize_alphas, hadamard_matrix
    from repro_torch.kernels.ovsf_gemm import (ovsf_decompress,
                                               ovsf_decompress_plain)
    a, kw, idx, _al = seg_case(rng, d_in, N, L0, nk, storage, dev, repeat, E)
    del _al
    ns = d_in // L0
    w_dt = torch.bfloat16 if storage == "bf16" else torch.float32
    w_shape = ((E,) if E else ()) + (d_in, N)
    label = (f"ovsf_decompress seg {storage} "
             + (f"bank E={E} " if E else "")
             + f"d_in={d_in} N={N} L0={L0} "
             f"n_keep={nk}{' repeated ids' if repeat else ''}")
    before = ovsf_decompress.launches_by_layout["seg"]
    got = ovsf_decompress(a, idx, d_in, **kw)
    again = ovsf_decompress(a, idx, d_in, **kw)
    want = ovsf_decompress_plain(a, idx, d_in, **kw)
    torch.cuda.synchronize()
    if (ovsf_decompress.launches_by_layout["seg"] != before + 2
            or got.dtype != w_dt or tuple(got.shape) != w_shape
            or not got.is_contiguous()):
        raise RuntimeError(f"{label}: W {got.dtype} {tuple(got.shape)}, "
                           "not two segmented launches into a row-major W")
    if storage == "bf16":
        if not torch.isfinite(got.float()).all():
            raise RuntimeError(f"{label}: W not finite")
        err = float((got.float() - want.float()).abs().max())
        rel = rel_l2(got, want)
        once = ovsf_decompress_plain(a.float(), idx, d_in).to(w_dt)
        if not rel <= TOL[w_dt] or not (repeat or torch.equal(got, once)):
            raise RuntimeError(f"{label}: relative L2 {rel:.2e} vs the plain"
                               f" version (limit {TOL[w_dt]}); equal to the "
                               "fp32 sums rounded once: "
                               f"{torch.equal(got, once)}")
        del once
    else:
        err = check(label, got, want, w_dt)
        rel = rel_l2(got, want)
    exact = torch.equal(got, want)
    if not torch.equal(got, again):
        raise RuntimeError(f"{label}: a second launch differs from the "
                           "first")
    if storage != "bf16" and not (repeat or exact):
        raise RuntimeError(f"{label}: fp32 W differs from the plain version"
                           f" on distinct ids (max abs err {err:.3e})")
    del got, again, want
    bytes_ = (a.numel() * a.element_size() + idx.numel() * 4
              + (ns * 4 if kw else 0)
              + max(E, 1) * d_in * N * (2 if w_dt == torch.bfloat16 else 4))
    ops = (max(E, 1) * d_in * N * math.log2(L0)
           + (a.shape[-2] * N if kw else 0))
    t_bound, by = bound(bytes_, ops, torch.float32)
    copies = [a.clone() for _ in range(n_copies(bytes_) - 1)] + [a]
    ms, call_ms = timings([lambda c=c: ovsf_decompress(c, idx, d_in, **kw)
                           for c in copies], 40)
    plain_ms, _ = timings([lambda c=c: ovsf_decompress_plain(
        c, idx, d_in, **kw) for c in copies[:2]], 4)
    St = hadamard_matrix(L0, w_dt, dev)[idx.long()].transpose(1, 2) \
        .repeat(max(E, 1), 1, 1).contiguous()   # (E n_seg, L0, n_keep)
    lib_in = [(dequantize_alphas(c, kw["alpha_scale"], storage) if kw
               else c).reshape(-1, nk, N) for c in copies]
    lib_err = float((torch.bmm(St, lib_in[0]).reshape(w_shape).float()
                     - ovsf_decompress_plain(a, idx, d_in, **kw).float())
                    .abs().max())
    lib_ms, _ = timings([lambda b=b: torch.bmm(St, b) for b in lib_in], 40)
    del copies, lib_in, St
    torch.cuda.empty_cache()
    print(f"{tag} {label}: max_abs_err={err:.3e} rel_l2={rel:.2e} (tol "
          f"{TOL[w_dt]}; equal bit for bit: {exact}) kernel={ms:.4f}ms (per "
          f"Python call {call_ms:.4f}ms) bound={t_bound:.5f}ms ({by}; "
          f"{t_bound / ms:.0%} of it) plain={plain_ms:.4f}ms library(bmm "
          f"signs x alphas)={lib_ms:.4f}ms (kernel/library "
          f"{ms / lib_ms:.2f}; its err {lib_err:.1e})", flush=True)
    return dict(case=label, E=E, d_in=d_in, N=N, L0=L0, n_keep=nk,
                repeated_ids=repeat, storage=storage, max_abs_err=err,
                rel_l2=rel, exact=exact, ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_err=lib_err,
                bound_ms=t_bound, bound_by=by, bound_share=t_bound / ms)


def seg_grad_row(rng, dev, d_in: int, N: int, storage: str) -> dict:
    """``OvsfDecompressFn`` over segmented ids (``seg_case``, L0 16, 8
    kept): W and dA (fp32, bf16) or d scale (int8 / int4) against autograd
    through the plain version, relative L2 within 2e-3 (fp32 gradients) /
    2e-2 (bf16); one segmented launch, no other kernel of ours."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ovsf_gemm import ovsf_decompress_plain
    a, kw, idx, _al = seg_case(rng, d_in, N, SEG_L0, SEG_KEEP, storage, dev)
    dt = torch.bfloat16 if storage == "bf16" else torch.float32
    G = torch.randn((d_in, N), device=dev, dtype=dt)
    tag = f"[kernel] OvsfDecompressFn seg {storage} {d_in}->{N}"
    reset_wrapper_counts()
    if kw:
        adt = kw["alpha_dtype"]
        err = grad_check(tag, lambda b: ops.ovsf_decompress_fn(
            a, idx, d_in, alpha_scale=b, alpha_dtype=adt),
            lambda b: ovsf_decompress_plain(a, idx, d_in, alpha_scale=b,
                                            alpha_dtype=adt),
            [kw["alpha_scale"]], G, dt, ("W", "d scale"))
    else:
        err = grad_check(tag, lambda b: ops.ovsf_decompress_fn(b, idx, d_in),
                         lambda b: ovsf_decompress_plain(b, idx, d_in), [a],
                         G, dt, ("W", "dA"))
    launched = {k: v for k, v in wrapper_counts().items() if v}
    if launched != {"ovsf_decompress": 1}:
        raise RuntimeError(f"{tag}: launched {launched}")
    print(f"{tag}: W and {'d scale' if kw else 'dA'} within {TOL[dt]} "
          f"relative L2 of autograd through the plain version (max abs err "
          f"{err:.3e})", flush=True)
    return dict(case=tag, storage=storage, max_abs_err=err)


def run_seg_decompress_checks(rng, dev) -> dict:
    """Phase 3, for phases 17 and 10: the segmented ``ovsf_decompress``
    kernel (``seg_decompress_row``) at TinyLlama-1.1B's five shapes and the
    ragged ``SEG_RAGGED`` cases, in every alpha storage, at OLMoE-1B-7B's
    three expert banks (``SEG_BANKS``, bf16 and fp32), and its gradients
    (``seg_grad_row``) at gate's shape. Returns the rows and, per storage,
    one layer's five calls summed (``summary``) and one layer's three
    banks summed (``bank_summary``)."""
    rows = []
    for d_in, N in sorted(set(SEG_LAYER.values())):
        rows += [seg_decompress_row(rng, dev, d_in, N, SEG_L0, SEG_KEEP, st)
                 for st in SEG_STORAGES]
    for d_in, N, L0, nk, repeat in SEG_RAGGED:
        rows += [seg_decompress_row(rng, dev, d_in, N, L0, nk, st, repeat)
                 for st in SEG_STORAGES if not (st == "int4" and N % 2)]
    banks = [seg_decompress_row(rng, dev, d_in, N, SEG_L0, SEG_KEEP, st,
                                E=E)
             for E, d_in, N in sorted(set(SEG_BANKS))
             for st in SEG_BANK_STORAGES]
    grads = [seg_grad_row(rng, dev, *SEG_LAYER["gate"], st)
             for st in SEG_STORAGES]

    def summed(picked: list, errs: list) -> dict:
        sm = {k: sum(r[k] for r in picked) for k in
              ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")}
        sm["bound_by"] = ("bytes" if all(r["bound_by"] == "bytes"
                                         for r in picked) else "operations")
        sm["max_abs_err"] = max(r["max_abs_err"] for r in errs)
        return sm
    summary, bank_summary = {}, {}
    for st in SEG_STORAGES:
        pick = {(r["d_in"], r["N"]): r for r in rows
                if r["storage"] == st and r["L0"] == SEG_L0
                and r["n_keep"] == SEG_KEEP and not r["repeated_ids"]}
        sm = summary[st] = summed([pick[kn] for kn in SEG_LAYER.values()],
                                  [r for r in rows if r["storage"] == st])
        print(f"[kernel] ovsf_decompress seg {st}, TinyLlama-1.1B's layer "
              f"(q, o, gate, up, down): {sm['ms']:.4f} ms, bound "
              f"{sm['bound_ms']:.4f} ms ({sm['bound_by']}; "
              f"{sm['bound_ms'] / sm['ms']:.0%} of it), plain "
              f"{sm['plain_ms']:.4f} ms, "
              f"bmm {sm['library_ms']:.4f} ms (kernel/bmm "
              f"{sm['ms'] / sm['library_ms']:.2f})", flush=True)
    for st in SEG_BANK_STORAGES:
        pick = {(r["E"], r["d_in"], r["N"]): r for r in banks
                if r["storage"] == st}
        sm = bank_summary[st] = summed([pick[b] for b in SEG_BANKS],
                                       list(pick.values()))
        print(f"[kernel] ovsf_decompress seg {st}, OLMoE-1B-7B's three "
              f"expert banks of a layer (64 experts, one launch a bank): "
              f"{sm['ms']:.4f} ms, bound {sm['bound_ms']:.4f} ms "
              f"({sm['bound_by']}; {sm['bound_ms'] / sm['ms']:.0%} of it), "
              f"plain {sm['plain_ms']:.4f} ms, bmm over the batch "
              f"{sm['library_ms']:.4f} ms (kernel/bmm "
              f"{sm['ms'] / sm['library_ms']:.2f})", flush=True)
    return dict(rows=rows, banks=banks, grads=grads, summary=summary,
                bank_summary=bank_summary)


def mat_cfg(alpha_dtype: str = "", dtype: str = "bfloat16",
            n_layers: int = 0):
    """TinyLlama-1.1B as registered (segmented codes of 16, rho 0.5, its
    own ``exec_path``, ``materialize``), alphas stored as
    ``alpha_dtype``."""
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama_1_1b")
    if cfg.ovsf.exec_path != "materialize" or cfg.ovsf.seg_len != SEG_L0:
        raise RuntimeError(f"tinyllama_1_1b: exec_path "
                           f"{cfg.ovsf.exec_path}, seg_len "
                           f"{cfg.ovsf.seg_len}")
    return cfg.replace(dtype=dtype, n_layers=n_layers or cfg.n_layers,
                       ovsf=dataclasses.replace(cfg.ovsf,
                                                alpha_dtype=alpha_dtype))


def mat_serve(seed: int, card: str, dev, alpha_dtype: str,
              fused_profile: dict) -> dict:
    """Phase 17 (2): TinyLlama-1.1B, bf16, alphas ``alpha_dtype``, at
    ``MAT_LAYERS`` depth through ``family_serve`` with the main path's
    engine unplanned (``MAT_ENGINE_KW``): every step that runs tokens
    launches 5 segmented ``ovsf_decompress`` a layer and one
    ``paged_flash_decode`` a layer, no ``ovsf_gemm``; eager and replayed
    equal (streams, chunk-free logits bit for bit, launches, profiled
    kernels). The replayed step's wall, busy and idle printed beside the
    fused engine's (phase 4, ``fused_profile``; bf16 alphas at 22
    layers)."""
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.models import registry as R
    cfg = mat_cfg(alpha_dtype, n_layers=MAT_LAYERS[alpha_dtype])
    tag = f"[materialize {alpha_dtype or 'bf16'} paged packed]"
    params = R.model_init(cfg, seed, dev)
    n_ovsf = ovsf_per_layer(params)

    def unplanned(eng, _key):
        if eng.cfg.exec_plan is not None or eng.cfg.ovsf.exec_path != \
                "materialize":
            raise RuntimeError(f"{tag} the engine planned {eng.cfg.exec_plan}"
                               f" / {eng.cfg.ovsf.exec_path}")
        return {}
    run = family_serve(params, cfg, seed, card, dev, tag,
                       {"ovsf_decompress": n_ovsf * cfg.n_layers,
                        "paged_flash_decode": cfg.n_layers}, unplanned,
                       engine_kw=MAT_ENGINE_KW)
    layouts = dict(G.ovsf_decompress.launches_by_layout)
    if n_ovsf != len(SEG_LAYER) or layouts["mono"] or not layouts["seg"]:
        raise RuntimeError(f"{tag} {n_ovsf} OVSF linears a block, "
                           f"ovsf_decompress by layout {layouts}")
    pm, pf = run["decode_profile"], fused_profile
    print(f"{tag} {cfg.n_layers} layers: the replayed chunk-free step under "
          f"materialize: wall {pm['step_ms']:.3f} ms, busy {pm['busy_ms']} "
          f"ms, idle share {pm['idle_share']}, ovsf_decompress "
          f"{run['ovsf_decompress_ms']:.3f} ms of it; phase 4's fused step "
          f"(bf16 alphas, 22 layers): wall {pf['step_ms']:.3f} ms, busy "
          f"{pf['busy_ms']} ms, idle share {pf['idle_share']} ({card})",
          flush=True)
    del params
    return dict(run, layers=cfg.n_layers, layouts=layouts)


def mat_fp32_streams(seed: int, dev) -> dict:
    """Phase 17 (3): fp32 TinyLlama-1.1B at ``MAT_FP32_LAYERS`` layers, the
    same params and 8 requests through the unplanned paged packed engine
    (``materialize``) and the planned one (``fused``, every weight type),
    both replayed: the greedy streams equal (the sampled ones printed)."""
    from repro_torch.models import registry as R
    cfg = mat_cfg("", "float32", MAT_FP32_LAYERS)
    params = R.model_init(cfg, seed, dev)
    specs = serve_specs(cfg, seed)
    runs, plans = {}, {}
    for path, kw in (("materialize", MAT_ENGINE_KW),
                     ("fused", dict(chunk_size=64, **STYLES["paged packed"]))):
        eng, runs[path] = serve_run(params, cfg, dev, "paged packed",
                                    serve_requests(specs),
                                    f"[materialize fp32 {path}]", True,
                                    False, engine_kw=kw)
        plan = eng.cfg.exec_plan
        plans[path] = (sorted({p.path for _n, p in plan.entries}) if plan
                       else [eng.cfg.ovsf.exec_path])
        eng.core.close()
        del eng
    greedy = [rid for rid, _p, sp in specs if not sp]
    tm, tf = runs["materialize"]["tokens"], runs["fused"]["tokens"]
    same = all(tm[r] == tf[r] for r in greedy)
    sampled = {rid: tm[rid] == tf[rid] for rid, _p, sp in specs if sp}
    totals = {path: {k: sum(d[k] for _c, _a, d in r["per_step"])
                     for k in ("ovsf_decompress", "ovsf_gemm")}
              for path, r in runs.items()}
    print(f"[materialize fp32] {cfg.n_layers} layers, paged packed, "
          f"replayed: greedy streams under {plans['materialize']} equal the "
          f"engine's under {plans['fused']}: {same} ({len(greedy)} "
          f"requests); sampled equal {sampled}; launches {totals}",
          flush=True)
    if (not same or plans != {"materialize": ["materialize"],
                              "fused": ["fused"]}
            or totals["materialize"]["ovsf_gemm"]
            or not totals["materialize"]["ovsf_decompress"]
            or totals["fused"]["ovsf_decompress"]
            or not totals["fused"]["ovsf_gemm"]):
        raise RuntimeError(f"[materialize fp32] plans {plans}, greedy "
                           f"streams equal {same}, launches {totals}")
    del params
    return dict(layers=cfg.n_layers, greedy_equal=same,
                sampled_equal=sampled, plans=plans)


def mat_parity(seed: int, dev) -> dict:
    """Phase 17 (4): one full-width fp32 packed paged step of TinyLlama at
    ``MAT_PARITY_LAYERS`` layers, unplanned (``materialize``: the
    segmented kernel on the card, its plain version on the CPU), card vs
    CPU from the same params: logits within 1e-3 relative L2; the card's
    step launched only segmented ``ovsf_decompress`` and
    ``paged_flash_decode``."""
    from repro_torch.kernels import ovsf_gemm as G
    from repro_torch.models import registry as R
    cfg = mat_cfg("", "float32", MAT_PARITY_LAYERS)
    params = R.model_init(cfg, seed + 3, dev)
    n_ovsf = ovsf_per_layer(params)
    reset_wrapper_counts()
    gpu = paged_step_logits(params, cfg, dev, seed)
    launched = {k: v for k, v in wrapper_counts().items() if v}
    seg = G.ovsf_decompress.launches_by_layout["seg"]
    cpu = paged_step_logits(R.params_to(params, "cpu"), cfg,
                            torch.device("cpu"), seed)
    del params
    if not torch.isfinite(gpu).all():
        raise RuntimeError("[materialize parity] logits not finite")
    rel = float((gpu - cpu).norm() / cpu.norm())
    want = {"ovsf_decompress": n_ovsf * cfg.n_layers,
            "paged_flash_decode": cfg.n_layers}
    print(f"[materialize parity] {cfg.n_layers} full-width layers, fp32 "
          f"packed paged step (61 tokens), materialize: card vs CPU logits "
          f"rel L2 {rel:.3e} (limit 1e-3); the card launched {launched} "
          f"({seg} segmented)", flush=True)
    if not rel <= 1e-3 or launched != want or seg != want["ovsf_decompress"]:
        raise RuntimeError(f"[materialize parity] {rel:.3e}, launched "
                           f"{launched} (want {want}, {seg} segmented)")
    return dict(layers=cfg.n_layers, rel_err=rel, launched=launched)


def materialize_phase(seed: int, card: str, dev, fused_profile: dict
                      ) -> dict:
    """Phase 17 (module docstring): full-width TinyLlama-1.1B served
    unplanned under the config's ``materialize`` through the segmented
    ``ovsf_decompress`` kernel (its kernel rows in phase 3)."""
    t_phase = time.perf_counter()
    secs = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return out
    res = {adt or "bf16": timed(adt or "bf16", mat_serve, seed, card, dev,
                                adt, fused_profile)
           for adt in MAT_LAYERS}
    res["fp32"] = timed("fp32", mat_fp32_streams, seed, dev)
    res["parity"] = timed("parity", mat_parity, seed, dev)
    res["wall_s"] = time.perf_counter() - t_phase
    res["seconds"] = secs
    print(f"[materialize] phase passed in {res['wall_s']:.1f}s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_run = time.perf_counter()
    # cuBLAS's deterministic workspace for phase 13's replay check (cuBLAS
    # reads it when its first handle is made)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    marks = [("start", time.perf_counter())]

    def mark(name: str) -> None:
        # each phase starts clean: an engine's reference cycles hold its
        # graphs' memory pools until a collection; the reading before and
        # after it shows what the phase left
        before = torch.cuda.memory_reserved(dev) / 2**20
        gc.collect()
        torch.cuda.empty_cache()
        marks.append((name, time.perf_counter()))
        print(f"[timing] {name} {marks[-1][1] - marks[-2][1]:.1f}s; "
              f"memory_reserved {before:.0f} MiB at its end, "
              f"{torch.cuda.memory_reserved(dev) / 2**20:.0f} MiB after a "
              "collection", flush=True)

    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {len(libs)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f}s: "
          + ", ".join(p.name for p in libs.values()), flush=True)

    mark("build")
    rng = np.random.default_rng(args.seed)
    gemm = {adt: run_gemm_checks(rng, dev, adt) for adt in ALPHA_DTYPES}
    attn_rows, attn_sum = run_paged_checks(rng, dev)
    flash_rows, flash_sum, flash_gathers = run_flash_checks(rng, dev)
    attn_shapes = run_attn_shape_checks(rng, dev)
    int8_rows, int8_sums = run_int8_attn_checks(rng, dev, attn_rows,
                                                flash_rows)
    dec_rows, dec_sum = run_decompress_checks(rng, dev)
    conv_kernels = run_convert_kernel_checks(
        np.random.default_rng(args.seed + 41), dev)
    seg_kernels = run_seg_decompress_checks(
        np.random.default_rng(args.seed + 71), dev)
    fwht_rows, fwht_sum, fwht_refused = run_fwht_checks(rng, dev)
    mono_rows = run_mono_checks(rng, dev)
    refused = check_quant_contract(dev)
    three_paths = run_three_paths(args.seed, dev)
    print("[kernels] checked against their plain versions: ovsf_gemm ("
          + ", ".join(f"{len(rows)} {adt or 'bf16/fp32-alpha'}"
                      for adt, (rows, _s) in gemm.items())
          + f" cases), paged_flash_decode ({len(attn_rows)} cases), "
          f"flash_decode_attn ({len(flash_rows)} cases), the two attention "
          f"kernels at other shapes ({len(attn_shapes)} cases) and over int8"
          f" K/V ({len(int8_rows)} cases), "
          f"ovsf_decompress ({len(dec_rows)} cases; its int8 / int4 "
          f"epilogue {len(conv_kernels['rows'])} cases; the segmented "
          f"layout {len(seg_kernels['rows'])} cases and "
          f"{len(seg_kernels['grads'])} gradient cases), fwht "
          f"({len(fwht_rows)} cases), the monolithic tensor-core ovsf_gemm "
          f"({len(mono_rows)} cases here, the 19 CNN convs in the calibrate "
          "phase)", flush=True)

    mark("kernels")
    serve, launches = {}, {}
    for adt in ALPHA_DTYPES:
        serve[adt or "fp"], launches[adt] = serve_phase(
            args.seed, card, dev, adt,
            n_layers=SERVE_CUT_LAYERS if adt else 0)
    styles = {}
    for style in ("contiguous window", "contiguous packed", "paged window"):
        styles[style], launches[style] = serve_phase(
            args.seed, card, dev, "", style,
            n_layers=0 if style == "contiguous window" else SERVE_CUT_LAYERS)
    serve_fp32 = {style: serve_phase(args.seed, card, dev, "", style,
                                     "float32", SERVE_FP32_LAYERS)[0]
                  for style in STYLES}
    mark("serve")
    legacy = legacy_phase(args.seed, card, dev, serve["fp"],
                          styles["contiguous window"])
    legacy["fp32"] = legacy_fp32_checks(args.seed, dev)
    mark("legacy")
    parity = [parity_phase(args.seed, dev, adt) for adt in ("", "int8")]
    parity_contiguous = parity_contiguous_phase(args.seed, dev)
    mark("parity")
    from repro_torch.configs import get_config
    from repro_torch.runtime.mapper import ALL_PATHS, DEFAULT_PATHS, plan_cnn

    def planned(arch, paths):
        cfg = get_config(arch).replace(ovsf_mode="matrix")
        return plan_cnn(cfg, batch=8, hw="h100", paths=paths)
    cnns = [cnn_phase(args.seed, card, dev, arch, mode, n, plan, label)
            for arch, mode, n, plan, label in (
                ("resnet50", "matrix", 13, None, "none"),
                ("squeezenet1_1", "matrix", 6, None, "none"),
                ("resnet50", "", 0, None, "none"),
                ("resnet50", "matrix", 0, planned("resnet50", ALL_PATHS),
                 "ALL_PATHS"),
                ("squeezenet1_1", "matrix", 0,
                 planned("squeezenet1_1", ALL_PATHS), "ALL_PATHS"),
                ("resnet50", "matrix", 0, planned("resnet50", ("fused",)),
                 "fused"),
                ("squeezenet1_1", "matrix", 0,
                 planned("squeezenet1_1", ("fused",)), "fused"),
                ("resnet50", "matrix", 0, planned("resnet50", DEFAULT_PATHS),
                 "+".join(DEFAULT_PATHS)),
                ("squeezenet1_1", "matrix", 0,
                 planned("squeezenet1_1", DEFAULT_PATHS),
                 "+".join(DEFAULT_PATHS)))]
    mark("cnn")
    fused_r50 = next(c for c in cnns if c["arch"] == "resnet50"
                     and c["plan"] == "fused")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    calib = calibrate_phase(args.seed, card, dev, cnns, out_dir)
    mark("calibrate")
    chaos = chaos_phase(args.seed, card, dev, out_dir)
    mark("chaos")
    gateway = gateway_phase(args.seed, card, dev, out_dir,
                            styles["contiguous packed"]["decode_profile"])
    mark("gateway")
    qk = gateway["qwen_kernels"]
    moe_res = moe_phase(args.seed, card, dev)
    mark("moe")
    mk = moe_res["kernels"]
    ssm_res = ssm_phase(args.seed, card, dev)
    mark("ssm")
    sk = ssm_res["kernels"]
    ev_res = encdec_vlm_phase(args.seed, card, dev)
    mark("encdec_vlm")
    ek = ev_res["kernels"]
    wsp = ev_res[WHISPER_ARCH]
    lv = ev_res[LLAVA_ARCH]
    train = train_phase(args.seed, card, dev)
    mark("train")
    conv = convert_phase(args.seed, card, dev, conv_kernels)
    mark("convert")
    fam = family_train_phase(args.seed, card, dev)
    mark("family_train")
    quant = quant_train_phase(args.seed, card, dev)
    mark("quant_train")
    mat = materialize_phase(args.seed, card, dev,
                            serve["fp"]["decode_profile"])
    mark("materialize")
    fk = fam["kernels"]["summary"]
    qt = quant["kernels"]
    tk = train["kernels"]
    lm_train = {k: sum(r[k] for r in tk["lm"]) for k in
                ("ms", "forward_ms", "forward_bound_ms", "plain_ms",
                 "library_ms", "bound_ms")}
    lm_train["max_abs_err"] = max(r["max_abs_err"] for r in tk["lm"])
    lm_train["bound_by"] = max(tk["lm"], key=lambda r: r["bound_ms"])[
        "bound_by"]
    default_plan = "+".join(DEFAULT_PATHS)
    r50 = train["cnn"]["resnet50"]
    phase_s = {name: t - marks[i][1]
               for i, (name, t) in enumerate(marks[1:])}
    print("[timing] seconds a phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()),
          flush=True)
    star = ssm_res[STARCODER_ARCH]

    gemm_src = "src/repro_torch/kernels/csrc/ovsf_gemm.cu"
    dec_src = "src/repro_torch/kernels/csrc/ovsf_decompress.cu"
    kernels = []
    for name, source, replaces, s, n in (
            ("ovsf_gemm", gemm_src, "src/repro/kernels/ovsf_gemm.py:158",
             gemm[""][1], launches[""]["ovsf_gemm"]),
            ("ovsf_gemm_int8", gemm_src, "src/repro/kernels/ovsf_gemm.py:64",
             gemm["int8"][1], launches["int8"]["ovsf_gemm"]),
            ("ovsf_gemm_int4", gemm_src, "src/repro/kernels/ovsf_gemm.py:110",
             gemm["int4"][1], launches["int4"]["ovsf_gemm"]),
            ("paged_flash_decode",
             "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:160", attn_sum,
             launches[""]["paged_flash_decode"]),
            ("flash_decode_attn",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64", flash_sum,
             launches["contiguous window"]["flash_decode_attn"]),
            ("paged_flash_decode_int8kv",
             "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:160",
             int8_sums["paged_flash_decode"],
             legacy["int8"]["paged packed"]["launches"]["paged_flash_decode"]),
            ("flash_decode_attn_int8kv",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64",
             int8_sums["flash_decode_attn"],
             legacy["int8"]["legacy"]["launches"]["flash_decode_attn"]),
            ("ovsf_decompress",
             "src/repro_torch/kernels/csrc/ovsf_decompress.cu",
             "src/repro/kernels/ovsf_gemm.py:256", dec_sum,
             cnns[0]["launches"]["ovsf_decompress"]),
            ("fwht", "src/repro_torch/kernels/csrc/fwht.cu",
             "src/repro/kernels/fwht.py:57", fwht_sum,
             cnns[3]["launches"]["fwht"]),
            ("ovsf_gemm_fp32_mono", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", calib["fused_summary"],
             fused_r50["launches"]["ovsf_gemm"]),
            ("ovsf_gemm_qwen", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", qk["gemm_summary"],
             gateway["bf16"]["qw"]["launches"]["ovsf_gemm"]),
            ("flash_decode_attn_qwen",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64", qk["flash_summary"],
             gateway["bf16"]["qw"]["launches"]["flash_decode_attn"]),
            ("paged_flash_decode_olmoe",
             "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:160", mk["paged_summary"],
             moe_res["paged packed"]["launches"]["paged_flash_decode"]),
            ("flash_decode_attn_olmoe",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64", mk["flash_summary"],
             moe_res["legacy"]["launches"]["flash_decode_attn"]),
            ("ovsf_gemm_falcon_mamba", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158",
             sk["gemm"]["falcon_mamba_7b"],
             ssm_res["falcon_mamba_7b"]["serve"]["launches"]["ovsf_gemm"]),
            ("ovsf_gemm_zamba2", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", sk["gemm"]["zamba2_1_2b"],
             ssm_res["zamba2_1_2b"]["serve"]["launches"]["ovsf_gemm"]),
            ("flash_decode_attn_zamba2",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64",
             sk["flash"]["zamba2_1_2b"],
             ssm_res["zamba2_1_2b"]["serve"]["launches"]
             ["flash_decode_attn"]),
            ("ovsf_gemm_starcoder2", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", sk["gemm"][STARCODER_ARCH],
             star["paged packed"]["launches"]["ovsf_gemm"]),
            ("paged_flash_decode_starcoder2",
             "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:160", sk["paged_summary"],
             star["paged packed"]["launches"]["paged_flash_decode"]),
            ("flash_decode_attn_starcoder2",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64",
             sk["flash"][STARCODER_ARCH],
             star["legacy"]["launches"]["flash_decode_attn"]),
            ("ovsf_gemm_llava", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", ek["gemm"][4],
             lv["serve"]["launches"]["ovsf_gemm"]),
            ("paged_flash_decode_llava",
             "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:160", ek["paged"]["llava"],
             lv["serve"]["launches"]["paged_flash_decode"]),
            ("flash_decode_attn_llava",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64", ek["flash"]["llava"],
             lv["legacy"]["launches"]["flash_decode_attn"]),
            ("paged_flash_decode_whisper",
             "src/repro_torch/kernels/csrc/paged_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:160", ek["paged"]["whisper"],
             wsp["serve"]["launches"]["paged_flash_decode"]),
            ("flash_decode_attn_whisper",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64", ek["flash"]["whisper"],
             wsp["legacy"]["launches"]["flash_decode_attn"]
             - wsp["legacy"]["flash_unmasked"]),
            ("flash_decode_attn_whisper_cross",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64",
             ek["flash"]["whisper_cross"], wsp["legacy"]["flash_unmasked"]),
            ("flash_decode_attn_whisper_packed_cross",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64",
             ek["flash"]["whisper_packed_cross"],
             wsp["serve"]["flash_unmasked"]),
            ("ovsf_gemm_train", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", lm_train,
             train["launcher"]["fused_launches"]),
            ("ovsf_decompress_train",
             "src/repro_torch/kernels/csrc/ovsf_decompress.cu",
             "src/repro/kernels/ovsf_gemm.py:256", tk["cnn"]["materialize"],
             r50[default_plan]["launches"]["ovsf_decompress"]),
            ("ovsf_gemm_fp32_mono_train", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", tk["cnn"]["fused"],
             r50["fused"]["launches"]["ovsf_gemm"]),
            ("fwht_train", "src/repro_torch/kernels/csrc/fwht.cu",
             "src/repro/kernels/fwht.py:57", tk["cnn"]["spectral"],
             r50["ALL_PATHS"]["launches"]["fwht"]),
            ("ovsf_decompress_int8",
             "src/repro_torch/kernels/csrc/ovsf_decompress.cu",
             "src/repro/kernels/ovsf_gemm.py:256",
             conv["kernels"]["summary"]["int8"],
             conv["int8"]["launch_totals"]["ovsf_decompress"]),
            ("ovsf_decompress_int4",
             "src/repro_torch/kernels/csrc/ovsf_decompress.cu",
             "src/repro/kernels/ovsf_gemm.py:256",
             conv["kernels"]["summary"]["int4"],
             conv["int4"]["launch_totals"]["ovsf_decompress"]),
            ("ovsf_gemm_train_olmoe", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", fk["olmoe_1b_7b"],
             fam["cut"]["olmoe_1b_7b"]["fused_launches"]),
            ("ovsf_gemm_train_falcon_mamba", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", fk["falcon_mamba_7b"],
             fam["cut"]["falcon_mamba_7b"]["fused_launches"]),
            ("ovsf_gemm_train_zamba2", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", fk["zamba2_1_2b"],
             fam["launcher"]["fused_launches"]),
            ("ovsf_gemm_train_llava", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", fk["llava_next_34b"],
             fam["cut"]["llava_next_34b"]["fused_launches"]),
            ("ovsf_gemm_train_int8", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:64", qt["gemm"]["int8"],
             quant["full"]["ovsf_gemm"]),
            ("ovsf_gemm_train_int4", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:110", qt["gemm"]["int4"],
             quant["int4"]["ovsf_gemm"]),
            ("ovsf_decompress_train_int8",
             "src/repro_torch/kernels/csrc/ovsf_decompress.cu",
             "src/repro/kernels/ovsf_gemm.py:256", qt["decompress"]["int8"],
             quant["converted"]["int8"]["ovsf_decompress"]),
            ("ovsf_decompress_train_int4",
             "src/repro_torch/kernels/csrc/ovsf_decompress.cu",
             "src/repro/kernels/ovsf_gemm.py:256", qt["decompress"]["int4"],
             quant["converted"]["int4"]["ovsf_decompress"]),
            ("flash_decode_attn_whisper_stacked",
             "src/repro_torch/kernels/csrc/flash_decode_attn.cu",
             "src/repro/kernels/decode_attn.py:64",
             quant["flash"]["summary"],
             quant["whisper"]["bfloat16"]["counts"]["launches"]
             ["flash_decode_attn"]),
            ("ovsf_decompress_seg", dec_src,
             "src/repro/kernels/ovsf_gemm.py:256",
             seg_kernels["summary"]["bf16"],
             mat["bf16"]["launch_totals"]["ovsf_decompress"]),
            ("ovsf_decompress_seg_int8", dec_src,
             "src/repro/kernels/ovsf_gemm.py:256",
             seg_kernels["summary"]["int8"],
             mat["int8"]["launch_totals"]["ovsf_decompress"]),
            ("ovsf_decompress_seg_int4", dec_src,
             "src/repro/kernels/ovsf_gemm.py:256",
             seg_kernels["summary"]["int4"],
             mat["int4"]["launch_totals"]["ovsf_decompress"]),
            ("ovsf_decompress_seg_train", dec_src,
             "src/repro/kernels/ovsf_gemm.py:256",
             seg_kernels["summary"]["bf16"],
             train["launcher"]["launches"]["ovsf_decompress"]),
            ("ovsf_decompress_seg_train_int8", dec_src,
             "src/repro/kernels/ovsf_gemm.py:256",
             seg_kernels["summary"]["int8"],
             quant["full"]["ovsf_decompress"]),
            ("ovsf_decompress_seg_bank", dec_src,
             "src/repro/kernels/ovsf_gemm.py:256",
             seg_kernels["bank_summary"]["bf16"],
             moe_res["paged packed"]["launch_totals"]["ovsf_decompress"]),
            ("ovsf_gemm_fp32_cuda_core", gemm_src,
             "src/repro/kernels/ovsf_gemm.py:158", gemm[""][1]["fp32_M4"],
             serve_fp32["paged packed"]["launches"]["ovsf_gemm"])):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"],
                        "library_ms": s["library_ms"],
                        **{k: s[k] for k in ("forward_ms", "forward_bound_ms")
                           if k in s}})
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "kernels": kernels,
                   "ovsf_gemm_cases": {adt or "fp": rows for adt, (rows, _s)
                                       in gemm.items()},
                   "ovsf_gemm_layer_M128": {
                       adt or "fp": s["layer_M128"]
                       for adt, (_r, s) in gemm.items()},
                   "ovsf_gemm_layer_M256": {
                       adt or "fp": s["layer_M256"]
                       for adt, (_r, s) in gemm.items()},
                   "ovsf_gemm_layer_M1024": gemm[""][1]["layer_M1024"],
                   "attention_int8_kv_cases": int8_rows,
                   "paged_flash_decode_cases": attn_rows,
                   "flash_decode_attn_cases": flash_rows,
                   "attention_shape_checks": attn_shapes,
                   "packed_gather": flash_gathers,
                   "ovsf_decompress_cases": dec_rows,
                   "fwht_cases": fwht_rows,
                   "fwht_refuses": fwht_refused,
                   "ovsf_gemm_mono_cases": mono_rows,
                   "three_paths": three_paths,
                   "summary_rows": {
                       "ovsf_gemm*": "sum of q, o, gate, up, down at M=4 "
                                     "bf16 x",
                       "paged_flash_decode": "T=4 decode bf16",
                       "flash_decode_attn": "window decode B=4 T=320 bf16; "
                                            "launches: the contiguous window "
                                            "serve phase",
                       "paged_flash_decode_int8kv": "T=4 decode, bf16 q, "
                                                    "int8 K/V; launches: the "
                                                    "int8-cache paged packed "
                                                    "serve run",
                       "flash_decode_attn_int8kv": "window decode B=4 T=320,"
                                                   " bf16 q, int8 K/V; "
                                                   "launches: the int8-cache"
                                                   " legacy serve run",
                       "ovsf_decompress": "one ResNet-50 forward's 13 calls "
                                          "(4 x s1, 6 x s2, 3 x s3), fp32",
                       "fwht": "one planned ResNet-50 forward's 13 calls "
                               "(4 x (6272, 2048), 6 x (1568, 4096), 3 x "
                               "(392, 8192)), fp32",
                       "ovsf_gemm_fp32_mono": "the monolithic tensor-core "
                                              "kernel (fp32 x, monolithic "
                                              "codes) at ResNet-50's 13 "
                                              "OVSF convs' im2col GEMMs, "
                                              "batch 8, summed over the 13 "
                                              "(calibrate phase); bound: "
                                              "three bf16 products on the "
                                              "tensor cores + one WHT a "
                                              "column, or the bytes; "
                                              "launches: one all-fused "
                                              "ResNet-50 forward",
                       "ovsf_gemm_qwen": "qwen2_5_14b's seven OVSF "
                                         "projections (q, k, v, o, gate, "
                                         "up, down) at M=4, bf16 x and "
                                         "alphas, summed; launches: the qw "
                                         "engine of the phase 9 gateway run",
                       "flash_decode_attn_qwen": "window decode B=4 H=40 "
                                                 "Hkv=8 hd=128 T=128 bf16; "
                                                 "launches: the qw engine of "
                                                 "the phase 9 gateway run",
                       "paged_flash_decode_olmoe": "T=4 decode H=16 Hkv=16 "
                                                   "hd=128 bf16; launches: "
                                                   "the phase 10 paged "
                                                   "packed run (replayed)",
                       "flash_decode_attn_olmoe": "window decode B=4 H=16 "
                                                  "Hkv=16 hd=128 T=128 bf16;"
                                                  " launches: the phase 10 "
                                                  "legacy run (replayed)",
                       "ovsf_gemm_falcon_mamba": "falcon_mamba_7b's in/out "
                                                 "projections (4096->16384, "
                                                 "8192->4096) at M=4 bf16, "
                                                 "summed; launches: the "
                                                 "phase 11 legacy run "
                                                 "(replayed)",
                       "ovsf_gemm_zamba2": "zamba2_1_2b's Mamba-2 in/out "
                                           "projections (2048->8384, "
                                           "4096->2048) and its shared "
                                           "block's seven at M=4 bf16, "
                                           "summed; launches: the phase 11 "
                                           "legacy run (replayed)",
                       "flash_decode_attn_zamba2": "window decode B=4 H=32 "
                                                   "Hkv=32 hd=64 T=128 bf16;"
                                                   " launches: the phase 11 "
                                                   "legacy run (replayed)",
                       "ovsf_gemm_starcoder2": "starcoder2_15b's six OVSF "
                                               "projections (q, k, v, o, "
                                               "up, down) at M=4 bf16, "
                                               "summed; launches: its "
                                               "2-layer paged packed run",
                       "paged_flash_decode_starcoder2": "T=4 decode H=48 "
                                                        "Hkv=4 hd=128 bf16; "
                                                        "launches: its "
                                                        "2-layer paged "
                                                        "packed run",
                       "flash_decode_attn_starcoder2": "window decode B=4 "
                                                       "H=48 Hkv=4 hd=128 "
                                                       "T=128 bf16; launches:"
                                                       " its 2-layer legacy "
                                                       "run",
                       "ovsf_gemm_llava": "llava_next_34b's seven OVSF "
                                          "projections (q, o 7168 -> 7168; "
                                          "k, v -> 1024; gate, up -> 20480;"
                                          " down 20480 -> 7168) at M=4 "
                                          "bf16, summed; launches: its "
                                          "paged packed run (phase 12)",
                       "paged_flash_decode_llava": "T=4 decode H=56 Hkv=8 "
                                                   "hd=128 bf16; launches: "
                                                   "llava's paged packed run",
                       "flash_decode_attn_llava": "window decode B=4 H=56 "
                                                  "Hkv=8 hd=128 T=128 bf16; "
                                                  "launches: llava's legacy "
                                                  "run",
                       "paged_flash_decode_whisper": "T=4 decode H=6 Hkv=6 "
                                                     "hd=64 bf16; launches: "
                                                     "whisper's paged packed"
                                                     " run (self attention)",
                       "flash_decode_attn_whisper": "window decode B=4 H=6 "
                                                    "Hkv=6 hd=64 T=128 bf16;"
                                                    " launches: whisper's "
                                                    "legacy run, its self "
                                                    "reads (all less the "
                                                    "unmasked ones)",
                       "flash_decode_attn_whisper_cross": "cross read B=4 "
                                                          "T=1500, pos 1500 "
                                                          "on every row, "
                                                          "bf16; launches: "
                                                          "whisper's legacy "
                                                          "run, its cross "
                                                          "reads (unmasked "
                                                          "launches)",
                       "flash_decode_attn_whisper_packed_cross":
                           "cross read of a packed step's 128 tokens, each "
                           "over its slot's gathered 1500 rows, bf16; "
                           "launches: whisper's paged packed run, its "
                           "cross reads (unmasked launches: all of its "
                           "flash_decode_attn)",
                       "ovsf_gemm_train": "TinyLlama-1.1B's five OVSF "
                                          "projections at M=1024 bf16, "
                                          "forward + backward (the "
                                          "backward's fp32 products and "
                                          "per-segment WHT beside the "
                                          "kernel), summed; forward_ms: "
                                          "the kernel's forward alone, "
                                          "forward_bound_ms its bound; "
                                          "library: "
                                          "matmul forward + backward on a "
                                          "dense W; launches: the step "
                                          "under a fused plan after the "
                                          "launcher's 12 (phase 13)",
                       "ovsf_decompress_train": "ResNet-50's 13 OVSF conv "
                                                "GEMMs at batch 8 under "
                                                "materialize, forward + "
                                                "backward (decompress, "
                                                "matmuls, fwht for dA), "
                                                "summed; launches: one "
                                                "train step under the "
                                                "default plan",
                       "ovsf_gemm_fp32_mono_train": "the same under fused "
                                                    "(the monolithic "
                                                    "kernel; decompress "
                                                    "for dx, fwht for "
                                                    "dA); launches: one "
                                                    "train step, all "
                                                    "fused",
                       "fwht_train": "the same under spectral (fwht "
                                     "forward and for d pad(x)); "
                                     "launches: one train step under "
                                     "ALL_PATHS",
                       "ovsf_decompress_int8": "the int8 epilogue at one "
                                               "converted TinyLlama-1.1B "
                                               "layer's five W (q, o "
                                               "2048 -> 2048, gate, up -> "
                                               "5632, down 5632 (L 8192) "
                                               "-> 2048), fp32 W, summed; "
                                               "launches: the converted "
                                               "int8 model's replayed "
                                               "paged packed run, 22 "
                                               "layers (phase 14)",
                       "ovsf_decompress_int4": "the same, packed int4; "
                                               "launches: the int4 run at "
                                               "6 layers (phase 14)",
                       "ovsf_gemm_train_*": "a family's OVSF projections "
                                            "of one layer at M=1024 bf16, "
                                            "forward + backward, summed "
                                            "(FAMILY_TRAIN_GEMMS: OLMoE's "
                                            "q, k, v, o; Falcon-Mamba's "
                                            "in / out; a Zamba2 Mamba-2 "
                                            "block's in / out and its "
                                            "shared block's seven; "
                                            "LLaVA's seven); launches: "
                                            "phase 15's steps under a "
                                            "fused plan (Zamba2: one after"
                                            " launch.train at 38 layers; "
                                            "the others one after their "
                                            "runs at FAMILY_LAYERS)",
                       "ovsf_gemm_train_int8": "OvsfGemmFn over int8 alphas "
                                               "(the tensor-core kernel's "
                                               "QUANT 1 epilogue forward, "
                                               "d scale and dx as plain "
                                               "code and fp32 products) at "
                                               "TinyLlama-1.1B's five "
                                               "projections, M=1024 bf16, "
                                               "forward + backward summed; "
                                               "library: matmul forward + "
                                               "backward on the dequantised "
                                               "dense W; launches: a step "
                                               "under a fused plan after "
                                               "the full-width int8 run "
                                               "(phase 16)",
                       "ovsf_gemm_train_int4": "the same over packed int4 "
                                               "(QUANT 2); launches: a "
                                               "fused step after the int4 "
                                               "run at 4 layers",
                       "ovsf_decompress_train_int*": "OvsfDecompressFn over "
                                                     "int8 / int4 alphas "
                                                     "(monolithic codes, a "
                                                     "converted TinyLlama "
                                                     "layer's five W), "
                                                     "forward + backward "
                                                     "(the fwht kernel for "
                                                     "dA, reduced to d "
                                                     "scale), summed; "
                                                     "library: matmul S^T A"
                                                     " forward + backward; "
                                                     "launches: the "
                                                     "converted model's "
                                                     "train steps under "
                                                     "materialize",
                       "flash_decode_attn_whisper_stacked":
                           "a chunk-free packed step of the stacked "
                           "Whisper-tiny pair: the self read (B=4, T=256) "
                           "and the cross read (B=4, T=1500, every row) "
                           "summed, bf16; launches: the bf16 stacked "
                           "gateway run (phase 16)",
                       "ovsf_decompress_seg*": "the segmented kernel at "
                                               "TinyLlama-1.1B's five W "
                                               "(L0 16, 8 kept a segment), "
                                               "bf16 / int8 / int4 alphas "
                                               "(W bf16 / fp32 / fp32), "
                                               "summed; library: bmm of "
                                               "prebuilt signs by the "
                                               "alphas; launches: phase "
                                               "17's unplanned serve runs "
                                               "(bf16 and int8 at 22 "
                                               "layers, int4 at 6); _train:"
                                               " the launcher's 12 steps "
                                               "(phase 13), _train_int8: "
                                               "the int8 supervisor run "
                                               "(phase 16), both under "
                                               "materialize",
                       "ovsf_decompress_seg_bank": "the segmented kernel over"
                                                   " OLMoE-1B-7B's three "
                                                   "expert banks of a layer "
                                                   "(64 experts; gate, up "
                                                   "2048 -> 1024, down 1024 "
                                                   "-> 2048), bf16, one "
                                                   "launch a bank, summed; "
                                                   "library: bmm over the "
                                                   "batch; launches: phase "
                                                   "10's replayed paged "
                                                   "packed run (3 a layer a "
                                                   "step)",
                       "ovsf_gemm_fp32_cuda_core": "the CUDA-core kernel "
                                                   "(fp32 x over segmented "
                                                   "codes) at TinyLlama-"
                                                   "1.1B's five projections, "
                                                   "M=4 fp32, summed; "
                                                   "launches: the fp32 paged"
                                                   " packed serve run "
                                                   "(SERVE_FP32_LAYERS "
                                                   "layers)"},
                   "quant_wrapper_refuses": refused,
                   "serve": serve, "serve_styles": styles,
                   "serve_fp32": serve_fp32, "legacy": legacy,
                   "parity": parity, "parity_contiguous": parity_contiguous,
                   "cnn": cnns, "calibration": calib, "chaos": chaos,
                   "gateway": gateway, "moe": moe_res, "ssm": ssm_res,
                   "encdec_vlm": ev_res, "train": train,
                   "convert": conv, "family_train": fam,
                   "quant_train": quant, "seg_decompress": seg_kernels,
                   "ovsf_gemm_fp32_cuda_core": {
                       k: gemm[""][1][k] for k in ("fp32_M4", "fp32_M64")},
                   "materialize": mat, "phase_s": phase_s}, f, indent=1)
    print(f"[chip_smoke] every phase passed; the whole run took "
          f"{time.perf_counter() - t_run:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
