"""EngineCore: the KV cache, the step styles and the fused sampling tail
(port of ``repro.serving.core``).

``step(SchedulerOutput) -> StepOutput`` runs one scheduler iteration as ONE
model call in the engine's style (legacy mode: one call per prefill group,
then one decode), then samples on the device: argmax for greedy slots,
top-k / temperature draws for sampled ones, plus a per-slot
``ok = all(isfinite(logits))`` row. The styles, as the reference's:

* **contiguous window** (``packed=False, paged=False``): per-slot K/V
  buffers of ``buffer_len + window`` (the slack keeps a W-wide write at a
  live slot's position from clamping). A step that carries chunks runs
  ``serve_step_window`` on a (B, W) window, W the chunk size; a chunk-free
  step runs ``serve_step`` and advances EVERY slot one token, idle ones
  too, as the reference's vmapped decode does (their writes clamp in
  bounds; a fresh slot's pos is reset to 0 when its first chunk arrives).
* **contiguous packed** (``packed=True``): the same cache without slack;
  the scheduler's tokens flattened into one pow-2-bucketed stream
  (``scheduler.pack_step``) through ``serve_step_packed``.
* **paged packed / paged window** (``paged=True``): K/V in shared page
  pools; the packed stream through ``serve_step_paged``, or the (B, W)
  window through ``serve_step_window_paged`` at W = the chunk size on every
  step. The engine grants pages before calling ``step``
  (``LLMEngine._page_gate``).
* **multi-model** (``variants=M``): the params' alpha leaves carry a
  leading (M, ...) variant axis and each slot serves the variant of its
  entry in ``model_ids`` (B,), the gateway's same-architecture batching
  (``serving.gateway``). The contiguous cache without slack; a packed
  core runs ``serve_step_packed_multi``, a window core
  ``serve_step_window_multi`` at W = the chunk size when the step carries
  chunks and W = 1 when it does not (recorded as ``("decode", 1)``, so a
  multi engine runs the two step shapes of a single-model window engine).
  ``model_ids`` is an input of every step, copied into the key's static
  buffer before each replay, so routing a slot to another variant never
  captures again. The paged cache and the legacy path refuse variants, as
  the reference's core does.
* **legacy phase-based** (``window=0``, neither packed nor paged): per-slot
  buffers of ``buffer_len``. Each prefill group runs first: its prompts,
  right-padded to the bucket Lb, in ONE (B, Lb) ``serve_prefill_ragged``
  call over every slot row (idle rows are dummies) into a fresh cache of
  its own, only Lb columns deep, so no running slot's K/V is touched; each
  group row is then copied into its slot's first Lb columns, the columns
  past them zeroed (the reference's fresh full-depth cache holds zeros
  there), with ``pos`` re-based to the true prompt length. ``exact``
  groups prefill each prompt alone at its native length
  (``serve_prefill``), into a cache as deep as the prompt. Then, when any
  slot decodes, the all-slot ``serve_step``: it advances EVERY slot, a
  slot prefilled in this very step too, whose cache then holds token 0 at
  its prompt length before its first token is decoded (a defect of the
  reference's legacy engine, copied for parity; for the recurrent
  families token 0 enters the new request's state and changes its
  stream, as in the reference). The SSM and hybrid families have no
  padded prefill (``supports_bucketing`` is False): every group is exact,
  and a slot adopts the prefill's ``conv`` / ``ssm`` states with its
  K/V. ``prefill_compiles`` counts the distinct prefill
  keys run on this core, as the reference counts its prefill traces.

The encoder-decoder's cross caches (``xk`` / ``xv``, per slot in every
style, the paged one included) are read by every step and written by
none: the engine passes tokens only, as the reference's does, so no
request brings frames and the cross caches stay as ``init_cache`` /
``init_paged_cache`` made them, zero (the prefill bodies leave them out of
their outputs, so a captured bucket holds no Te-deep copy); cross
attention over them adds 0. A VLM is served as its text-only dense stack.

On the card every step replays a CUDA graph, one per step shape, under the
keys ``step_shapes`` records (``("packed", T)``, ``("window", W)``,
``("decode", 1)``), as the reference traces one ``jax.jit`` per shape
(``runtime.graphs.StepGraphs``; the first step of a shape runs eagerly and
captures it); a bucketed prefill replays one per ``("prefill", Lb)``
bucket, whose fresh (B, Lb) cache is a static output of the graph (it lives
in the graph's pool as long as the graph: the buckets' graphs together hold
about two B-row caches of the buffer's depth). The buckets' graphs share
one pool (``pool="prefill"``), so their temporaries take about the largest
bucket's room, not the sum: each bucket's cache is adopted and its logits
read before the next replay can overwrite them. An exact prefill runs
eagerly: one graph per distinct prompt length, each holding its own pool,
would grow with the traffic up to ``buffer_len`` graphs. The step's
inputs reach the key's static buffers from pinned host staging; the
caches stay at their addresses (K/V written in place,
``pos`` by ``copy_``). The graph ends with the fp32 logits, their finite-row
flags and argmax; after the replay one device-to-host copy reads flags and
argmax, and the sampled slots draw eagerly. ``capture=False`` runs the same
step bodies eagerly through the same buffers (for comparison; the launcher
does not expose it), as does every step on the CPU.

Sampling keys: the draw of a request's t-th emitted token is a pure
function of ``(SamplingParams.seed, t)``. Each sampled slot holds the
reference's threefry key on the host (``serving.journal``: a numpy port of
``jax.random.PRNGKey`` and ``split``), set at admission to ``key_after(seed,
tokens already emitted)`` and split once per emitted token, as the
reference's keys are; the draw's subkey seeds one ``torch.Generator`` on the
device. So a stream does not depend on batch composition, slot placement,
chunking or step style, and resumes exactly after a preemption, a watchdog
recovery or a process restart, with no key state to stash. The categorical
draw itself is torch's: greedy streams match the reference, sampled streams
match only within the port.

Faults (``runtime.faults.FaultPlan``), keyed on ``step_idx``, which
advances before the fault applies (the engine carries it across a rebuild,
so a step-pinned fault fires once a run): ``fail``, ``delay`` and ``die``
apply at the top of ``step``, before any device work; ``nan`` rides the
(B,) fp32 ``poison`` input of every step key (zeros unless a fault fires),
added to the logits inside the step body before their finite-row flags, so
a poisoned step replays the graph its shape already has and never captures
another. As in the reference, the poison reaches only the steps: a legacy
prefill's finite-row flags are those of its own logits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.graphs import StepGraphs
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.journal import key_after, prng_key, split
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.scheduler import SchedulerOutput, pack_step

# padded batched prefill is exact only for the KV-cache families (the
# reference's tuple)
_BUCKETED_FAMILIES = ("dense", "moe", "vlm", "encdec")


def _head(lg: torch.Tensor) -> tuple:
    """(B, V) fp32 logits and one (2, B) tensor of their argmax and
    finite-row flags (``isfinite(logits).all(-1)``), a step's single host
    read."""
    toks = torch.argmax(lg, dim=-1)
    ok = torch.isfinite(lg).all(dim=-1)
    return lg, torch.stack([toks, ok.to(toks.dtype)])


def sample_token(logits: torch.Tensor, temperature: float, top_k: int,
                 gen: torch.Generator) -> torch.Tensor:
    """One token from (V,) fp32 logits: logits below the k-th largest are
    masked (k == 0: no filter), then a temperature-scaled categorical draw."""
    V = logits.shape[-1]
    k = top_k if 0 < top_k < V else V
    thresh = torch.topk(logits, k).values[-1]
    filt = torch.where(logits >= thresh, logits,
                       torch.full_like(logits, float("-inf")))
    probs = torch.softmax(filt / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[0]


@dataclasses.dataclass
class StepOutput:
    """Result of one ``EngineCore.step``: sampled tokens + timing samples.

    ``first_tokens`` maps slot -> the first token of a request whose prompt
    completed this step; ``decode_tokens`` maps slot -> the next token of a
    decoding slot; ``bad_slots`` emitted non-finite logits (token withheld).
    """
    first_tokens: dict = dataclasses.field(default_factory=dict)
    decode_tokens: dict = dataclasses.field(default_factory=dict)
    bad_slots: tuple = ()
    prefill_s: float = 0.0      # legacy prefill groups' wall time
    decode_s: float = 0.0       # chunk-free (pure decode) step wall time
    mixed_s: float = 0.0        # step carrying prompt chunks
    n_valid_tokens: int = 0     # tokens that were real work this step
    n_batch_tokens: int = 0     # tokens the device batch carried


class EngineCore:
    """Device-side half of the engine: caches, the step styles, sampling."""

    def __init__(self, params, cfg: ModelConfig, *, batch_slots: int,
                 buffer_len: int, window: int, packed: bool, paged: bool,
                 page_size: int, kv_pages: Optional[int],
                 device: torch.device, capture: bool = True,
                 faults: Optional[FaultPlan] = None, variants: int = 0):
        if window <= 0 and (packed or paged):
            raise ValueError("packed and paged serving consume prompts via "
                             "chunks; pass a chunk size")
        if variants:
            if paged:
                raise NotImplementedError(
                    "multi-model variants over the paged KV cache are not "
                    "supported yet (page-table routing per variant)")
            if window <= 0:
                raise ValueError(
                    "multi-model serving consumes prompts via chunks; pass "
                    "a chunked window (chunk_size)")
        self.variants = variants
        self.graphs = StepGraphs(device, capture)
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.T = buffer_len
        self.window = window
        self.packed = packed
        self.paged = paged
        self.device = device
        self.faults = faults
        # monotone step counter driving the fault plan
        self.step_idx = 0
        self._zero_poison = np.zeros(batch_slots, np.float32)
        # the window's slack: a W-wide write at pos <= buffer_len - 1 never
        # clamps; packed, paged and multi-model steps scatter at exact
        # positions
        self.T_alloc = (buffer_len if (packed or paged or variants)
                        else buffer_len + window)
        # each slot's stacked-alpha variant (multi-model cores)
        self.model_ids = np.zeros(batch_slots, np.int32)
        self.step_shapes: set = set()   # distinct step shapes run
        self.prefill_compiles = 0       # distinct prefill keys run here
        self._prefill_keys: set = set()
        self.pager: Optional[PagedKVCache] = None
        if paged:
            if buffer_len % page_size:
                raise ValueError(f"buffer_len={buffer_len} must be a multiple "
                                 f"of page_size={page_size} (pages tile the "
                                 f"virtual slot buffer exactly)")
            max_pages = buffer_len // page_size
            n_pages = (int(kv_pages) if kv_pages is not None
                       else batch_slots * max_pages)
            page_bytes = (2 * cfg.n_layers * page_size * cfg.n_kv_heads
                          * cfg.hd * cfg.kv_dtype.itemsize)
            self.pager = PagedKVCache(batch_slots, page_size, n_pages,
                                      max_pages, page_bytes)
            self.caches = R.init_paged_cache(cfg, batch_slots, page_size,
                                             n_pages, device)
            self.caches["pos"] = torch.zeros((batch_slots,),
                                             dtype=torch.int32, device=device)
        else:
            self.caches = R.init_cache(cfg, batch_slots, self.T_alloc, device)
        # host mirror of the per-slot fill levels (``pos`` on the device)
        self._host_pos = np.zeros(batch_slots, np.int64)
        self.temps = np.zeros(batch_slots, np.float32)
        self.topks = np.zeros(batch_slots, np.int32)
        self.greedy = np.ones(batch_slots, bool)
        self.keys = np.zeros((batch_slots, 2), np.uint32)   # threefry keys
        self._gen = torch.Generator(device=device)      # reseeded per draw
        self.logits: Optional[torch.Tensor] = None   # last step's, fp32
        # the per-slot cache leaves a legacy prefill fills and a slot adopts
        self._leaves = tuple(n for n in ("k", "v", "conv", "ssm")
                             if n in self.caches)

    @property
    def supports_bucketing(self) -> bool:
        """Padded batched prefill is exact only for KV-cache families."""
        return self.cfg.family in _BUCKETED_FAMILIES

    # a graph holds the addresses of the params and of the plan's choices:
    # replacing either drops every graph
    @property
    def params(self):
        return self._params

    @params.setter
    def params(self, params) -> None:
        self.graphs.clear()
        self._params = params

    @property
    def cfg(self) -> ModelConfig:
        return self._cfg

    @cfg.setter
    def cfg(self, cfg: ModelConfig) -> None:
        self.graphs.clear()
        self._cfg = cfg

    def close(self) -> None:
        """Free the device state: the caches, and every graph with its
        static buffers and memory pool (a rebuilt core must never replay a
        graph against another core's caches)."""
        self.caches = None
        self.logits = None
        self.graphs.clear()

    def _set_sampling(self, i: int, sp: SamplingParams, n_emitted: int
                      ) -> None:
        """Seed slot ``i`` for a request that has already emitted
        ``n_emitted`` tokens (non-zero after a preemption or a restart)."""
        self.temps[i] = max(sp.temperature, 0.0)
        self.topks[i] = sp.top_k
        self.greedy[i] = sp.greedy
        self.keys[i] = (key_after(sp.seed, n_emitted) if n_emitted
                        else prng_key(sp.seed))

    def clear_sampling(self, i: int) -> None:
        """Reset a freed slot to greedy (the next request re-seeds)."""
        self.temps[i] = 0.0
        self.topks[i] = 0
        self.greedy[i] = True

    def _health(self, logits: torch.Tensor, new_cache: dict,
                poison: torch.Tensor) -> tuple:
        """The end of every step body: ``pos`` copied into the engine's own
        tensor, then the (B, V) fp32 logits plus the (B,) ``poison`` and
        their ``_head``."""
        self.caches["pos"].copy_(new_cache["pos"])
        return _head(logits.to(torch.float32) + poison[:, None])

    def _sample(self, lg: torch.Tensor, head: torch.Tensor, emit_slots: tuple
                ) -> tuple[np.ndarray, np.ndarray]:
        """((B,) tokens, (B,) finite-logits flags) on the host: one read of
        ``head``; then each emitting sampled slot with finite logits splits
        its key (advanced only then), draws with the generator seeded from
        the subkey, and the draws are read once more."""
        self.logits = lg
        host = head.cpu().numpy()
        toks, ok = host[0].copy(), host[1].astype(bool)
        draw = [i for i in emit_slots if not self.greedy[i] and ok[i]]
        picks = []
        for i in draw:
            self.keys[i], sub = split(self.keys[i])
            # the generator's seed and offset are read at the launch, so
            # reseeding it for the next slot leaves this draw alone
            self._gen.manual_seed(int(sub[0]) << 32 | int(sub[1]))
            picks.append(sample_token(lg[i], float(self.temps[i]),
                                      int(self.topks[i]), self._gen))
        if picks:
            toks[draw] = torch.stack(picks).cpu().numpy()
        return toks, ok

    @torch.no_grad()
    def step(self, so: SchedulerOutput,
             last_tokens: Optional[np.ndarray] = None) -> StepOutput:
        """Execute one scheduler iteration as ONE model call in the engine's
        style; legacy mode runs the prefill groups first. ``last_tokens``
        carries each decode slot's previous token at its slot index. The
        fault plan's step ``step_idx`` applies first."""
        out = StepOutput()
        idx = self.step_idx
        self.step_idx += 1
        poison = self._zero_poison
        if self.faults:
            self.faults.raise_or_delay(idx)
            row = self.faults.poison_row(idx, self.B)
            if row is not None:
                poison = row
        bad: list = []
        if so.prefill_groups:
            if self.window:
                raise ValueError("a chunked core serves prompts via chunks "
                                 "only; a legacy scheduler emitted "
                                 "prefill_groups")
            self._prefill_groups(so.prefill_groups, out, bad)
        if not (so.chunks or so.decode_slots):
            out.bad_slots = tuple(bad)
            return out
        t0 = time.perf_counter()
        for c in so.chunks:
            if c.start == 0:            # new request: seed sampling state
                self._set_sampling(c.slot, c.req.sampling,
                                   len(c.req.out_tokens))
        run = (self._packed_step if self.packed
               else self._window_step if self.paged or so.chunks
               or self.variants else self._decode_step)
        (lg, head), emit, n_valid, n_batch = run(so, last_tokens, poison)
        toks, ok = self._sample(lg, head, emit)
        for i in so.decode_slots:
            if ok[i]:
                out.decode_tokens[i] = int(toks[i])
            else:
                bad.append(i)
        for c in so.chunks:
            if c.last:
                if ok[c.slot]:
                    out.first_tokens[c.slot] = int(toks[c.slot])
                else:
                    bad.append(c.slot)
        out.bad_slots = tuple(bad)
        out.n_valid_tokens += n_valid
        out.n_batch_tokens += n_batch
        dt = time.perf_counter() - t0
        if so.chunks:
            out.mixed_s = dt
        else:
            out.decode_s = dt
        return out

    def _packed_step(self, so: SchedulerOutput, last_tokens, poison):
        """Every valid token in one pow-2-bucketed stream, against the page
        pools (paged) or the contiguous cache."""
        ps = pack_step(so, last_tokens, self._host_pos, self.B, self.window)
        key = ("packed", ps.n_batch)
        self.step_shapes.add(key)
        inputs = dict(tokens=ps.tokens, slot_ids=ps.slot_ids,
                      positions=ps.positions, new_pos=ps.new_pos,
                      emit_idx=ps.emit_idx, poison=poison)
        if self.paged:
            inputs["page_table"] = self.pager.page_table
        if self.variants:
            inputs["model_ids"] = self.model_ids
        out = self.graphs.run(key, inputs, self._packed_body)
        self._host_pos[:] = ps.new_pos
        return out, ps.emit_slots, ps.n_valid, ps.n_batch

    def _packed_body(self, a: dict) -> tuple:
        args = (a["tokens"], a["slot_ids"], a["positions"], a["new_pos"],
                a["emit_idx"])
        if self.paged:
            logits, new = R.serve_step_paged(self.params, self.cfg,
                                             self.caches, a["page_table"],
                                             *args)
        elif self.variants:
            logits, new = R.serve_step_packed_multi(
                self.params, self.cfg, self.caches, *args, a["model_ids"])
        else:
            logits, new = R.serve_step_packed(self.params, self.cfg,
                                              self.caches, *args)
        return self._health(logits, new, a["poison"])

    def _window_step(self, so: SchedulerOutput, last_tokens, poison):
        """One (B, W) ragged window, W the chunk size: decode slots ride at
        width 1, chunk slots at their slice length, idle slots at 0. A
        multi-model core routes each slot by ``model_ids`` and runs a
        chunk-free step at W = 1 (the single-model window engine's
        ``("decode", 1)`` shape)."""
        chunked = bool(so.chunks) or not self.variants
        W = self.window if chunked else 1
        tokens = np.zeros((self.B, W), np.int32)
        n_tok = np.zeros(self.B, np.int32)
        for i in so.decode_slots:
            tokens[i, 0] = last_tokens[i]
            n_tok[i] = 1
        fresh = []
        for c in so.chunks:
            tokens[c.slot, :c.length] = c.req.prompt[c.start:c.start
                                                     + c.length]
            n_tok[c.slot] = c.length
            if c.start == 0:            # new request: its pos starts at 0
                fresh.append(c.slot)
        if fresh:
            self.caches["pos"][fresh] = 0
            self._host_pos[fresh] = 0
        key = ("window", W) if chunked else ("decode", 1)
        self.step_shapes.add(key)
        inputs = dict(tokens=tokens, n_tok=n_tok, poison=poison)
        if self.paged:
            inputs["page_table"] = self.pager.page_table
        if self.variants:
            inputs["model_ids"] = self.model_ids
        out = self.graphs.run(key, inputs, self._window_body)
        self._host_pos += n_tok
        emit = tuple(so.decode_slots) + tuple(c.slot for c in so.chunks
                                              if c.last)
        return out, emit, int(n_tok.sum()), self.B * W

    def _window_body(self, a: dict) -> tuple:
        if self.variants:
            logits, new = R.serve_step_window_multi(
                self.params, self.cfg, self.caches, a["tokens"], a["n_tok"],
                a["model_ids"])
        elif self.paged:
            logits, new = R.serve_step_window_paged(
                self.params, self.cfg, self.caches, a["page_table"],
                a["tokens"], a["n_tok"])
        else:
            logits, new = R.serve_step_window(self.params, self.cfg,
                                              self.caches, a["tokens"],
                                              a["n_tok"])
        return self._health(logits, new, a["poison"])

    def _decode_step(self, so: SchedulerOutput, last_tokens, poison):
        """A chunk-free step of the contiguous window style or a legacy
        decode: every slot advances one token (idle ones, and in legacy
        mode slots prefilled this step, too, as the reference's vmap
        does)."""
        last = np.zeros((self.B, 1), np.int32)
        for i in so.decode_slots:
            last[i, 0] = last_tokens[i]
        key = ("decode", 1)
        self.step_shapes.add(key)
        out = self.graphs.run(key, dict(tokens=last, poison=poison),
                              self._decode_body)
        self._host_pos += 1
        return out, tuple(so.decode_slots), len(so.decode_slots), self.B

    def _decode_body(self, a: dict) -> tuple:
        logits, new = R.serve_step(self.params, self.cfg, self.caches,
                                   a["tokens"])
        return self._health(logits, new, a["poison"])

    # -- legacy mode: prefill groups ----------------------------------------

    def _prefill_groups(self, groups: tuple, out: StepOutput, bad: list
                        ) -> None:
        """Every group of the step, bucketed or exact: first tokens (or the
        slot in ``bad`` when its logits are not finite), wall time and
        token counts into ``out``."""
        for pg in groups:
            t0 = time.perf_counter()
            if pg.exact:
                for i, req in pg.slot_reqs:
                    toks, ok = self.prefill_one(i, req)
                    if ok[i]:
                        out.first_tokens[i] = int(toks[i])
                    else:
                        bad.append(i)
                out.n_batch_tokens += sum(r.prompt_len
                                          for _i, r in pg.slot_reqs)
            else:
                toks, ok = self.prefill_group(pg.slot_reqs, pg.bucket)
                for i, _req in pg.slot_reqs:
                    if ok[i]:
                        out.first_tokens[i] = int(toks[i])
                    else:
                        bad.append(i)
                out.n_batch_tokens += self.B * min(pg.bucket, self.T)
            out.prefill_s += time.perf_counter() - t0
            out.n_valid_tokens += sum(r.prompt_len for _i, r in pg.slot_reqs)

    def _prefill_key(self, key: tuple) -> tuple:
        if key not in self._prefill_keys:
            self._prefill_keys.add(key)
            self.prefill_compiles += 1
        return key

    def prefill_group(self, slot_reqs, bucket: int) -> tuple:
        """Prefill same-bucket requests in ONE (B, Lb) call, each request's
        row at its slot index (the other rows are dummies of length 1).
        Returns ((B,) first tokens, (B,) finite-logits flags); only the
        group's rows mean anything."""
        Lb = min(bucket, self.T)
        tokens = np.zeros((self.B, Lb), np.int32)
        lengths = np.ones(self.B, np.int32)
        for i, req in slot_reqs:
            tokens[i, :req.prompt_len] = req.prompt
            lengths[i] = req.prompt_len
            self._set_sampling(i, req.sampling, len(req.out_tokens))
        lg, head, *leaves = self.graphs.run(
            self._prefill_key(("prefill", Lb)),
            dict(tokens=tokens, lengths=lengths), self._prefill_body,
            pool="prefill")
        for i, req in slot_reqs:
            self._adopt_row(i, leaves, i, req.prompt_len)
        return self._sample(lg, head, tuple(i for i, _r in slot_reqs))

    def prefill_one(self, slot: int, req) -> tuple:
        """Exact prefill of one request at its native prompt length, into
        ``slot``. Returns ((B,) first tokens, (B,) finite-logits flags), the
        one row's broadcast over every slot as the reference samples it;
        only ``slot`` means anything."""
        self._set_sampling(slot, req.sampling, len(req.out_tokens))
        self._prefill_key(("prefill_exact", req.prompt_len))
        tokens = torch.from_numpy(np.asarray(req.prompt, np.int32)[None])
        lg, head, *leaves = self._prefill_exact_body(
            dict(tokens=tokens.to(self.device)))
        self._adopt_row(slot, leaves, 0, req.prompt_len)
        return self._sample(lg, head, (slot,))

    def _prefill_body(self, a: dict) -> tuple:
        tokens = a["tokens"]
        logits, cache = R.serve_prefill_ragged(self.params, self.cfg, tokens,
                                               tokens.shape[1], a["lengths"])
        return (*_head(logits.to(torch.float32)),
                *(cache[n] for n in self._leaves))

    def _prefill_exact_body(self, a: dict) -> tuple:
        tokens = a["tokens"]
        logits, cache = R.serve_prefill(self.params, self.cfg, tokens,
                                        tokens.shape[1])
        return (*_head(logits.to(torch.float32).expand(self.B, -1)),
                *(cache[n] for n in self._leaves))

    def _adopt_row(self, i: int, leaves: list, row: int, plen: int) -> None:
        """Row ``row`` of a prefill's cache leaves (``self._leaves``; K/V
        Lb columns deep) into slot ``i``: K/V into its first Lb columns, the
        columns past them zeroed as in the reference's fresh full-depth
        cache; the recurrent ``conv`` / ``ssm`` states whole. Its ``pos`` is
        re-based to the true prompt length (the padded K/V past it are
        masked until decode overwrites them)."""
        for name, g in zip(self._leaves, leaves):
            dst = self.caches[name][:, i]
            if name in ("k", "v"):
                n = g.shape[2]
                dst[:, :n].copy_(g[:, row])
                dst[:, n:].zero_()
            else:
                dst.copy_(g[:, row])
        self.caches["pos"][i] = plen
        self._host_pos[i] = plen
