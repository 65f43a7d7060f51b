"""EngineCore: the paged KV pools, the packed step and the fused sampling
tail (port of the paged packed path of ``repro.serving.core``).

``step(SchedulerOutput) -> StepOutput`` flattens the scheduler's decode
slots and prompt chunks into one dense pow-2-bucketed token stream
(``scheduler.pack_step``), runs ``serve_step_paged`` against the shared
per-layer page pools, then samples on the device: argmax for greedy slots,
top-k / temperature draws for sampled ones, plus a per-slot
``ok = all(isfinite(logits))`` row. The engine grants pages before calling
``step`` (``LLMEngine._page_gate``).

Sampling state: each sampled slot owns a ``torch.Generator`` on the device,
seeded from ``SamplingParams.seed`` at admission and advanced only when the
slot emits a token, so a sampled stream does not depend on batch
composition, slot placement or chunking. The numbers differ from the
reference's threefry keys: greedy streams match the reference, sampled
streams match only within the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry as R
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.kvcache import PagedKVCache
from repro_torch.serving.scheduler import SchedulerOutput, pack_step


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
    decode_s: float = 0.0       # chunk-free (pure decode) step wall time
    mixed_s: float = 0.0        # step carrying prompt chunks
    n_valid_tokens: int = 0     # tokens that were real work this step
    n_batch_tokens: int = 0     # tokens the device batch carried


class EngineCore:
    """Device-side half of the engine: paged caches, packed step, sampling."""

    def __init__(self, params, cfg: ModelConfig, *, batch_slots: int,
                 buffer_len: int, window: int, page_size: int,
                 kv_pages: Optional[int], device: torch.device):
        if window <= 0:
            raise ValueError("paged serving consumes prompts via chunks; "
                             "pass a chunk size")
        if buffer_len % page_size:
            raise ValueError(f"buffer_len={buffer_len} must be a multiple of "
                             f"page_size={page_size} (pages tile the virtual "
                             f"slot buffer exactly)")
        self.params = params
        self.cfg = cfg
        self.B = batch_slots
        self.window = window
        self.device = device
        max_pages = buffer_len // page_size
        n_pages = (int(kv_pages) if kv_pages is not None
                   else batch_slots * max_pages)
        page_bytes = (2 * cfg.n_layers * page_size * cfg.n_kv_heads * cfg.hd
                      * cfg.act_dtype.itemsize)
        self.pager = PagedKVCache(batch_slots, page_size, n_pages, max_pages,
                                  page_bytes)
        self.caches = R.init_paged_cache(cfg, page_size, n_pages, device)
        self.caches["pos"] = torch.zeros((batch_slots,), dtype=torch.int32,
                                         device=device)
        self._host_pos = np.zeros(batch_slots, np.int64)
        self.temps = np.zeros(batch_slots, np.float32)
        self.topks = np.zeros(batch_slots, np.int32)
        self.greedy = np.ones(batch_slots, bool)
        self.gens: list = [None] * batch_slots

    def _set_sampling(self, i: int, sp: SamplingParams) -> None:
        self.temps[i] = max(sp.temperature, 0.0)
        self.topks[i] = sp.top_k
        self.greedy[i] = sp.greedy
        self.gens[i] = (None if sp.greedy else
                        torch.Generator(device=self.device).manual_seed(
                            sp.seed))

    def clear_sampling(self, i: int) -> None:
        """Reset a freed slot to greedy (the next request re-seeds)."""
        self.temps[i] = 0.0
        self.topks[i] = 0
        self.greedy[i] = True
        self.gens[i] = None

    def _health_and_sample(self, logits: torch.Tensor, emit_slots: tuple
                           ) -> tuple[np.ndarray, np.ndarray]:
        """(B, V) logits -> ((B,) tokens, (B,) finite-logits flags) on the
        host. Only emitting sampled slots draw (and advance their
        generator); a slot with non-finite logits draws nothing."""
        lg = logits.to(torch.float32)
        ok = torch.isfinite(lg).all(dim=-1)
        toks = torch.argmax(lg, dim=-1)
        sampled = [i for i in emit_slots if not self.greedy[i]]
        if not sampled:
            host = torch.stack([toks, ok.to(toks.dtype)]).cpu().numpy()
            return host[0], host[1].astype(bool)
        ok_host = ok.cpu().numpy()
        for i in sampled:
            if ok_host[i]:
                toks[i] = sample_token(lg[i], float(self.temps[i]),
                                       int(self.topks[i]), self.gens[i])
        return toks.cpu().numpy(), ok_host

    @torch.no_grad()
    def step(self, so: SchedulerOutput,
             last_tokens: Optional[np.ndarray] = None) -> StepOutput:
        """Execute one scheduler iteration as ONE packed paged step.
        ``last_tokens`` carries each decode slot's previous token at its
        slot index."""
        out = StepOutput()
        if not (so.chunks or so.decode_slots):
            return out
        t0 = time.perf_counter()
        for c in so.chunks:
            if c.start == 0:            # new request: seed sampling state
                self._set_sampling(c.slot, c.req.sampling)
        ps = pack_step(so, last_tokens, self._host_pos, self.B, self.window)
        dev = self.device

        def put(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        logits, self.caches = R.serve_step_paged(
            self.params, self.cfg, self.caches, put(self.pager.page_table),
            put(ps.tokens), put(ps.slot_ids), put(ps.positions),
            put(ps.new_pos), put(ps.emit_idx))
        toks, ok = self._health_and_sample(logits, ps.emit_slots)
        self._host_pos[:] = ps.new_pos
        bad: list = []
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
        out.n_valid_tokens = ps.n_valid
        out.n_batch_tokens = ps.n_batch
        dt = time.perf_counter() - t0
        if so.chunks:
            out.mixed_s = dt
        else:
            out.decode_s = dt
        return out
