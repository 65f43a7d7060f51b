"""Model registry for the multi-model gateway: resident alpha banks (port of
``repro.serving.model_registry``).

What a model keeps resident is its compressed alpha coefficients (plus the
shared code ids and the dense leaves): a fraction of one dense weight copy,
which is what makes serving several OVSF models at once cheap.

* :class:`ModelRegistry`: named entries (config + a ``loader`` that
  re-materialises the params bitwise, e.g. a seeded init), grouped by
  architecture signature. Residency is per group: same-architecture
  variants serve from ONE stacked engine, so they load and evict together.
  A byte budget with LRU eviction of unpinned groups (in-flight requests
  pin their model); the ledger charges each resident model its alpha bank
  and each group its shared leaves once, the footprint of the stacked tree
  the group's engine holds.
* :class:`VariantSet` / :func:`stack_variants`: same-architecture params
  stacked into one tree where only the alpha leaves (``alphas`` /
  ``alphas_q8`` / ``alphas_q4`` / ``alpha_scale``) carry a variant axis;
  every other leaf must be bit-equal and is shared.
* :func:`make_alpha_variant`: a same-architecture variant that differs
  only in its alpha banks, so it stacks with its source.
* Integrity scrub: the first load records a CRC32 per alpha-bank leaf
  (:func:`alpha_crc_ledger`); :meth:`ModelRegistry.scrub` checks a resident
  entry against it, :meth:`ModelRegistry.repair` reloads and verifies the
  reload bitwise against it.

Leaf indexing. The reference's params are a pytree whose ``blocks`` leaves
(and an encoder-decoder's ``encoder.blocks`` leaves) are stacked over
layers; the port's are lists of per-layer dicts. A *leaf* here keeps the
reference's meaning: one leaf of the reference's flatten order (dict keys
sorted at every level), spanning all layers. Its bytes are the per-layer
tensors' bytes concatenated in layer order (the C-order bytes of the
reference's ``(n_layers, ...)`` array), its CRC ``zlib.crc32`` carried
across them, so the port's ledger of bridged params equals the
reference's, path strings included, the encoder's alpha banks among them.
The variant axis of a stacked ``blocks`` leaf sits after the layer axis in
the reference (``(n_layers, M, ...)``), so each per-layer tensor of the
port is ``(M, ...)``: what ``kernels.ops.ovsf_matmul_multi`` takes. The
reference puts it first on ``encoder.blocks`` leaves (``(M, n_layers,
...)``); the port keeps ``(M, ...)`` per layer there too (the multi-model
steps never run the encoder), so only a stacked tree's encoder leaves are
laid out otherwise than the reference's.

Torch tensors are mutable and engines hold the registry's tensors (a
one-member group's engine holds the entry's params; its CUDA graphs hold
raw addresses), so nothing here writes a tensor in place: ``corrupt``
copies the flipped leaf into a new tree, ``repair`` installs the loader's
fresh tensors (dropping the old copy first: one copy at a time). Every
tensor operation here belongs to the thread that steps the engines
(``serving.gateway``).
"""
from __future__ import annotations

import dataclasses
import gc
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

# Leaves that differ between same-architecture variants; everything else
# (dense weights, norms, embeddings, code ids) is shared and must be
# bit-equal for variants to stack into one engine.
_STACK_KEYS = ("alphas", "alphas_q8", "alphas_q4", "alpha_scale")
# The compressed representation kept resident: coefficients, scales, ids.
_ALPHA_BANK_KEYS = _STACK_KEYS + ("idx",)


def _flat(tree: dict, prefix: tuple = ()) -> list:
    """``(path, tensor)`` of a dict tree, keys sorted at every level (the
    reference's flatten order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(_flat(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def _leaves(tree: dict, prefix: tuple = ()) -> list:
    """``(path, [tensor per layer])`` for every leaf of the reference's
    flatten order: a leaf under a layer list (``blocks``, an
    encoder-decoder's ``encoder.blocks``) lists its per-layer tensors, any
    other leaf is a list of one."""
    out = []
    for k in sorted(tree):
        v, path = tree[k], prefix + (k,)
        if isinstance(v, list):
            per = [dict(_flat(layer)) for layer in v]
            out.extend((path + p, [d[p] for d in per])
                       for p, _t in _flat(v[0]))
        elif isinstance(v, dict):
            out.extend(_leaves(v, path))
        else:
            out.append((path, [v]))
    return out


def _raw(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes in C order as a host uint8 array (any dtype, any
    device): ``zlib.crc32`` reads it through the buffer protocol, no
    extra copy."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def param_bytes(params: Any) -> int:
    """Total bytes of a params tree."""
    return sum(_nbytes(t) for _p, ts in _leaves(params) for t in ts)


def alpha_bank_bytes(params: Any) -> int:
    """Bytes of the compressed per-model state: alphas (or quantised alphas
    and their scales) and code ids."""
    return sum(_nbytes(t) for p, ts in _leaves(params)
               if p[-1] in _ALPHA_BANK_KEYS for t in ts)


def _alpha_bank_leaves(params: Any) -> list:
    """``(path string, [tensor per layer])`` of every alpha-bank leaf, in
    the reference's flatten order: the leaf indexing shared by the CRC
    ledger, ``scrub`` and the ``flip`` fault."""
    return [("/".join(p), ts) for p, ts in _leaves(params)
            if p[-1] in _ALPHA_BANK_KEYS]


def alpha_crc_ledger(params: Any) -> dict:
    """CRC32 of every alpha-bank leaf's bytes (path string -> checksum),
    carried across its per-layer tensors in layer order."""
    out = {}
    for path, ts in _alpha_bank_leaves(params):
        crc = 0
        for t in ts:
            crc = zlib.crc32(_raw(t), crc)
        out[path] = crc
    return out


def dense_fp32_bytes(cfg: ModelConfig) -> int:
    """Bytes of ONE dense-fp32 copy of this architecture (OVSF off): the
    memory-wall baseline of the gateway's resident-bytes gate, from shapes
    only (``model_init_specs``: nothing allocated)."""
    from repro_torch.models import registry as R
    dense = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, enable=False),
                        exec_plan=None)
    return R.param_count(R.model_init_specs(dense)) * 4


def arch_signature(cfg: ModelConfig) -> str:
    """Architecture identity without the display name and the execution
    plan: two configs with the same signature give structurally identical
    params and can share a stacked engine."""
    return repr(cfg.replace(name="", exec_plan=None))


def _with_leaf(params: dict, path: tuple, layer: int,
               t: torch.Tensor) -> dict:
    """A new tree equal to ``params`` but for the tensor at ``path`` (of
    layer ``layer`` where the path crosses a layer list): the dicts and the
    lists along the path are copied, every other tensor is shared."""
    def put(node, keys: tuple):
        if isinstance(node, list):
            node = list(node)
            node[layer] = put(node[layer], keys)
            return node
        node = dict(node)
        node[keys[0]] = t if len(keys) == 1 else put(node[keys[0]], keys[1:])
        return node
    return put(params, path)


def make_alpha_variant(params: Any, seed: int, scale: float = 0.05) -> Any:
    """A same-architecture variant that differs only in its alpha banks:
    float alphas get one scalar factor per leaf (all its layers), quantised
    banks get it on ``alpha_scale`` (the integer codes keep their bytes).
    Code ids and every dense, norm and embedding leaf are shared, so the
    result stacks with its source (:func:`stack_variants`).

    The factor of leaf i (the reference's flatten order) is ``1 + scale *
    N(0, 1)`` from numpy's generator seeded with ``(seed, i)``, applied in
    float32: the reference draws it from ``jax.random`` instead, so the
    port's variant has the reference's structure, not its numbers (the
    parity tests bridge the reference's variant)."""
    out = params
    for i, (path, ts) in enumerate(_leaves(params)):
        if path[-1] not in ("alphas", "alpha_scale"):
            continue
        factor = 1.0 + scale * float(
            np.random.default_rng([seed, i]).standard_normal())
        for li, t in enumerate(ts):
            new = (t.to(torch.float32) * np.float32(factor)).to(t.dtype)
            out = _with_leaf(out, path, li, new)
    return out


@dataclasses.dataclass(frozen=True)
class VariantSet:
    """Same-architecture variants stacked for one multi-model engine:
    ``params``' alpha leaves carry a leading M axis per layer;
    ``index(name)`` is the variant row a request's model routes to."""
    names: tuple
    cfg: ModelConfig
    params: Any
    M: int

    def index(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        return self.names.index(name)


def stack_variants(named_params: list, cfg: ModelConfig) -> VariantSet:
    """Stack ``[(name, params), ...]`` into a :class:`VariantSet`.

    Alpha leaves gain a variant axis: axis 0 of each per-layer tensor of a
    layer list (``blocks``: the reference's axis 1, after its layer axis;
    an encoder-decoder's ``encoder.blocks``: the reference's axis 0) and of
    any other leaf. Every other leaf must be bit-equal across members (the
    code ids included: the multi path applies ONE transform and contracts
    each token against its variant's coefficients) and is stored once."""
    if len(named_params) < 2:
        raise ValueError("stack_variants needs >= 2 members; a single model "
                         "serves from a plain LLMEngine")
    names = tuple(n for n, _p in named_params)
    flats = []
    for n, p in named_params:
        flat = _leaves(p)
        if flats and [(q, len(ts)) for q, ts in flat] != \
                [(q, len(ts)) for q, ts in flats[0]]:
            raise ValueError(f"variant {n!r} has a different param structure "
                             "— not the same architecture")
        flats.append(flat)
    out = named_params[0][1]
    for i, (path, first) in enumerate(flats[0]):
        rows = [flat[i][1] for flat in flats]
        if path[-1] in _STACK_KEYS:
            for li in range(len(first)):
                out = _with_leaf(out, path, li,
                                 torch.stack([r[li] for r in rows]))
            continue
        for n, r in zip(names[1:], rows[1:]):
            same = all(a.shape == b.shape and a.dtype == b.dtype
                       and torch.equal(a, b) for a, b in zip(first, r))
            if not same:
                raise ValueError(
                    f"variant {n!r} differs from {names[0]!r} on shared "
                    f"leaf {'/'.join(path)!r}; only alpha banks may differ "
                    "between stacked variants")
    return VariantSet(names=names, cfg=cfg, params=out,
                      M=len(named_params))


@dataclasses.dataclass
class ModelEntry:
    """One registered model: how to (re)load it, and its residency state."""
    name: str
    cfg: ModelConfig
    loader: Callable[[], Any]       # re-materialises params bitwise
    tags: tuple = ()
    group: str = ""                 # arch signature (set by the registry)
    params: Any = None              # None = evicted
    bytes: int = 0                  # resident param bytes (whole tree)
    alpha_bytes: int = 0            # resident alpha-bank bytes
    last_used: int = 0              # request sequence (deterministic LRU)
    pinned: int = 0                 # in-flight requests (eviction guard)
    loads: int = 0
    evictions: int = 0
    # CRC32 per alpha-bank leaf, recorded at the FIRST load: the bitwise
    # ground truth every reload must reproduce
    crc_ledger: dict = dataclasses.field(default_factory=dict)
    scrubs: int = 0                 # scrub passes over this entry
    corruptions: int = 0            # scrubs that found a CRC mismatch
    repairs: int = 0                # verified bitwise reloads

    @property
    def resident(self) -> bool:
        return self.params is not None


class ModelRegistry:
    """Named model store with a byte budget and group-granular LRU."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self.entries: dict[str, ModelEntry] = {}
        self.budget_bytes = budget_bytes
        self._seq = 0

    # -- registration / lookup --------------------------------------------

    def register(self, name: str, cfg: ModelConfig,
                 loader: Callable[[], Any], tags: tuple = ()) -> ModelEntry:
        if name in self.entries:
            raise ValueError(f"model {name!r} already registered")
        e = ModelEntry(name=name, cfg=cfg, loader=loader, tags=tuple(tags),
                       group=arch_signature(cfg))
        self.entries[name] = e
        return e

    def get(self, name: Optional[str]) -> Optional[ModelEntry]:
        if name is None:
            return None
        return self.entries.get(name)

    def names(self) -> list:
        return list(self.entries)

    def groups(self) -> dict:
        """group signature -> member names, in registration order."""
        out: dict[str, list] = {}
        for n, e in self.entries.items():
            out.setdefault(e.group, []).append(n)
        return out

    def group_members(self, group: str) -> list:
        return [n for n, e in self.entries.items() if e.group == group]

    # -- LRU / pinning ------------------------------------------------------

    def touch(self, name: str) -> None:
        self._seq += 1
        self.entries[name].last_used = self._seq

    def pin(self, name: str) -> None:
        self.entries[name].pinned += 1

    def unpin(self, name: str) -> None:
        e = self.entries[name]
        e.pinned = max(0, e.pinned - 1)

    def group_pinned(self, group: str) -> int:
        return sum(self.entries[n].pinned for n in self.group_members(group))

    # -- byte ledger --------------------------------------------------------

    def resident_bytes(self) -> int:
        """Resident bytes with stacked sharing counted once: each resident
        model its alpha bank, each group its shared leaves once."""
        total = 0
        seen: set = set()
        for e in self.entries.values():
            if not e.resident:
                continue
            total += e.alpha_bytes
            if e.group not in seen:
                total += e.bytes - e.alpha_bytes
                seen.add(e.group)
        return total

    # -- residency ----------------------------------------------------------

    def _load(self, e: ModelEntry) -> None:
        e.params = e.loader()
        e.bytes = param_bytes(e.params)
        e.alpha_bytes = alpha_bank_bytes(e.params)
        e.loads += 1
        if not e.crc_ledger:    # first load: record the integrity ledger
            e.crc_ledger = alpha_crc_ledger(e.params)

    # -- integrity scrub ----------------------------------------------------

    def scrub(self, name: str) -> list:
        """Check one resident entry's alpha bank against its ledger; the
        corrupted leaf paths ([] = clean or not resident)."""
        e = self.entries[name]
        if not e.resident:
            return []
        e.scrubs += 1
        current = alpha_crc_ledger(e.params)
        bad = [p for p, crc in e.crc_ledger.items()
               if current.get(p) != crc]
        bad += [p for p in current if p not in e.crc_ledger]
        if bad:
            e.corruptions += 1
        return bad

    def corrupt(self, name: str, leaf: int = 0, bit: int = 0) -> str:
        """Flip one bit of alpha-bank leaf ``leaf`` (the reference's flatten
        order, wrapped) in the resident params: the ``flip`` fault. The bit
        offset addresses the leaf's bytes across all its layers (wrapped),
        so fp, int8 and packed int4 banks are all fair game. The flipped
        tensor is a copy in a new tree: engines holding the old tree keep
        serving clean weights. Returns the leaf's path."""
        e = self.entries[name]
        if not e.resident:
            raise ValueError(f"model {name!r} is not resident")
        bank = _alpha_bank_leaves(e.params)
        path, ts = bank[leaf % len(bank)]
        total = sum(_nbytes(t) for t in ts)
        b = (bit // 8) % total
        for li, t in enumerate(ts):
            if b < _nbytes(t):
                break
            b -= _nbytes(t)
        new = t.detach().clone()
        raw = new.reshape(-1).view(torch.uint8)
        raw[b] = raw[b] ^ (1 << (bit % 8))
        e.params = _with_leaf(e.params, tuple(path.split("/")), li, new)
        return path

    def repair(self, name: str) -> None:
        """Reload one entry and VERIFY the reload is bitwise what the ledger
        recorded at first load (a repair that changed the bank would corrupt
        streams instead of fixing them). Raises RuntimeError when the source
        no longer matches (checkpoint rot: an operator's call).

        The resident copy is dropped before the reload, so a repair holds
        one copy of the params at a time; the caller drops the engines
        serving it first (the gateway's scrub does). A reload that does not
        verify leaves the entry evicted, never serving a bank it cannot
        vouch for (the reference keeps the corrupted copy resident)."""
        self._release([name])
        self._reload(name)

    def _release(self, names: list) -> None:
        """Drop the entries' params, collect the reference cycles that may
        still hold their tensors (a closed engine's), and on the card
        release the freed blocks (``torch.cuda.empty_cache``): a reload then
        lays its tensors out from an allocator state that only the other
        live tensors shape, the same at every repair, instead of into
        whatever holes the old copies and the garbage left (the reserved
        bytes would move from one repair to the next)."""
        for n in names:
            self.entries[n].params = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _reload(self, name: str) -> None:
        e = self.entries[name]
        fresh = e.loader()
        if alpha_crc_ledger(fresh) != e.crc_ledger:
            e.evictions += 1
            raise RuntimeError(
                f"repair of {name!r} failed verification: the loader no "
                "longer reproduces the registered alpha bank bitwise")
        e.params = fresh
        e.bytes = param_bytes(fresh)
        e.alpha_bytes = alpha_bank_bytes(fresh)
        e.loads += 1
        e.repairs += 1

    def repair_group(self, group: str) -> list:
        """Bitwise reload of every resident member of ``group`` (stacked
        variants rebuild together). Every member's copy is dropped first,
        then each reloads in registration order, so the group's tensors
        take the same layout at every repair. A member that fails
        verification stays evicted; the others still reload, and the first
        failure is raised after them. Returns the repaired names."""
        names = [n for n in self.group_members(group)
                 if self.entries[n].resident]
        self._release(names)
        failed = None
        done = []
        for n in names:
            try:
                self._reload(n)
            except RuntimeError as exc:
                failed = failed or exc
                continue
            done.append(n)
        if failed is not None:
            raise failed
        return done

    def unregister(self, name: str) -> ModelEntry:
        """Remove a model (hot REMOVE); refused while requests are in
        flight (the caller drains first)."""
        e = self.entries[name]
        if e.pinned:
            raise RuntimeError(
                f"model {name!r} has {e.pinned} in-flight request(s)")
        e.params = None
        del self.entries[name]
        return e

    def evict_group(self, group: str, on_evict: Optional[Callable] = None
                    ) -> None:
        """Drop a group's params (the caller checked its pins);
        ``on_evict(group)`` lets the gateway drop the group's engines."""
        for n in self.group_members(group):
            e = self.entries[n]
            if e.resident:
                e.params = None
                e.evictions += 1
        if on_evict is not None:
            on_evict(group)

    def _lru_group(self, exclude: str) -> Optional[str]:
        """Least recently used evictable group: resident, unpinned, not the
        requesting group (a group's recency is its latest member's)."""
        cands = []
        for g, members in self.groups().items():
            if g == exclude:
                continue
            if not any(self.entries[n].resident for n in members):
                continue
            if self.group_pinned(g):
                continue
            cands.append((max(self.entries[n].last_used for n in members), g))
        if not cands:
            return None
        return min(cands)[1]

    def ensure_resident_group(self, group: str,
                              on_evict: Optional[Callable] = None) -> bool:
        """Make every member of ``group`` resident, evicting LRU unpinned
        groups while the ledger exceeds the budget. False, with the group
        evicted again, when the budget cannot be met (the caller answers
        FINISH_EVICTED instead of queueing against a cold model)."""
        for n in self.group_members(group):
            e = self.entries[n]
            if not e.resident:
                self._load(e)
        if self.budget_bytes is None:
            return True
        while self.resident_bytes() > self.budget_bytes:
            victim = self._lru_group(exclude=group)
            if victim is None:
                self.evict_group(group, on_evict)
                return False
            self.evict_group(victim, on_evict)
        return True
