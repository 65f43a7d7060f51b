"""Write-ahead request journal: durable serving across process crashes
(copy of ``repro.serving.journal``, the same on-disk format).

Every request is journaled at admission and every committed token behind
it, so a fresh process replays the log and resumes each live request
mid-stream by recompute: weights and state are cheap to rebuild, only the
requests are worth keeping.

On-disk format: an append-only directory of segments
``<dir>/seg_00000000.wal``, ``seg_00000001.wal``, ... (a new segment on
compaction), each a sequence of CRC-framed records
``[u32 payload_len][u32 crc32(payload)][payload: UTF-8 JSON]``
(little-endian) of three types:

``admit``   one per admission: rid, prompt ids, the sampling spec,
            max_new_tokens, priority, deadline_s, the wall-clock admit time
            (deadlines keep ticking while the process is down), the
            client's idempotency key and the body fingerprint;
``tok``     the tokens one request committed in one engine step;
``fin``     one terminal finish reason, flushed before ``on_finish``.

``flush()`` group-commits (one write and one fsync) once per engine step
and on every ``fin``. Tokens emitted but not yet flushed when the process
died are regenerated on recovery: recompute is deterministic, greedy and
sampled (the draw of the t-th token is a pure function of ``(seed, t)``).

Recovery: ``RequestJournal(dir)`` replays every segment, stopping at the
first torn or corrupt record of each; ``entry.to_request()`` rebuilds a
live request in the preempt-and-recompute shape (prompt = original +
journaled tokens); the engine finishes a request whose deadline passed
while the process was down as ``FINISH_TIMEOUT`` and compacts the journal.
A journal I/O error never blocks the step loop: the journal marks itself
``broken``, warns once, and serving goes on without durability.

Sampling keys: ``prng_key``, ``split`` and ``key_after`` are a numpy port
of ``jax.random.PRNGKey`` and ``jax.random.split`` over the default
threefry2x32 generator (partitionable key derivation), so ``key_after``
returns the same uint32 pair as the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
import time
import warnings
import zlib
from typing import Optional

import numpy as np

__all__ = ["RequestJournal", "JournalEntry", "key_after", "prng_key",
           "split", "threefry2x32", "body_fingerprint"]

_FRAME = struct.Struct("<II")      # payload length, crc32(payload)
_SEG_FMT = "seg_{:08d}.wal"

# -- threefry2x32 (Salmon et al. 2011, 20 rounds), as jax.random uses it ----

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> tuple[np.ndarray, np.ndarray]:
    """The threefry2x32 block cipher of the 2-word ``key`` over counter
    words ``x0``, ``x1`` (uint32 arrays of one shape)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the (2,) uint32 key of a seed."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    hi = np.zeros(num, np.uint32)
    lo = np.arange(num, dtype=np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=1)


def key_after(seed: int, n_tokens: int) -> Optional[np.ndarray]:
    """The key a sampled request holds after emitting ``n_tokens``: the
    seed's key split ``n_tokens`` times, keeping the first half each time
    (the second half is the draw's subkey). None for ``n_tokens == 0``
    (a fresh admission seeds ``prng_key(seed)``), as the reference's."""
    if n_tokens <= 0:
        return None
    key = prng_key(seed)
    for _ in range(n_tokens):
        key = split(key)[0]
    return key


def body_fingerprint(prompt, max_new_tokens: int, temperature: float,
                     top_k: int, seed: int, model: Optional[str]) -> int:
    """Canonical fingerprint of a request body, for idempotency-key
    conflict detection (two submissions under one key must carry the same
    body)."""
    blob = json.dumps([
        [int(t) for t in np.asarray(prompt).tolist()],
        int(max_new_tokens), float(temperature), int(top_k), int(seed),
        model,
    ], separators=(",", ":")).encode()
    return zlib.crc32(blob)


@dataclasses.dataclass
class JournalEntry:
    """In-memory state of one journaled request (replayed or live).
    ``model`` is the gateway's routing target (``Request.model``)."""
    rid: int
    prompt: list                    # original prompt token ids
    max_new_tokens: int
    temperature: float
    top_k: int
    seed: int
    model: Optional[str] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    wall: float = 0.0               # wall-clock admit time (time.time)
    ikey: Optional[str] = None      # client idempotency key
    fp: int = 0                     # canonical body fingerprint
    tokens: list = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def to_request(self):
        """A live :class:`~repro_torch.serving.api.Request` mid-stream, in
        the preempt-and-recompute shape: prompt = original + journaled
        tokens, ``out_tokens`` pre-filled (only new tokens are emitted),
        and ``t_submit`` back-dated by the downtime so deadlines kept
        ticking while the process was dead."""
        from repro_torch.serving.api import Request, SamplingParams
        sp = SamplingParams(temperature=self.temperature, top_k=self.top_k,
                            seed=self.seed)
        prompt = np.asarray(list(self.prompt) + list(self.tokens), np.int32)
        req = Request(rid=self.rid, prompt=prompt,
                      max_new_tokens=self.max_new_tokens, sampling=sp,
                      model=self.model, priority=self.priority,
                      deadline_s=self.deadline_s, idempotency_key=self.ikey)
        req.out_tokens = list(self.tokens)
        req.prompt_len_orig = len(self.prompt)
        req.token_times = [time.perf_counter()] * len(self.tokens)
        elapsed = max(0.0, time.time() - self.wall) if self.wall else 0.0
        req.t_submit = time.perf_counter() - elapsed
        return req

    def snapshot(self) -> dict:
        """One condensed record of the entry's whole state (compaction)."""
        d = {"t": "entry", "rid": self.rid, "prompt": self.prompt,
             "max_new": self.max_new_tokens, "temp": self.temperature,
             "top_k": self.top_k, "seed": self.seed, "wall": self.wall,
             "fp": self.fp, "toks": list(self.tokens)}
        if self.model is not None:
            d["model"] = self.model
        if self.priority:
            d["priority"] = self.priority
        if self.deadline_s is not None:
            d["deadline_s"] = self.deadline_s
        if self.ikey is not None:
            d["ikey"] = self.ikey
        if self.finish_reason is not None:
            d["reason"] = self.finish_reason
        return d

    @classmethod
    def from_snapshot(cls, d: dict) -> "JournalEntry":
        return cls(rid=int(d["rid"]), prompt=list(d["prompt"]),
                   max_new_tokens=int(d["max_new"]),
                   temperature=float(d["temp"]), top_k=int(d["top_k"]),
                   seed=int(d["seed"]), model=d.get("model"),
                   priority=int(d.get("priority", 0)),
                   deadline_s=d.get("deadline_s"),
                   wall=float(d.get("wall", 0.0)), ikey=d.get("ikey"),
                   fp=int(d.get("fp", 0)), tokens=list(d.get("toks", ())),
                   finish_reason=d.get("reason"))


def _frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def _iter_records(raw: bytes):
    """Decoded JSON payloads up to the first torn or corrupt record
    (everything after an undecodable frame is untrusted)."""
    off, n = 0, len(raw)
    while off + _FRAME.size <= n:
        length, crc = _FRAME.unpack_from(raw, off)
        start = off + _FRAME.size
        end = start + length
        if end > n:
            return                  # torn tail: record written partially
        payload = raw[start:end]
        if zlib.crc32(payload) != crc:
            return                  # corrupt frame
        try:
            yield json.loads(payload.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            return
        off = end


class RequestJournal:
    """Append-only, fsync'd, CRC-framed write-ahead log of one serving
    process's requests. Appends buffer in memory; :meth:`flush`
    group-commits them with one write and one fsync."""

    def __init__(self, directory: str, *, segment_bytes: int = 4 << 20,
                 sync: bool = True):
        self.dir = directory
        self.segment_bytes = int(segment_bytes)
        self.sync = sync
        self.broken = False
        self._buf: list[bytes] = []
        self._fh = None
        self.appended = 0           # records appended by this process
        self.flushes = 0            # fsync group commits
        os.makedirs(directory, exist_ok=True)
        segs = self._segments()
        #: rid -> JournalEntry, in admission order (recovery keeps it)
        self.entries: dict[int, JournalEntry] = {}
        for path in segs:
            self._replay_segment(path)
        self._seg_index = (int(os.path.basename(segs[-1])[4:12]) + 1
                           if segs else 0)
        self._open_segment()

    # -- replay --------------------------------------------------------------

    def _segments(self) -> list:
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("seg_") and n.endswith(".wal"))
        except OSError:
            names = []
        return [os.path.join(self.dir, n) for n in names]

    def _replay_segment(self, path: str) -> None:
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError:
            return
        for rec in _iter_records(raw):
            t = rec.get("t")
            if t == "admit" or t == "entry":
                e = JournalEntry.from_snapshot(rec)
                self.entries[e.rid] = e
            elif t == "tok":
                e = self.entries.get(int(rec["rid"]))
                if e is not None:
                    e.tokens.extend(int(x) for x in rec["toks"])
            elif t == "fin":
                e = self.entries.get(int(rec["rid"]))
                if e is not None:
                    e.finish_reason = rec["reason"]

    def live_entries(self) -> list:
        """Non-terminal entries in admission order (the recovery set)."""
        return [e for e in self.entries.values() if not e.done]

    def finished_entries(self) -> list:
        return [e for e in self.entries.values() if e.done]

    @property
    def max_rid(self) -> int:
        return max(self.entries, default=-1)

    # -- append paths --------------------------------------------------------

    def admit_request(self, req) -> None:
        """Journal one admission (idempotent by rid: a re-admission after
        recovery never journals twice)."""
        if self.broken or req.rid in self.entries:
            return
        prompt = [int(t) for t in np.asarray(req.prompt).tolist()]
        # the ORIGINAL prompt: a re-admitted preempted request carries its
        # generated tokens in its prompt; those live in `tok` records
        if req.prompt_len_orig is not None:
            prompt = prompt[:req.prompt_len_orig]
        sp = req.sampling
        e = JournalEntry(
            rid=req.rid, prompt=prompt, max_new_tokens=req.max_new_tokens,
            temperature=sp.temperature, top_k=sp.top_k, seed=sp.seed,
            model=req.model, priority=req.priority,
            deadline_s=req.deadline_s, wall=time.time(),
            ikey=req.idempotency_key,
            fp=body_fingerprint(prompt, req.max_new_tokens, sp.temperature,
                                sp.top_k, sp.seed, req.model))
        self.entries[e.rid] = e
        d = e.snapshot()
        d["t"] = "admit"
        self._append(d)

    def tokens(self, rid: int, toks) -> None:
        """Journal the tokens one request committed this step."""
        if self.broken:
            return
        e = self.entries.get(rid)
        if e is None:
            return
        toks = [int(t) for t in toks]
        e.tokens.extend(toks)
        self._append({"t": "tok", "rid": rid, "toks": toks})

    def finish(self, rid: int, reason: str) -> None:
        """Journal a terminal finish reason and flush synchronously: the
        record is durable before ``on_finish`` surfaces the result."""
        if self.broken:
            return
        e = self.entries.get(rid)
        if e is None:
            return
        e.finish_reason = reason
        self._append({"t": "fin", "rid": rid, "reason": reason})
        self.flush()

    # -- durability ----------------------------------------------------------

    def _append(self, payload: dict) -> None:
        self._buf.append(_frame(json.dumps(
            payload, separators=(",", ":")).encode()))
        self.appended += 1

    def flush(self) -> None:
        """Group-commit the buffered records: one write and one fsync. An
        I/O failure degrades to non-durable with one loud warning."""
        if self.broken or not self._buf:
            return
        try:
            self._fh.write(b"".join(self._buf))
            self._fh.flush()
            if self.sync:
                os.fsync(self._fh.fileno())
            self._buf.clear()
            self.flushes += 1
            if self._fh.tell() >= self.segment_bytes:
                self.compact()
        except OSError as err:
            self._degrade(err)

    def _degrade(self, err: Exception) -> None:
        self.broken = True
        self._buf.clear()
        try:
            if self._fh is not None:
                self._fh.close()
        except OSError:
            pass
        self._fh = None
        warnings.warn(
            f"request journal at {self.dir!r} failed ({err!r}): serving "
            "DEGRADES TO NON-DURABLE — in-flight requests will not survive "
            "a process crash until the journal directory is writable and "
            "the process restarts", RuntimeWarning, stacklevel=3)

    def _open_segment(self) -> None:
        try:
            path = os.path.join(self.dir, _SEG_FMT.format(self._seg_index))
            self._fh = open(path, "ab")
        except OSError as err:
            self._degrade(err)

    # -- compaction ----------------------------------------------------------

    def compact(self, keep_finished: bool = True) -> None:
        """Rewrite the journal as one snapshot record per entry in a fresh
        segment, then delete the older segments. ``keep_finished=False``
        also drops terminal entries from disk. Runs on segment rotation and
        after recovery."""
        if self.broken:
            return
        old = self._segments()
        self._seg_index += 1
        try:
            if self._fh is not None:
                self._fh.close()
            path = os.path.join(self.dir, _SEG_FMT.format(self._seg_index))
            with open(path, "ab") as f:
                for e in self.entries.values():
                    if e.done and not keep_finished:
                        continue
                    f.write(_frame(json.dumps(
                        e.snapshot(), separators=(",", ":")).encode()))
                f.flush()
                os.fsync(f.fileno())
            # the new segment's directory entry must be durable before the
            # old segments go
            dfd = os.open(self.dir, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
            for p in old:
                os.unlink(p)
            if not keep_finished:
                self.entries = {rid: e for rid, e in self.entries.items()
                                if not e.done}
            self._fh = open(path, "ab")
        except OSError as err:
            self._degrade(err)

    def close(self) -> None:
        self.flush()
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None
