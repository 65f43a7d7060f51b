"""One step, captured once per shape as a CUDA graph and replayed (the
port's counterpart of the reference's ``jax.jit``: one trace per step
shape).

``StepGraphs.run(key, inputs, body)`` copies ``inputs`` into the key's
static buffers and returns ``body(buffers)``'s tensors. On the card the
first call of a key runs ``body`` eagerly on a side stream (the warm-up: it
builds every kernel, checks every code-id tensor, sizes the ticket buffer,
and is that call's real work), then captures it into a ``torch.cuda.graph``
with a memory pool of its own; later calls replay the graph and return its
static outputs, which only the next call of the same key overwrites. (One
pool shared by every graph is safe only when the graphs replay in the
order they were captured: a later capture may place its outputs in memory
an earlier graph frees as temporaries, which that graph's replay then
overwrites. Steps of a server and forwards of a model come in any order.)
Keys run with the same ``pool`` label capture into one pool instead: it
holds about the largest of their temporaries rather than the sum. That is
safe only where a key's outputs are read before any other key of the
label replays (a replay may overwrite another key's outputs, never its
own or a graph's of another pool): the legacy prefill buckets, whose
caches are adopted and logits read right after each replay.
A capture error raises: nothing falls back to eager. A key is registered
only once its first call has succeeded: a body that raises during the
warm-up or the capture leaves no capture open, the caller's stream current
again, and the key unrecorded, so the next call of the key starts over.
``clear()`` drops every graph with its buffers and memory pools and returns
the pools to the driver. On the CPU, or with ``capture=False``, ``body``
runs eagerly through the same buffers.

Captures use ``torch.cuda.graph``'s default ``capture_error_mode=
"global"``: while a capture is underway, a CUDA call from any other thread
of the process fails it. So a server that steps engines on one thread
keeps every other thread off the device (``serving.gateway``: HTTP
handlers hand their calls to the pump thread).

``first_calls`` logs ``(key, host seconds)`` for every first call of a key
(again after ``clear()``): on the card the eager warm-up, the capture and
the wait for both (the device is synchronized once, at the end of the
first call). A server leaves that
one-time cost out of its stall watchdog (``LLMEngine.step_timeout_s``): a
rebuilt engine core captures every shape anew, and a first call counted as
a stall would rebuild the core again, without end.

Every ``StepGraphs`` of a device warms up and captures on one side stream
(``side_stream``), as ``torch.cuda.graph`` keeps one default capture
stream: cuBLAS keeps a workspace (32 MiB on the card) for every stream it
ran on, for the life of the process, so a stream per object would leak one
workspace per rebuilt engine core. Only one capture can be underway in a
process at a time anyway.

Host arrays (numpy) reach their buffers (float32 for float arrays, else
int32) through pinned staging on the card; tensors are copied on the
device. The kernels launch through
``ctypes`` with raw addresses, so a graph keeps no tensor it reads alive:
the object keeps every graph beside its buffers, and the ticket buffer is
never freed (``kernels.ovsf_gemm.ticket_buffer``). The kernel wrappers count
launches in Python, which a replay does not run: each graph's counts are
taken at capture (where nothing launched: they are taken back) and added at
every replay, so the counters (``kernels.launch_counters``) keep meaning
"kernels launched".
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.kernels import launch_counters


def launch_counts() -> list:
    """Every launch counter's value, in ``launch_counters`` order."""
    return [h[k] if isinstance(h, dict) else getattr(h, k)
            for h, k in launch_counters()]


def add_launch_counts(delta: list) -> None:
    for (h, k), d in zip(launch_counters(), delta):
        if isinstance(h, dict):
            h[k] += d
        else:
            setattr(h, k, getattr(h, k) + d)


_HOST_TYPES = {torch.float32: np.float32, torch.int32: np.int32}
_SIDE_STREAMS: dict = {}        # device -> the warm-up and capture stream


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream of ``device``'s warm-ups and captures."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class _Entry:
    """One key's static buffers, pinned staging, graph, static outputs and
    launch counts per replay."""

    def __init__(self, inputs: dict, device: torch.device):
        self.bufs: dict = {}
        self.staging: dict = {}
        for name, a in inputs.items():
            if isinstance(a, torch.Tensor):
                self.bufs[name] = torch.empty_like(a, device=device)
                continue
            shape = np.shape(a)
            dtype = (torch.float32 if np.asarray(a).dtype.kind == "f"
                     else torch.int32)
            self.bufs[name] = torch.empty(shape, dtype=dtype, device=device)
            if device.type == "cuda":
                self.staging[name] = torch.empty(shape, dtype=dtype,
                                                 pin_memory=True)
        self.copied = (torch.cuda.Event() if self.staging else None)
        self.graph = None
        self.outputs = None
        self.launches = None

    def load(self, inputs: dict) -> None:
        """Inputs into the static buffers. The staging is rewritten only
        once the last call's copies out of it have finished."""
        if self.staging:
            self.copied.synchronize()
        for name, a in inputs.items():
            buf = self.bufs[name]
            if isinstance(a, torch.Tensor):
                buf.copy_(a)
            elif name in self.staging:
                self.staging[name].numpy()[...] = a
                buf.copy_(self.staging[name], non_blocking=True)
            else:
                buf.copy_(torch.from_numpy(
                    np.asarray(a, _HOST_TYPES[buf.dtype])))
        if self.staging:
            self.copied.record()


class StepGraphs:
    """The captured steps of one engine or model, one per key."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self._entries: dict = {}
        self._pools: dict = {}          # label -> a pool its keys share
        self._stream = None             # the side stream of warm-up, capture
        self._main = None               # the caller's stream at warm-up
        self.first_calls: list = []     # (key, seconds) of each first call

    def keys(self) -> list:
        """The keys captured so far."""
        return [k for k, e in self._entries.items() if e.graph is not None]

    def clear(self) -> None:
        """Drop every graph with its buffers and memory pool (the params,
        plan or caches they hold the addresses of are being replaced). On
        the card the queued work finishes first, and the freed pools go
        back to the driver."""
        if not self._entries:
            return
        if self.capture:
            torch.cuda.synchronize(self.device)
        self._entries.clear()
        self._pools.clear()
        if self.capture:
            torch.cuda.empty_cache()

    def run(self, key, inputs: dict, body, pool=None) -> tuple:
        e = self._entries.get(key)
        if e is not None:
            e.load(inputs)
            if not self.capture:
                return body(e.bufs)
            e.graph.replay()
            add_launch_counts(e.launches)
            return e.outputs
        t0 = time.perf_counter()
        e = _Entry(inputs, self.device)
        e.load(inputs)
        if not self.capture:
            out = body(e.bufs)
        else:
            try:
                out = self._warm_up(body, e.bufs)
                before = launch_counts()
                try:
                    e.graph, e.outputs = self._capture(body, e.bufs, pool)
                finally:                # the capture launched nothing
                    e.launches = [a - b for a, b
                                  in zip(launch_counts(), before)]
                    add_launch_counts([-n for n in e.launches])
            except BaseException:
                self._abandon()
                raise
            if self.device.type == "cuda":          # the warm-up's work
                torch.cuda.synchronize(self.device)
        self._entries[key] = e          # only once the first call succeeded
        self.first_calls.append((key, time.perf_counter() - t0))
        return out

    def _abandon(self) -> None:
        """After a warm-up or capture that raised: make the caller's stream
        current again (``torch.cuda.graph`` leaves the side stream current
        when ending the capture fails) and order it after the side
        stream's work."""
        if self._stream is not None:
            torch.cuda.set_stream(self._main)
            self._main.wait_stream(self._stream)

    def _warm_up(self, body, bufs: dict) -> tuple:
        """``body`` eagerly on the side stream the captures use."""
        main = self._main = torch.cuda.current_stream(self.device)
        self._stream = side_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = body(bufs)
        main.wait_stream(self._stream)
        for t in out:                   # read on the main stream
            t.record_stream(main)
        return out

    def _capture(self, body, bufs: dict, pool) -> tuple:
        g = torch.cuda.CUDAGraph()
        handle = None
        if pool is not None:
            if pool not in self._pools:
                self._pools[pool] = torch.cuda.graph_pool_handle()
            handle = self._pools[pool]
        try:
            with torch.cuda.graph(g, pool=handle, stream=self._stream):
                out = body(bufs)
        except BaseException:
            # the graph's exit ends the capture; if that failed before the
            # capture ended, end it here so no stream is left capturing
            with torch.cuda.stream(self._stream):
                if torch.cuda.is_current_stream_capturing():
                    try:
                        g.capture_end()
                    except RuntimeError:
                        pass
            raise
        return g, out
