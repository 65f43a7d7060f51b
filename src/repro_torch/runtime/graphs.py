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
A capture error raises: nothing falls back to eager. On the CPU, or with
``capture=False``, ``body`` runs eagerly through the same buffers.

Host arrays (numpy) reach their int32 buffers through pinned staging on the
card; tensors are copied on the device. The kernels launch through
``ctypes`` with raw addresses, so a graph keeps no tensor it reads alive:
the object keeps every graph beside its buffers, and the ticket buffer is
never freed (``kernels.ovsf_gemm.ticket_buffer``). The kernel wrappers count
launches in Python, which a replay does not run: each graph's counts are
taken at capture (where nothing launched: they are taken back) and added at
every replay, so the counters (``kernels.launch_counters``) keep meaning
"kernels launched".
"""
from __future__ import annotations

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
            self.bufs[name] = torch.empty(shape, dtype=torch.int32,
                                          device=device)
            if device.type == "cuda":
                self.staging[name] = torch.empty(shape, dtype=torch.int32,
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
                buf.copy_(torch.from_numpy(np.asarray(a, np.int32)))
        if self.staging:
            self.copied.record()


class StepGraphs:
    """The captured steps of one engine or model, one per key."""

    def __init__(self, device, capture: bool = True):
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self._entries: dict = {}
        self._stream = None

    def keys(self) -> list:
        """The keys captured so far."""
        return [k for k, e in self._entries.items() if e.graph is not None]

    def clear(self) -> None:
        """Drop every graph and buffer (the params or plan they hold the
        addresses of are being replaced)."""
        self._entries.clear()

    def run(self, key, inputs: dict, body) -> tuple:
        e = self._entries.get(key)
        if e is None:
            e = self._entries[key] = _Entry(inputs, self.device)
        e.load(inputs)
        if not self.capture:
            return body(e.bufs)
        if e.graph is not None:
            e.graph.replay()
            add_launch_counts(e.launches)
            return e.outputs
        out = self._warm_up(body, e.bufs)
        before = launch_counts()
        e.graph, e.outputs = self._capture(body, e.bufs)
        e.launches = [a - b for a, b in zip(launch_counts(), before)]
        add_launch_counts([-n for n in e.launches])   # the capture ran none
        return out

    def _warm_up(self, body, bufs: dict) -> tuple:
        """``body`` eagerly on the side stream the captures use."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = body(bufs)
        main.wait_stream(self._stream)
        for t in out:                   # read on the main stream
            t.record_stream(main)
        return out

    def _capture(self, body, bufs: dict) -> tuple:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=self._stream):
            out = body(bufs)
        return g, out
