"""Fault-tolerant training supervisor: checkpoint/restart, failure
recovery, straggler watchdog (port of ``repro.runtime.supervisor``).

- *Failures*: any exception inside a step triggers restore from the latest
  checkpoint and replay. The data stream is a pure function of (seed,
  step), so a replayed step sees the same batch.
- *Stragglers*: a per-step wall-clock watchdog flags steps slower than
  ``straggler_factor`` x the trailing median and calls ``on_straggler``.
- ``faults`` takes the serving side's ``runtime.faults.FaultPlan``: one
  chaos schedule drives both (``fail`` raises, ``delay`` feeds the
  watchdog, the serving-only kinds are ignored); an explicit
  ``failure_injector`` takes precedence.

Checkpoints are written by ``checkpoint.ckpt.AsyncSaver`` (a host copy of
the state first, then a writer thread); a restore puts every leaf back on
the device and in the type of the state it replaces. The reference's
``state_shardings`` (a restore onto a mesh) has no one-card counterpart.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import ckpt


@dataclasses.dataclass
class SupervisorConfig:
    # the launcher's default too, apart from the reference's fixed default,
    # so that a run of one package never resumes from the other's
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    save_every: int = 50
    keep: int = 3
    max_failures: int = 8
    straggler_factor: float = 3.0
    log_every: int = 10
    # per-leaf CRC verification on every restore; launchers expose
    # --no-verify-ckpt to opt out
    verify_ckpt: bool = True


@dataclasses.dataclass
class RunReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    stragglers: int = 0
    losses: list = dataclasses.field(default_factory=list)
    step_times: list = dataclasses.field(default_factory=list)
    # each save's blocking host copy and background write, seconds (the
    # port's addition: a full-width state is gigabytes)
    save_snapshot_s: list = dataclasses.field(default_factory=list)
    save_write_s: list = dataclasses.field(default_factory=list)


def run(train_step: Callable, state: Any, batch_at: Callable[[int], Any],
        n_steps: int, cfg: SupervisorConfig, *,
        failure_injector: Optional[Callable[[int], None]] = None,
        faults=None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
        log: Callable[[str], None] = print) -> tuple[Any, RunReport]:
    """Run ``n_steps`` of ``train_step(state, batch) -> (state, metrics)``
    with checkpoint/restart semantics; ``batch_at(step)`` is a pure
    function (deterministic replay), ``failure_injector(step)`` may raise
    to simulate a node failure."""
    if failure_injector is None and faults is not None:
        failure_injector = faults.failure_injector()
    saver = ckpt.AsyncSaver()
    report = RunReport()
    template = ckpt.spec_of(state)   # structure, types, devices: no data

    start = ckpt.latest_step(cfg.ckpt_dir)
    step = 0
    if start is not None:
        state, step = ckpt.restore(cfg.ckpt_dir, template=template,
                                   verify=cfg.verify_ckpt)
        report.restores += 1
        log(f"[supervisor] resumed from step {step}")

    while step < n_steps:
        try:
            # the timer starts before the injector, so an injected delay
            # lands inside the measured step wall
            t0 = time.perf_counter()
            if failure_injector is not None:
                failure_injector(step)
            batch = batch_at(step)
            state, metrics = train_step(state, batch)
            loss = float(metrics.get("total_loss", metrics.get("loss", 0.0)))
            dt = time.perf_counter() - t0
            report.step_times.append(dt)
            report.losses.append(loss)
            report.steps_run += 1
            step += 1

            if len(report.step_times) >= 5:
                med = statistics.median(report.step_times[-50:])
                if dt > cfg.straggler_factor * med:
                    report.stragglers += 1
                    log(f"[supervisor] straggler at step {step}: "
                        f"{dt:.3f}s vs median {med:.3f}s")
                    if on_straggler is not None:
                        on_straggler(step, dt)

            if step % cfg.log_every == 0:
                log(f"[supervisor] step {step} loss {loss:.4f} ({dt:.3f}s)")
            if step % cfg.save_every == 0 or step == n_steps:
                saver.save_async(state, cfg.ckpt_dir, step)
                ckpt.gc_old(cfg.ckpt_dir, cfg.keep)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any step failure => restart
            report.failures += 1
            log(f"[supervisor] step {step} failed: {type(e).__name__}: {e}")
            if report.failures > cfg.max_failures:
                raise RuntimeError("supervisor: too many failures") from e
            saver.wait()
            last = ckpt.latest_step(cfg.ckpt_dir)
            if last is None:
                log("[supervisor] no checkpoint yet; restarting from step 0 "
                    "state in memory")
                continue
            state, step = ckpt.restore(cfg.ckpt_dir, template=template,
                                       verify=cfg.verify_ckpt)
            report.restores += 1
            log(f"[supervisor] restored step {step}, replaying")

    saver.wait()
    report.save_snapshot_s = list(saver.snapshot_s)
    report.save_write_s = list(saver.write_s)
    return state, report
