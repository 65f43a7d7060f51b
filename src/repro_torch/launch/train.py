"""Training launcher for the port: config -> train state -> train loop under
the fault-tolerant supervisor (checkpoint/restart, straggler watchdog).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama_1_1b \
      [--smoke] [--device cpu] --steps 50 --batch 8 --seq 128 --ckpt DIR

The reference's flags, plus ``--device`` (``cuda`` by default; it raises
when no GPU is present). ``--data-par`` / ``--model-par`` set the
reference's mesh; one card has none, so a value above 1 is refused. The
state is initialised natively from ``--seed`` (``train.steps``), batches
come from ``data.synthetic.TokenStream`` (a pure function of seed and
step, so a replayed step sees its batch again), checkpoints go to
``--ckpt`` every ``--save-every`` steps and at the end (a run pointed at a
directory with checkpoints resumes from the latest), each verified by CRC
on restore unless ``--no-verify-ckpt``. Every family trains; an
encoder-decoder's batches carry zero ``frames`` (B, ``encoder_seq``, d)
and a VLM's zero ``image_embeds`` (B, min(``vlm_image_tokens``, S // 2),
d), in the model dtype on the device, as the reference's launcher builds
them, in every batch the supervisor draws (a replayed step too). A
config with int8 / int4 alphas trains their scales through the same loop.
Prints the reference's lines (``[train] params``, ``[train] done: ...
first loss ... last loss``) and each save's seconds.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import registry as R
from repro_torch.runtime import supervisor
from repro_torch.train import optim, steps


def family_inputs(cfg, batch: int, seq: int, device) -> dict:
    """The reference launcher's extra batch keys, zeros in the model dtype:
    an encoder-decoder's ``frames`` (batch, ``encoder_seq``, d), a VLM's
    ``image_embeds`` (batch, min(``vlm_image_tokens``, seq // 2), d)."""
    shape = None
    if cfg.family == "encdec":
        name, shape = "frames", (batch, cfg.encoder_seq, cfg.d_model)
    elif cfg.family == "vlm":
        name = "image_embeds"
        shape = (batch, min(cfg.vlm_image_tokens, seq // 2), cfg.d_model)
    if shape is None:
        return {}
    return {name: torch.zeros(shape, dtype=cfg.act_dtype, device=device)}


def main(argv=None):
    """Train; returns ``(state, report)`` (``supervisor.RunReport``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-verify-ckpt", action="store_true",
                    help="skip the per-leaf CRC check on checkpoint "
                         "restore (verification is the default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.data_par > 1 or args.model_par > 1:
        ap.error("--data-par / --model-par above 1 need a device mesh; the "
                 "port trains on one device")

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    print(f"[train] {cfg.name}: device {dev}, {cfg.n_layers} layers, "
          f"{cfg.dtype}", flush=True)
    state = steps.train_state_init(cfg, args.seed, dev)
    n_params = R.param_count(state["params"])
    print(f"[train] params: {n_params/1e6:.1f}M", flush=True)

    ocfg = optim.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                           total_steps=args.steps)
    fn = steps.make_train_step(cfg, ocfg)
    stream = TokenStream(cfg.vocab, args.seq, args.batch, seed=args.seed)
    extra = family_inputs(cfg, args.batch, args.seq, dev)

    def batch_at(step: int) -> dict:
        return {**stream.batch_at(step), **extra}

    scfg = supervisor.SupervisorConfig(ckpt_dir=args.ckpt,
                                       save_every=args.save_every,
                                       verify_ckpt=not args.no_verify_ckpt)
    state, report = supervisor.run(fn, state, batch_at, args.steps, scfg)
    print(f"[train] done: steps={report.steps_run} failures="
          f"{report.failures} first loss={report.losses[0]:.4f} last loss="
          f"{report.losses[-1]:.4f}", flush=True)
    print("[train] saves: "
          + ", ".join(f"host copy {a:.2f}s + write {b:.2f}s" for a, b in
                      zip(report.save_snapshot_s, report.save_write_s)),
          flush=True)
    return state, report


if __name__ == "__main__":
    main()
