"""Fault-tolerant training driver of the port, on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
        --smoke --steps 50 --ckpt-dir /tmp/run1 [--device cpu] [--seed 0]

Counterpart of ``repro/launch/train.py`` with the same flags, plus
``--device`` and ``--seed`` (the random weights' seed).  Fault-tolerance
posture, as in the reference:
  * auto-resume: on start, the newest committed checkpoint (atomic
    manifest rename, ``ckpt/manager.py``) is restored in place — the
    parameters, the optimizer's masters, moments and step AND the data
    cursor, so the token stream continues exactly;
  * periodic + terminal checkpoints; SIGTERM (preemption) sets a flag, and
    the step in flight ends with a checkpoint and a return of 0;
  * step retry loop: a step that raises is tried again, up to three
    times; the third failure checkpoints and re-raises.  The port's step
    updates the model in place, so a failure inside the optimizer's update
    (after the gradients) is retried on partly updated state; a failure in
    the forward or backward leaves the model as it was.

On a mesh (``--data D --model M`` above 1, one process a device under
``torchrun``, world = D x M; or ``run(args, mesh=...)``): the parameters
are DTensors placed by ``dist.sharding.param_shardings``, the optimizer
state by ``adamw.state_shardings(..., model)`` (ZeRO-3), each batch by
``input_shardings``, and the step runs under ``implicit_replication()``.
Every rank draws the same weights and batches and keeps its own slices.
A checkpoint holds full tensors (rank 0 writes them) and restores onto
whatever mesh the relaunch got: the elastic restart.  With one device
and no mesh the launcher is the plain one-device trainer.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch mamba2-130m --smoke --steps 6 --data 2 --model 2 --device cpu

``run`` returns a ``TrainRun`` with every step's loss; ``main`` returns
the exit code.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import configs
from repro_torch.ckpt import manager as ckpt
from repro_torch.core.backend import resolve_device
from repro_torch.data.pipeline import DataConfig, DataState, SyntheticPipeline
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_dev_mesh
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.train.step import TrainConfig, make_train_step

def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap.parse_args(argv)


def optimizer_config(args) -> adamw.AdamWConfig:
    return adamw.AdamWConfig(lr=args.lr, total_steps=args.steps,
                             warmup_steps=max(args.steps // 20, 5),
                             schedule=args.schedule)


def make_batch(cfg, args, toks: np.ndarray, labels: np.ndarray,
               dev) -> dict:
    """The pipeline's (tokens, labels) on ``dev`` with the per-arch stubs:
    a VLM's zero patch embeddings in front (tokens cut to make room), an
    encoder-decoder's zero frame embeddings for the second half."""
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    if cfg.frontend == "patch":
        batch["tokens"] = batch["tokens"][:, : args.seq - cfg.frontend_len]
        batch["prefix_embeds"] = torch.zeros(
            (args.batch, cfg.frontend_len, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    if cfg.enc_layers:
        half = args.seq // 2
        batch["tokens"] = batch["tokens"][:, :half]
        batch["labels"] = batch["labels"][:, :half]
        batch["enc_embeds"] = torch.zeros(
            (args.batch, args.seq - half, cfg.d_model),
            dtype=torch.bfloat16, device=dev)
    return batch


@dataclasses.dataclass
class TrainRun:
    """What one ``run`` did: the step it started from, every step's loss
    in order, the data cursor it ended on, how it ended (``"done"`` or
    ``"sigterm"``), and the trained model and optimizer state."""
    start_step: int
    losses: list
    data_step: int
    ended: str
    model: lm.LM
    opt_state: dict


def _scalar(t) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def run(args: argparse.Namespace, mesh=None) -> TrainRun:
    """Train per ``args``; on ``mesh`` (None: a (data, model) dev mesh
    when either is above 1, else no mesh) with DTensor parameters."""
    dev = resolve_device(args.device)
    if mesh is None and (args.data > 1 or args.model > 1):
        mesh = make_dev_mesh(args.data, args.model, device_type=dev.type)
    if mesh is not None and dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    spec = configs.get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    tcfg = TrainConfig(optimizer=optimizer_config(args))

    model = lm.init_params(cfg, seed=args.seed, device=dev)
    shardings = None
    if mesh is not None:
        pl = shd.param_shardings(cfg, model, mesh)
        shd.distribute_model(model, mesh, pl)
        shardings = adamw.state_shardings(pl, mesh, model)
    opt_state = adamw.init(model, shardings)

    def place(batch):
        if mesh is None:
            return batch
        shape = configs.ShapeConfig("train", args.seq, args.batch, "train")
        return shd.distribute_tree(
            batch, mesh, shd.input_shardings(cfg, shape, batch, mesh))

    pipe = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch))
    dstate = DataState()

    def tree():
        return {"params": model, "opt": opt_state}

    start_step = 0
    if args.ckpt_dir:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is not None:
            _, extra = ckpt.restore(args.ckpt_dir, last, tree())
            start_step = extra["step"]
            dstate = DataState(step=extra["data_step"])
            print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg)

    def save(step):
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step, tree(),
                      extra={"step": step, "data_step": dstate.step})

    interrupted = {"flag": False}

    def on_sigterm(signum, frame):
        interrupted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    try:
        t0 = time.time()
        losses = []
        step = start_step
        while step < args.steps:
            batch = place(make_batch(cfg, args, *pipe.batch(dstate), dev))
            for attempt in range(3):  # step retry loop
                try:
                    with implicit_replication():
                        model, opt_state, metrics = step_fn(
                            model, opt_state, batch)
                    break
                except Exception as e:  # noqa: BLE001
                    print(f"step {step} attempt {attempt} failed: {e}")
                    if attempt == 2:
                        save(step)
                        raise
            dstate = pipe.advance(dstate)
            step += 1
            loss = _scalar(metrics["loss"])
            losses.append(loss)
            if step % 10 == 0 or step == args.steps:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"lr {_scalar(metrics['lr']):.2e} "
                      f"gnorm {_scalar(metrics['grad_norm']):.3f} "
                      f"({(time.time()-t0)/max(step-start_step,1):.2f}s/step)")
            if args.ckpt_dir and step % args.ckpt_every == 0:
                save(step)
            if interrupted["flag"]:
                print("SIGTERM: checkpointing and exiting")
                save(step)
                return TrainRun(start_step, losses, dstate.step, "sigterm",
                                model, opt_state)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
    save(args.steps)
    if losses:
        print(f"final loss {np.mean(losses[-10:]):.4f} "
              f"(first 10: {np.mean(losses[:10]):.4f})")
    return TrainRun(start_step, losses, dstate.step, "done", model, opt_state)


def main(argv=None) -> int:
    run(parse(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
