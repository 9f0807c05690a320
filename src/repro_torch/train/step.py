"""Training step: loss, gradients, optimizer update; microbatch
accumulation.

Counterpart of ``repro/train/step.py``.  ``make_train_step`` returns a
plain eager function ``(model, opt_state, batch) -> (model, opt_state,
metrics)`` that updates the model and the state in place
(``adamw.update``); the metrics are 0-d tensors, so a step needs no host
sync.  The forward rematerialises every block as the reference's does
(``lm.forward``: only the outputs of the products without a batch
dimension are kept for the backward; ``TrainConfig.remat=False`` keeps
every activation, for comparison).  The reference also jits the step
with donated buffers, which changes no value and is not ported.  A batch
is a dict of tensors on the model's device: ``tokens`` and ``labels``
[B, S] (int), and the frontend stubs
``prefix_embeds`` / ``enc_embeds`` where the config has them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatches: int = 1           # gradient accumulation steps
    z_loss: float = 0.0             # optional logit regularizer
    moe_aux_weight: float = 0.01    # unused, as in the reference
    remat: bool = True              # False: keep every block's activations


def cross_entropy(cfg: ModelConfig, logits: torch.Tensor,
                  labels: torch.Tensor, z_loss: float = 0.0) -> torch.Tensor:
    """Mean CE over tokens in float32; padded-vocab lanes masked out."""
    vp = logits.shape[-1]
    lf = logits.to(torch.float32)
    if vp != cfg.vocab_size:
        lane = torch.arange(vp, device=lf.device)
        lf = torch.where(lane < cfg.vocab_size, lf,
                         torch.full_like(lf, -1e30))
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())
    if isinstance(gold, DTensor):
        # a gather from vocab-sharded logits is a masked partial sum:
        # reduce it at once (its mask does not follow the indexing below)
        gold = gold.redistribute(gold.device_mesh, [
            Replicate() if p.is_partial() else p for p in gold.placements])
    gold = gold[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss > 0:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    def loss_fn(model: lm.LM, batch: dict) -> torch.Tensor:
        logits = lm._forward(
            cfg, model, batch["tokens"],
            prefix_embeds=batch.get("prefix_embeds"),
            enc_embeds=batch.get("enc_embeds"), remat=tcfg.remat,
        )
        labels = batch["labels"][:, : logits.shape[1]]
        return cross_entropy(cfg, logits, labels, tcfg.z_loss)

    return loss_fn


def make_value_and_grad(cfg: ModelConfig, tcfg: TrainConfig):
    """-> ``fn(model, batch) -> (loss, {name: gradient or None})``: the
    first half of a train step.  With ``microbatches > 1`` the batch is cut
    into equal slices along dim 0, each slice's gradients are summed in
    float32, and the loss and the sums are divided by the count, as the
    reference's scan does.  On a mesh a batch-sharded input is sliced on
    each rank's own rows (microbatch i holds slice i of every rank's
    rows): the same rows over all microbatches, each microbatch sharded
    as the batch is."""
    loss_fn = make_loss_fn(cfg, tcfg)

    def value_and_grad(model: lm.LM, batch: dict):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        mb = tcfg.microbatches
        if mb == 1:
            loss = loss_fn(model, batch)
            loss.backward()
            return loss.detach(), {n: p.grad
                                   for n, p in model.named_parameters()}
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = {n: torch.zeros_like(p, dtype=torch.float32)
                 for n, p in model.named_parameters()}

        def slice_mb(x, i):
            if isinstance(x, DTensor) and Shard(0) in x.placements:
                # a batch-sharded input: slice each rank's own rows, so a
                # microbatch stays sharded (slicing the global batch would
                # gather it onto every rank)
                loc = x.to_local()
                per = loc.shape[0] // mb
                return DTensor.from_local(loc[i * per: (i + 1) * per],
                                          x.device_mesh, x.placements,
                                          run_check=False)
            per = x.shape[0] // mb
            return x[i * per: (i + 1) * per]

        for i in range(mb):
            part = loss_fn(model, {k: slice_mb(x, i)
                                   for k, x in batch.items()})
            part.backward()
            loss = loss + part.detach()
            for n, p in model.named_parameters():
                if p.grad is not None:
                    grads[n].add_(p.grad)
            model.zero_grad(set_to_none=True)
        return loss / mb, {n: g / mb for n, g in grads.items()}

    return value_and_grad


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    value_and_grad = make_value_and_grad(cfg, tcfg)

    def train_step(model: lm.LM, opt_state: dict, batch: dict):
        loss, grads = value_and_grad(model, batch)
        model, opt_state, om = adamw.update(tcfg.optimizer, grads,
                                            opt_state, model)
        return model, opt_state, {"loss": loss, **om}

    return train_step


def make_eval_step(cfg: ModelConfig, tcfg: Optional[TrainConfig] = None):
    loss_fn = make_loss_fn(cfg, tcfg or TrainConfig())

    @torch.no_grad()
    def eval_step(model: lm.LM, batch: dict) -> torch.Tensor:
        return loss_fn(model, batch)

    return eval_step
