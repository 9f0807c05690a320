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
    """Mean CE over tokens in float32; padded-vocab lanes masked out.
    Logits sharded on the vocabulary over the ``model`` axis of a mesh take
    the vocabulary-parallel form (``_vocab_parallel``): no rank holds more
    than its own lanes, in the loss or its backward."""
    if _vocab_axis(logits) is not None:
        lse, gold = _vocab_parallel(cfg, logits, labels)
    else:
        vp = logits.shape[-1]
        lf = logits.to(torch.float32)
        if vp != cfg.vocab_size:
            lane = torch.arange(vp, device=lf.device)
            lf = torch.where(lane < cfg.vocab_size, lf,
                             torch.full_like(lf, -1e30))
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[..., None].long())
        if isinstance(gold, DTensor):
            # a gather from vocab-sharded logits (a model axis of one) is
            # a masked partial sum: reduce it at once (its mask does not
            # follow the indexing below)
            gold = gold.redistribute(gold.device_mesh, [
                Replicate() if p.is_partial() else p
                for p in gold.placements])
        gold = gold[..., 0]
    loss = torch.mean(lse - gold)
    if z_loss > 0:
        loss = loss + z_loss * torch.mean(torch.square(lse))
    return loss


def _vocab_axis(logits):
    """The mesh dimension over which ``logits`` (a DTensor) are sharded on
    the vocabulary, if it is the ``model`` axis and larger than 1; else
    None."""
    if not isinstance(logits, DTensor):
        return None
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return None
    axis = names.index("model")
    if mesh.size(axis) == 1 or \
            logits.placements[axis] != Shard(logits.ndim - 1):
        return None
    return axis


def _vocab_parallel(cfg: ModelConfig, logits, labels):
    """(lse, gold) [B, S] of vocabulary-sharded logits, each rank on its
    own [b, S, V / m] lanes: the reference's ``cross_entropy`` as its
    partitioner runs it on a model-sharded vocabulary.  Both results are
    batch-sharded as the logits' rows and replicated over ``model``."""
    axis = _vocab_axis(logits)
    mesh = logits.device_mesh
    rows = [Replicate() if m == axis else p
            for m, p in enumerate(logits.placements)]
    local = logits.to_local()
    v0 = mesh.get_local_rank(axis) * local.shape[-1]
    lab = labels.redistribute(mesh, rows).to_local()
    lse, gold = _VocabParallelCE.apply(local, lab, v0, cfg.vocab_size,
                                       (mesh, axis))
    return tuple(DTensor.from_local(t, mesh, rows, run_check=False)
                 for t in (lse, gold))


class _VocabParallelCE(torch.autograd.Function):
    """Per-token log-sum-exp and gold logit of one rank's vocabulary
    shard ``x`` [b, S, Vl] (lanes v0 .. v0 + Vl of the padded vocabulary),
    in float32.  Forward: the padded lanes masked by global index, the
    local max all-reduced (MAX) over the model axis, the local sum of
    exp all-reduced (SUM), the gold logit gathered where the label falls
    in this shard and all-reduced (SUM): three collectives.  Backward:
    ``softmax * g_lse + onehot * g_gold`` on the local lanes alone (no
    collective; with the mean's ``g`` / N that is (softmax - onehot) g / N).
    """

    @staticmethod
    def forward(ctx, x, labels, v0: int, vocab: int, group):
        lf = _masked_f32(x, v0, vocab)
        mx = _all_reduce(lf.amax(dim=-1), "max", group)
        se = _all_reduce(torch.exp(lf - mx[..., None]).sum(dim=-1), "sum",
                         group)
        lse = torch.log(se) + mx
        idx, inside = _label_lanes(labels, v0, lf.shape[-1])
        gold = torch.gather(lf, -1, idx[..., None])[..., 0]
        gold = _all_reduce(torch.where(inside, gold, 0.0), "sum", group)
        ctx.save_for_backward(x, labels, lse)
        ctx.v0, ctx.vocab = v0, vocab
        return lse, gold

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        x, labels, lse = ctx.saved_tensors
        p = _masked_f32(x, ctx.v0, ctx.vocab)
        p.sub_(lse[..., None]).exp_().mul_(g_lse[..., None])
        idx, inside = _label_lanes(labels, ctx.v0, p.shape[-1])
        p.scatter_add_(-1, idx[..., None],
                       torch.where(inside, g_gold, 0.0)[..., None])
        return p.to(x.dtype), None, None, None, None


def _all_reduce(t, op: str, group):
    """A functional all-reduce over ``group`` ((mesh, mesh dimension)),
    waited for: a plain tensor."""
    from torch.distributed import _functional_collectives as fc

    out = fc.all_reduce(t, op, group)
    return out.wait() if isinstance(out, fc.AsyncCollectiveTensor) else out


def _masked_f32(x, v0: int, vocab: int):
    """A float32 copy of the shard ``x`` with its lanes past the
    vocabulary (global lane v0 + i >= vocab) at -1e30."""
    lf = x.to(torch.float32, copy=True)
    if v0 + lf.shape[-1] > vocab:
        lane = torch.arange(v0, v0 + lf.shape[-1], device=lf.device)
        lf.masked_fill_(lane >= vocab, -1e30)
    return lf


def _label_lanes(labels, v0: int, width: int):
    """(local lane [b, S] int64 clamped into the shard, bool: the label is
    one of the shard's lanes)."""
    rel = labels.long() - v0
    inside = (rel >= 0) & (rel < width)
    return rel.clamp(0, width - 1), inside


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
