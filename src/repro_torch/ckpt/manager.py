"""Fault-tolerant checkpointing: atomic commits of a tree of tensors.

Counterpart of ``repro/ckpt/manager.py``.  Layout of one checkpoint::

    <dir>/step_000000042/
        manifest.json        # paths, shapes, dtypes, step, extra
        leaf_00000.npy ...   # one file per tensor leaf

Guarantees, as in the reference:
  * **atomicity**: written to ``step_N.tmp`` then ``os.rename``d, so a
    crash mid-write never corrupts the latest committed checkpoint;
    ``commit=False`` leaves the ``.tmp`` behind (the fault injector's
    crash-mid-commit hook), which ``latest_step`` and ``restore`` ignore;
  * **restart**: ``latest_step`` finds the newest committed step; the
    caller's host state rides in the manifest's ``extra``;
  * **retention**: ``keep_last`` committed steps are kept.

A tree is a dataclass of tensors (``ServeState``, ``KWayState``,
``TinyLFUState``; nested dataclasses and dicts too), flattened by field
name into paths such as ``.kstate.keys``; a ``None`` field is no leaf.  An
``nn.Module`` (the trainer's model) is flattened by its
``named_parameters()``, paths such as ``['params'].blocks.0.attn.wq``.
numpy has no bfloat16, so a bf16 leaf is saved as its ``uint16`` view with
``bfloat16`` named in the manifest and restored bit for bit.
``restore(like_tree)`` copies into ``like_tree``'s tensors in place (the
addresses a captured CUDA graph reads stay valid) and returns it.

On a mesh (the trainer's DTensors) every rank calls ``save`` and
``restore``: a DTensor leaf is saved as its full tensor (gathered on every
rank; rank 0 writes the files), and restored onto the placements of the
``like_tree``'s DTensor, each rank copying its own slice of the full
array.  So a checkpoint saved on one mesh, or on one device, restores onto
another mesh: the elastic restart.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

_BF16 = "bfloat16"


def _leaf_name(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def flatten(tree, prefix: str = "") -> list:
    """-> [(path, tensor)] in field order; ``None`` fields are skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, nn.Module):
        return [(f"{prefix}.{name}", p)
                for name, p in tree.named_parameters()]
    if dataclasses.is_dataclass(tree):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in flatten(getattr(tree, f.name),
                                    f"{prefix}.{f.name}")]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in flatten(tree[k], f"{prefix}[{k!r}]")]
    raise TypeError(f"checkpoint leaf {prefix!r} is a {type(tree).__name__},"
                    " not a tensor, module, dataclass or dict")


def _writer() -> bool:
    """Rank 0 writes (every process, off a process group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_numpy(t: torch.Tensor) -> tuple:
    """-> (array, dtype name) with bf16 as its uint16 view; a DTensor as
    its full tensor."""
    t = t.detach()
    if isinstance(t, DTensor):
        t = t.full_tensor()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
    arr = t.cpu().numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(root: str, step: int, tree, extra: dict | None = None,
         keep_last: int = 3, commit: bool = True) -> str:
    """Atomically persist a tree of tensors.  Returns the committed
    directory, or with ``commit=False`` the ``.tmp`` one: every leaf lands
    on disk but the atomic rename is skipped (a crash before the commit)."""
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    if not _writer():
        for _, leaf in flatten(tree):   # take part in every leaf's gather
            _to_numpy(leaf)
        dist.barrier()                  # rank 0 has committed
        return final if commit else tmp
    os.makedirs(root, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = flatten(tree)
    paths, shapes, dtypes = [], [], []
    for i, (path, leaf) in enumerate(flat):
        arr, dtype = _to_numpy(leaf)
        np.save(os.path.join(tmp, _leaf_name(i)), arr)
        paths.append(path)
        shapes.append(list(arr.shape))
        dtypes.append(dtype)
    manifest = {"step": step, "num_leaves": len(flat), "paths": paths,
                "shapes": shapes, "dtypes": dtypes, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if commit:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        _gc(root, keep_last)
    if dist.is_initialized():
        dist.barrier()
    # without the commit the rename is skipped: a crash before it, so the
    # checkpoint never happened
    return final if commit else tmp


def latest_step(root: str) -> int | None:
    if not os.path.isdir(root):
        return None
    steps = []
    for d in os.listdir(root):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(root, d, "manifest.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(root: str, step: int, like_tree):
    """Load a committed checkpoint into ``like_tree``'s tensors, in place.
    Every leaf is checked against the manifest (path, shape) before any is
    written.  Returns (like_tree, extra)."""
    d = os.path.join(root, f"step_{step:09d}")
    if not os.path.isdir(d):
        raise ValueError(
            f"no committed checkpoint step_{step:09d} under {root!r} "
            f"(latest committed: {latest_step(root)})")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = flatten(like_tree)
    paths = [p for p, _ in flat]
    ck_paths = manifest["paths"]
    if ck_paths != paths:
        missing = [p for p in paths if p not in ck_paths]
        extra_l = [p for p in ck_paths if p not in paths]
        raise ValueError(
            f"checkpoint {d} does not match the target structure: "
            f"missing from checkpoint: {missing or 'none'}; "
            f"extra in checkpoint: {extra_l or 'none'}"
            + ("" if missing or extra_l else
               f"; leaf order differs: {ck_paths} vs {paths}"))
    for i, (path, dst) in enumerate(flat):
        if tuple(manifest["shapes"][i]) != tuple(dst.shape):
            raise ValueError(
                f"checkpoint {d} leaf {path!r} has shape "
                f"{tuple(manifest['shapes'][i])}, target expects "
                f"{tuple(dst.shape)}")
    with torch.no_grad():     # a trainer's parameters require grad
        for i, (path, dst) in enumerate(flat):
            src = _from_numpy(np.load(os.path.join(d, _leaf_name(i))),
                              manifest["dtypes"][i])
            if isinstance(dst, DTensor):   # this rank's slice, no collective
                src = distribute_tensor(
                    src.to(dst.device), dst.device_mesh, dst.placements,
                    src_data_rank=None).to_local()
                dst = dst.to_local()
            dst.copy_(src)
    return like_tree, manifest["extra"]


def _gc(root: str, keep_last: int):
    steps = sorted(
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)
