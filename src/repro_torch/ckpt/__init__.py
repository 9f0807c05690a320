"""Checkpointing of the port (counterpart of ``repro/ckpt``): the atomic
save / restore of a tree of tensors in ``manager``."""
