"""Optimizers of the port (counterpart of ``repro/optim``): AdamW with
float32 master weights in ``adamw``."""
