"""Training of the port (counterpart of ``repro/train``): loss, gradients
and the optimizer step in ``step``."""
