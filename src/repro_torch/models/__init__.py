"""Dense decoder-only LM of the port: layer primitives (``layers``) and the
``nn.Module`` model with its reference-weight converters (``lm``)."""
