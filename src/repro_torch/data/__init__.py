"""Training data of the port (counterpart of ``repro/data``): the
synthetic, shard-aware pipeline in ``pipeline``."""
