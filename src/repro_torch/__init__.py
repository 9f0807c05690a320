"""PyTorch/CUDA port of ``repro``: the k-way set-associative cache, its
trace replay and the hand-written Hopper kernels that carry it.

Mirrors the module tree of ``repro`` (``repro_torch/core/kway.py`` is the
counterpart of ``repro/core/kway.py``, and so on) and imports neither JAX
nor anything of ``repro``.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""
