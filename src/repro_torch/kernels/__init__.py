"""Hand-written CUDA kernels of the port (sm_90a) and their plain versions.

    kway_probe — kernels 1 and 2: batched set probe + victim order, and the
                 fused probe of ``access``, one launch each with the
                 route inside (csrc/kway_probe.cu)
    replay     — kernel 3: a whole chunked trace in one launch, flat, TTL
                 or TinyLFU (csrc/replay.cu); kernel 4: the same through
                 the L1-over-L2 hierarchy (csrc/replay_hier.cu)
    paged_attention — kernel 5: one paged GQA decode step
                 (csrc/paged_attention.cu)
    adamw      — the optimizer's passes over every leaf, the gradients'
                 sum of squares and the AdamW update, as torch.library
                 ops (csrc/adamw.cu; no Pallas counterpart)
    ops        — the wrappers the backends and the serving model call
    ref        — plain torch versions of kernels 1, 2 and 5
    _build     — nvcc build into kernels/.build/ and ctypes loading
"""
