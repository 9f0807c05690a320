"""What the cache drivers share: the cache under test built from a
configuration file, and the comparison of its state with the reference's.

Configuration keys: ``num_sets``, ``ways``, ``policy`` (the reference
holds LRU), ``backend`` (the program's backend name)."""
from __future__ import annotations

import torch

LANES = ("keys", "fprint", "vals", "meta_a", "meta_b")


def build_backend(config: dict, device):
    """-> (KWayConfig, the program's CacheBackend) for ``config``."""
    from repro_torch.core.backend import make_backend
    from repro_torch.core.kway import KWayConfig
    from repro_torch.core.policies import Policy
    if config["policy"] != "LRU":
        raise ValueError("the plain reference holds the LRU policy only")
    kcfg = KWayConfig(num_sets=config["num_sets"], ways=config["ways"],
                      policy=Policy.parse(config["policy"]))
    return kcfg, make_backend(config["backend"], kcfg, device)


def state_mismatch(state, ref, g: int = 0) -> int:
    """Words of the program's cache ``state`` that differ from reference
    cache ``g``, its clock counted as one word."""
    want = ref.lanes(g)
    n = sum(int((getattr(state, f).to(want[f].device) != want[f]).sum())
            for f in LANES)
    clock = int(torch.as_tensor(state.clock).reshape(()))
    return n + int(clock != ref.clock_of(g))
