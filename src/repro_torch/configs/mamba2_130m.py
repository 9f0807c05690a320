"""mamba2-130m [ssm] — SSD, attention-free [arXiv:2405.21060; unverified].

The paper's KV-page-cache technique is INAPPLICABLE here (no KV pages) —
see DESIGN.md §4.  Implemented without it; the K-way cache still serves this
arch as a host-side object cache in the serving examples.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="mamba2-130m", family="ssm",
        num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ),
    smoke=ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16,
    ),
    supports_long_context=True,  # O(1) state
    source="arXiv:2405.21060; unverified",
)
