"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768, head_dim=128,
        num_experts=8, top_k=2, sliding_window=4096, moe_ff_shards=2,
        rope_theta=1e6,
    ),
    smoke=ModelConfig(
        name="mixtral-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        num_experts=4, top_k=2, sliding_window=32,
    ),
    supports_long_context=True,  # SWA bounds live attention state
    source="arXiv:2401.04088; hf",
)
