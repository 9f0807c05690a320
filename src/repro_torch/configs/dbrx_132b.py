"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10752, vocab_size=100352, head_dim=128,
        num_experts=16, top_k=4, rope_theta=5e5,
    ),
    smoke=ModelConfig(
        name="dbrx-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=512, head_dim=16,
        num_experts=8, top_k=4,
    ),
    supports_long_context=False,  # pure full attention — long_500k skipped
    source="hf:databricks/dbrx-base; unverified",
)
