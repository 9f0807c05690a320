"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="hymba-1.5b", family="hybrid",
        num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
        d_ff=5504, vocab_size=32001, head_dim=64,
        ssm_state=16, ssm_expand=2, ssm_head_dim=64,
        sliding_window=1024,  # hymba: SWA on most attention layers
    ),
    smoke=ModelConfig(
        name="hymba-smoke", family="hybrid",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        ssm_state=8, ssm_expand=2, ssm_head_dim=16, sliding_window=32,
    ),
    supports_long_context=True,  # SSM + sliding-window attention
    source="arXiv:2411.13676; hf",
)
