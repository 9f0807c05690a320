"""stablelm-3b [dense] [hf:stabilityai/stablelm-2-1_6b family; unverified]."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="stablelm-3b", family="dense",
        num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=6912, vocab_size=50304, head_dim=80,
    ),
    smoke=ModelConfig(
        name="stablelm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
    ),
    supports_long_context=False,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
