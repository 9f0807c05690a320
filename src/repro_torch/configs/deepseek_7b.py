"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="deepseek-7b", family="dense",
        num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
        d_ff=11008, vocab_size=102400, head_dim=128,
    ),
    smoke=ModelConfig(
        name="deepseek-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
    ),
    supports_long_context=False,
    source="arXiv:2401.02954; hf",
)
