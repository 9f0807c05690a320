"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The ViT frontend is a STUB per instructions: input_specs() provides
precomputed patch embeddings [B, 256, d_model] consumed as a prefix.
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="internvl2-2b", family="vlm",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8,
        d_ff=8192, vocab_size=92553, head_dim=128,
        frontend="patch", frontend_len=256,
    ),
    smoke=ModelConfig(
        name="internvl2-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        frontend="patch", frontend_len=8,
    ),
    supports_long_context=False,
    source="arXiv:2404.16821; hf",
)
