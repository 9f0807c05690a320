"""minicpm-2b [dense] — llama-like arch, WSD schedule [arXiv:2404.06395; hf]."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="minicpm-2b", family="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753, head_dim=64,
        tie_embeddings=True, scale_emb=12.0,
    ),
    smoke=ModelConfig(
        name="minicpm-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        tie_embeddings=True, scale_emb=12.0,
    ),
    supports_long_context=False,
    source="arXiv:2404.06395; hf",
)
