"""gemma2-2b [dense] — local+global alternating, logit softcaps [arXiv:2408.00118]."""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="gemma2-2b", family="dense",
        num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
        d_ff=9216, vocab_size=256000, head_dim=256,
        alt_local_global=True, sliding_window=4096,
        attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="gemma2-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        alt_local_global=True, sliding_window=32,
        attn_softcap=50.0, final_softcap=30.0, tie_embeddings=True,
    ),
    supports_long_context=True,  # half the layers are sliding-window
    source="arXiv:2408.00118; hf",
)
