"""seamless-m4t-large-v2 [audio] — enc-dec multimodal [arXiv:2308.11596; hf].

Backbone only: the speech frontend is a STUB — input_specs() provides
precomputed frame embeddings for the encoder.  A shape cell's seq_len is
split enc:dec = 1:1 (enc frames = dec tokens = seq_len // 2).
"""
from repro_torch.configs.base import ArchSpec, ModelConfig

SPEC = ArchSpec(
    config=ModelConfig(
        name="seamless-m4t-large-v2", family="audio",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=8192, vocab_size=256206, head_dim=64,
        enc_layers=24, frontend="frames",
    ),
    smoke=ModelConfig(
        name="seamless-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        enc_layers=2, frontend="frames",
    ),
    supports_long_context=False,
    source="arXiv:2308.11596; hf",
)
