"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (patch frontend stubbed).
[arXiv:2409.12191; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128, qkv_bias=True,
    mrope=True, mrope_sections=(16, 24, 24), num_patches=256,
    rope_theta=1e6,
)
