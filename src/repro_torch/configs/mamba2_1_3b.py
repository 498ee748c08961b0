"""mamba2-1.3b [ssm] — SSD, attention-free. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=0, vocab_size=50280, head_dim=64,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64,
)
