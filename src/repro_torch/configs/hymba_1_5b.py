"""hymba-1.5b [hybrid] — parallel attention + mamba heads, sliding-window
attention (meta tokens omitted; see DESIGN.md). [arXiv:2411.13676; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_head_dim=64, sliding_window=1024,
)
