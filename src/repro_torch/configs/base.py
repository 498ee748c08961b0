"""Architecture config schema + the registry of assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | vlm | audio | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_impl: str = "scatter"        # scatter (EP at scale) | dense (smoke)
    moe_capacity_factor: float = 1.25
    # dummy experts appended so the expert dim divides the 'model' axis
    # (true EP instead of a replicated dispatch buffer) — §Perf iteration B2
    moe_pad_experts: int = 0
    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    # hybrid
    sliding_window: int = 0          # 0 = full attention
    # vlm
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    num_patches: int = 256           # stub frontend patch count
    # audio (encoder-decoder)
    encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper 30s @ 50 Hz after conv stub
    # numerics / training
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    # attention chunking for long sequences (jnp online-softmax path)
    q_chunk: int = 512
    kv_chunk: int = 1024
    # sequence positions per chunk in the chunked (vocab-parallel) CE loss
    loss_chunk: int = 512
    # residual-stream activation sharding: "none" | "sp" (sequence-parallel
    # over the 'model' axis, Megatron-SP style — shards the remat stash)
    activation_sharding: str = "none"
    # KV-cache storage: "model" dtype (bf16) | "int8" (per-token-head
    # symmetric quantization with f32 scales — halves the decode memory
    # roofline term; beyond-paper optimization, EXPERIMENTS.md §Perf)
    kv_cache_dtype: str = "model"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        """The parameters' and activations' dtype: ``"bfloat16"`` is
        ``torch.bfloat16``, ``"float32"`` ``torch.float32``, and so on."""
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")
        return dt

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so vocab-parallel sharding
        divides evenly on the 16-way model axis (Megatron-style padding)."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state or sliding-window attention."""
        return self.family in ("ssm", "hybrid")

    def param_count_estimate(self) -> int:
        """Analytic N for MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE)."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads + hd * self.num_heads * d
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            per_layer = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
        elif self.family == "moe":
            per_layer = attn + 3 * d * ff * self.moe_experts
        elif self.family == "hybrid":
            d_in = d
            ssm = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            per_layer = attn + ssm + 3 * d * ff
        else:
            per_layer = attn + 3 * d * ff
        emb = self.padded_vocab * d * 2
        enc = self.encoder_layers * (attn + 2 * d * ff)
        return L * per_layer + emb + enc

    def active_param_count_estimate(self) -> int:
        if self.family != "moe":
            return self.param_count_estimate()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        attn = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads + hd * self.num_heads * d
        per_layer = attn + 3 * d * ff * self.moe_top_k
        return L * per_layer + self.padded_vocab * d * 2
