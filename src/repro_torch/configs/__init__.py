"""Assigned-architecture configs (--arch <id> selectable)."""
from .base import ModelConfig
from .granite_20b import CONFIG as granite_20b
from .granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m
from .hymba_1_5b import CONFIG as hymba_1_5b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .mamba2_1_3b import CONFIG as mamba2_1_3b
from .mistral_large_123b import CONFIG as mistral_large_123b
from .qwen1_5_0_5b import CONFIG as qwen1_5_0_5b
from .qwen2_5_14b import CONFIG as qwen2_5_14b
from .qwen2_vl_2b import CONFIG as qwen2_vl_2b
from .whisper_base import CONFIG as whisper_base

ARCHITECTURES = {
    c.name: c
    for c in [
        llama4_scout_17b_a16e, granite_moe_3b_a800m, qwen1_5_0_5b,
        mistral_large_123b, granite_20b, qwen2_5_14b, mamba2_1_3b,
        qwen2_vl_2b, whisper_base, hymba_1_5b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


# Input-shape cells assigned to the LM family (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    import dataclasses

    small = dict(
        num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128, vocab_size=256, head_dim=16,
        moe_experts=min(cfg.moe_experts, 4) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_layers else 1500,
        num_patches=4 if cfg.family == "vlm" else cfg.num_patches,
        sliding_window=8 if cfg.sliding_window else 0,
        mrope_sections=(2, 3, 3) if cfg.mrope else cfg.mrope_sections,
        dtype="float32", remat="none", q_chunk=16, kv_chunk=16,
        moe_impl="dense",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
