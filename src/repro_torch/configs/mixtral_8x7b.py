"""Mixtral 8x7B — sparse MoE with sliding-window attention [arXiv:2401.04088].

32 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=32000,
8 experts top-2 on every layer, SWA window=4096.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, ModelConfig,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        source="arXiv:2401.04088",
        d_model=4096,
        vocab_size=32000,
        period=(LayerSpec(mixer="attn", ffn="moe", window=4096),),
        repeats=32,
        attn=AttentionSpec(num_heads=32, num_kv_heads=8, head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=14336),
        moe=FFNSpec(kind="moe", d_ff=14336, num_experts=8, top_k=2),
        supports_long_context=True,     # SWA caps the KV cache at window size
    )
