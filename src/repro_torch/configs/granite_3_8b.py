"""Granite 3.0 8B — dense GQA decoder [hf:ibm-granite/granite-3.0-2b-base family].

40 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=12800, vocab=49155.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, ModelConfig,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        source="hf:ibm-granite/granite-3.0-2b-base",
        d_model=4096,
        vocab_size=49155,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=40,
        attn=AttentionSpec(num_heads=32, num_kv_heads=8, head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=12800),
        tie_embeddings=True,
        supports_long_context=False,    # pure full attention (skip long_500k)
    )
