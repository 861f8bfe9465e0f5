"""StableLM 3B — dense decoder [hf:stabilityai/stablelm-2-1_6b family].

32 layers, d_model=2560, 32 heads (GQA kv=32 => MHA), d_ff=6912, vocab=50304.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, ModelConfig,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        source="hf:stabilityai/stablelm-2-1_6b",
        d_model=2560,
        vocab_size=50304,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=32,
        attn=AttentionSpec(num_heads=32, num_kv_heads=32, head_dim=80),
        ffn=FFNSpec(kind="dense", d_ff=6912),
        supports_long_context=False,    # pure full attention (skip long_500k)
    )
