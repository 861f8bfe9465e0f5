"""StarCoder2 7B — dense code model, GQA + RoPE + sliding window
[arXiv:2402.19173].

32 layers (the 7B model card lists 32), d_model=4608, 36 heads (GQA kv=4),
d_ff=18432, vocab=49152, SWA window=4096.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, ModelConfig,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        source="arXiv:2402.19173",
        d_model=4608,
        vocab_size=49152,
        period=(LayerSpec(mixer="attn", ffn="dense", window=4096),),
        repeats=32,
        attn=AttentionSpec(num_heads=36, num_kv_heads=4, head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=18432, activation="gelu"),
        supports_long_context=True,     # SWA caps the KV cache at window size
    )
