"""Phi-3-vision 4.2B — VLM: phi3-mini backbone + CLIP frontend (stubbed)
[hf:microsoft/Phi-3-vision-128k-instruct].

32 layers, d_model=3072, 32 heads (GQA kv=32), d_ff=8192, vocab=32064.
The CLIP vision encoder is a STUB: input_specs() supplies precomputed patch
embeddings (CLIP ViT-L/14 width=1024) which a learned projector maps to
d_model and prepends to the token stream.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, FrontendSpec, LayerSpec,
                                ModelConfig, register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        source="hf:microsoft/Phi-3-vision-128k-instruct",
        d_model=3072,
        vocab_size=32064,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=32,
        attn=AttentionSpec(num_heads=32, num_kv_heads=32, head_dim=96),
        ffn=FFNSpec(kind="dense", d_ff=8192),
        frontend=FrontendSpec(kind="vision", embed_dim=1024, num_prefix=576),
        supports_long_context=False,    # dense full-attention backbone
    )
