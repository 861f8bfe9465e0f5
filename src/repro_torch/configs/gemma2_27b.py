"""Gemma 2 27B — local/global alternating attention with logit softcaps
[arXiv:2408.00118].

46 layers, d_model=4608, 32 heads (GQA kv=16), d_ff=36864, vocab=256000.
Alternating sliding-window (4096) and global layers; attention logit
softcap 50, final logit softcap 30.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, ModelConfig,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-27b",
        family="dense",
        source="arXiv:2408.00118",
        d_model=4608,
        vocab_size=256000,
        period=(
            LayerSpec(mixer="attn", ffn="dense", window=4096),  # local
            LayerSpec(mixer="attn", ffn="dense", window=0),     # global
        ),
        repeats=23,
        attn=AttentionSpec(num_heads=32, num_kv_heads=16, head_dim=128,
                           logit_softcap=50.0),
        ffn=FFNSpec(kind="dense", d_ff=36864, activation="gelu"),
        final_logit_softcap=30.0,
        tie_embeddings=True,
        # half the layers are W=4096 local; global KV cache sharded over data(seq)
        supports_long_context=True,
    )
