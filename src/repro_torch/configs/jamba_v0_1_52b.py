"""Jamba v0.1 52B — hybrid Mamba + attention with MoE [arXiv:2403.19887].

32 layers, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=65536.
Attention : Mamba interleave 1:7 (one attention layer per 8-layer period),
MoE (16 experts, top-2) applied every other layer.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, MambaSpec,
                                ModelConfig, register)


@register
def config() -> ModelConfig:
    # 8-layer period: attention at position 4 (as in the released model);
    # MoE on odd positions (every other layer).
    period = tuple(
        LayerSpec(
            mixer="attn" if i == 4 else "mamba",
            ffn="moe" if i % 2 == 1 else "dense",
        )
        for i in range(8)
    )
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        source="arXiv:2403.19887",
        d_model=4096,
        vocab_size=65536,
        period=period,
        repeats=4,                      # 32 layers total
        attn=AttentionSpec(num_heads=32, num_kv_heads=8, head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=14336),
        moe=FFNSpec(kind="moe", d_ff=14336, num_experts=16, top_k=2),
        mamba=MambaSpec(d_state=16, d_conv=4, expand=2),
        supports_long_context=True,     # only 4/32 layers attend; Mamba state O(1)
    )
