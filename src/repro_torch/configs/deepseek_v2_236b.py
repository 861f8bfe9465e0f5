"""DeepSeek-V2 236B — MLA + fine-grained MoE [arXiv:2405.04434].

60 layers, d_model=5120, 128 heads, MLA kv_lora=512 (decoupled RoPE dim 64,
nope head dim 128, v head dim 128, q_lora 1536), per-expert d_ff=1536,
vocab=102400, 2 shared + 160 routed experts, top-6.  First layer uses a dense
FFN (d_ff=12288), as in the released model.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, ModelConfig,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        d_model=5120,
        vocab_size=102400,
        prefix=(LayerSpec(mixer="attn", ffn="dense"),),
        period=(LayerSpec(mixer="attn", ffn="moe"),),
        repeats=59,
        attn=AttentionSpec(
            kind="mla", num_heads=128, num_kv_heads=128, head_dim=128,
            q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
            nope_head_dim=128, v_head_dim=128,
        ),
        ffn=FFNSpec(kind="dense", d_ff=12288),
        moe=FFNSpec(kind="moe", d_ff=1536, num_experts=160, top_k=6,
                    num_shared_experts=2),
        supports_long_context=True,     # MLA compressed cache: 576 floats/token/layer
    )
