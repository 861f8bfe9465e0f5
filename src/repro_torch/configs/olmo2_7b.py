"""OLMo 2 7B Instruct — the model used in the paper's vLLM case study
[hf:allenai/OLMo-2-1124-7B-Instruct].

32 layers, d_model=4096, 32 heads (MHA), d_ff=11008, vocab=100352.
Not part of the assigned pool; included because the paper's Table 2 serves it.
"""
from repro_torch.configs.base import (AttentionSpec, FFNSpec, LayerSpec, ModelConfig,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="olmo2-7b",
        family="dense",
        source="hf:allenai/OLMo-2-1124-7B-Instruct",
        d_model=4096,
        vocab_size=100352,
        period=(LayerSpec(mixer="attn", ffn="dense"),),
        repeats=32,
        attn=AttentionSpec(num_heads=32, num_kv_heads=32, head_dim=128),
        ffn=FFNSpec(kind="dense", d_ff=11008),
        supports_long_context=False,
    )
