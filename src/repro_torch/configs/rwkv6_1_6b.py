"""RWKV-6 (Finch) 1.6B — attention-free RNN with data-dependent decay
[arXiv:2404.05892].

24 layers, d_model=2048, d_ffn=7168, vocab=65536, head_dim=64 (32 heads).
"""
from repro_torch.configs.base import (FFNSpec, LayerSpec, ModelConfig, RWKVSpec,
                                register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        source="arXiv:2404.05892",
        d_model=2048,
        vocab_size=65536,
        period=(LayerSpec(mixer="rwkv6", ffn="rwkv_cm"),),
        repeats=24,
        ffn=FFNSpec(kind="dense", d_ff=7168),   # channel-mix hidden size
        rwkv=RWKVSpec(head_dim=64, decay_lora=64, d_ffn=7168),
        supports_long_context=True,     # O(1) recurrent state
    )
