"""SeamlessM4T-large v2 — encoder-decoder multimodal translation
[arXiv:2308.11596].

24 layers (24 enc + 24 dec), d_model=1024, 16 heads (GQA kv=16), d_ff=8192,
vocab=256206.  The mel-spectrogram + conformer feature frontend is a STUB:
input_specs() supplies precomputed frame embeddings (w2v-BERT width=1024)
fed to the text-translation encoder; the decoder cross-attends to encoder
memory.
"""
from repro_torch.configs.base import (AttentionSpec, EncoderSpec, FFNSpec,
                                FrontendSpec, LayerSpec, ModelConfig, register)


@register
def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        source="arXiv:2308.11596",
        d_model=1024,
        vocab_size=256206,
        period=(LayerSpec(mixer="attn", ffn="dense", cross_attn=True),),
        repeats=24,
        attn=AttentionSpec(num_heads=16, num_kv_heads=16, head_dim=64),
        ffn=FFNSpec(kind="dense", d_ff=8192, activation="gelu"),
        encoder=EncoderSpec(num_layers=24, d_model=1024, num_heads=16, d_ff=8192),
        frontend=FrontendSpec(kind="audio", embed_dim=1024, num_prefix=0),
        supports_long_context=False,    # enc-dec full attention; 500k decode out of envelope
    )
