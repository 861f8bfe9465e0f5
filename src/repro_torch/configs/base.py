"""Configuration dataclasses for all supported architectures.

A model is described by a *layer pattern*: an optional unrolled ``prefix`` of
:class:`LayerSpec` entries followed by a ``period`` of LayerSpecs repeated
``repeats`` times.  The periodic part is compiled with ``jax.lax.scan`` over
stacked parameters, so HLO size (and compile time) is independent of depth.

Every assigned architecture from the public pool gets one module in this
package that builds a :class:`ModelConfig` with the exact published
dimensions, plus a ``reduced()`` variant (<=2 layers, d_model<=512,
<=4 experts) used by CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Sub-specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttentionSpec:
    """GQA / MLA attention family."""
    kind: str = "gqa"                 # "gqa" | "mla"
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10_000.0
    logit_softcap: Optional[float] = None   # gemma2-style tanh cap on attn logits
    # --- MLA (deepseek-v2) ---
    q_lora_rank: int = 0              # 0 => full-rank q projection
    kv_lora_rank: int = 0             # compressed KV dimension (cache stores this)
    rope_head_dim: int = 0            # decoupled RoPE key dim (shared across heads)
    nope_head_dim: int = 0            # per-head non-RoPE dim
    v_head_dim: int = 0


@dataclass(frozen=True)
class FFNSpec:
    kind: str = "dense"               # "dense" | "moe"
    d_ff: int = 0
    activation: str = "silu"          # "silu" (gated) | "gelu" (gated)
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0       # deepseek-v2 shared experts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01     # load-balance loss coefficient


@dataclass(frozen=True)
class MambaSpec:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                  # 0 => ceil(d_model/16)


@dataclass(frozen=True)
class RWKVSpec:
    head_dim: int = 64
    decay_lora: int = 64              # rank of the data-dependent decay LoRA
    d_ffn: int = 0                    # channel-mix hidden size


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a sequence mixer followed by an FFN."""
    mixer: str = "attn"               # "attn" | "mamba" | "rwkv6"
    ffn: str = "dense"                # "dense" | "moe" | "rwkv_cm" | "none"
    window: int = 0                   # 0 = full attention; >0 = sliding window size
    cross_attn: bool = False          # enc-dec decoder layers attend to encoder memory


@dataclass(frozen=True)
class EncoderSpec:
    """Encoder stack for enc-dec models (seamless)."""
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    d_ff: int = 0


@dataclass(frozen=True)
class FrontendSpec:
    """Stubbed modality frontend: input_specs() supplies precomputed embeddings.

    ``embed_dim`` is the raw embedding size produced by the (stubbed) encoder;
    a learned linear projector maps it to d_model.  ``num_prefix`` is how many
    embedding positions are prepended to the text stream for decoder-only
    multimodal models (VLM patches); for enc-dec audio models the embeddings
    are the *encoder input* instead.
    """
    kind: str = "none"                # "none" | "vision" | "audio"
    embed_dim: int = 0
    num_prefix: int = 0               # decoder-only VLM: patches prepended


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | vlm | audio
    source: str                       # citation
    d_model: int
    vocab_size: int
    prefix: Tuple[LayerSpec, ...] = ()
    period: Tuple[LayerSpec, ...] = ()
    repeats: int = 0
    attn: AttentionSpec = field(default_factory=AttentionSpec)
    ffn: FFNSpec = field(default_factory=FFNSpec)
    moe: Optional[FFNSpec] = None     # MoE layers' FFN spec (if mixed with dense)
    mamba: Optional[MambaSpec] = None
    rwkv: Optional[RWKVSpec] = None
    encoder: Optional[EncoderSpec] = None
    frontend: FrontendSpec = field(default_factory=FrontendSpec)
    norm_eps: float = 1e-5
    final_logit_softcap: Optional[float] = None
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    dtype: str = "bfloat16"
    # which input shapes this arch supports for decode-500k (sub-quadratic rule)
    supports_long_context: bool = False

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.period) * self.repeats

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        return tuple(self.prefix) + tuple(self.period) * self.repeats

    def ffn_spec_for(self, layer: LayerSpec) -> FFNSpec:
        if layer.ffn == "moe":
            return self.moe if self.moe is not None else self.ffn
        return self.ffn

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(fn):
    """Decorator: register a zero-arg config builder under its module name."""
    name = fn.__module__.rsplit(".", 1)[-1]
    _REGISTRY[name] = fn
    return fn


def get_config(arch: str) -> ModelConfig:
    # populate registry lazily
    import importlib
    key = arch.replace("-", "_").replace(".", "_")
    if key not in _REGISTRY:
        importlib.import_module(f"repro_torch.configs.{key}")
    return _REGISTRY[key]()


ARCH_IDS = (
    "jamba_v0_1_52b",
    "stablelm_3b",
    "phi_3_vision_4_2b",
    "mixtral_8x7b",
    "starcoder2_7b",
    "seamless_m4t_large_v2",
    "rwkv6_1_6b",
    "deepseek_v2_236b",
    "granite_3_8b",
    "gemma2_27b",
)


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
    d_model = min(cfg.d_model, 256)
    heads = 4
    kv = min(4, max(1, cfg.attn.num_kv_heads * heads // max(cfg.attn.num_heads, 1)))
    attn = dataclasses.replace(
        cfg.attn, num_heads=heads, num_kv_heads=max(1, kv), head_dim=64,
        q_lora_rank=min(cfg.attn.q_lora_rank, 64) if cfg.attn.q_lora_rank else 0,
        kv_lora_rank=min(cfg.attn.kv_lora_rank, 32) if cfg.attn.kv_lora_rank else 0,
        rope_head_dim=min(cfg.attn.rope_head_dim, 16) if cfg.attn.rope_head_dim else 0,
        nope_head_dim=32 if cfg.attn.nope_head_dim else 0,
        v_head_dim=32 if cfg.attn.v_head_dim else 0,
    )

    def shrink_ffn(f: FFNSpec) -> FFNSpec:
        if f is None:
            return None
        return dataclasses.replace(
            f, d_ff=min(f.d_ff, 512),
            num_experts=min(f.num_experts, 4) if f.num_experts else 0,
            top_k=min(f.top_k, 2) if f.top_k else 0,
            num_shared_experts=min(f.num_shared_experts, 1)
            if f.num_shared_experts else 0,
        )

    mamba = dataclasses.replace(cfg.mamba, d_state=8) if cfg.mamba else None
    rwkv = (dataclasses.replace(cfg.rwkv, head_dim=32, decay_lora=16,
                                d_ffn=min(cfg.rwkv.d_ffn, 512))
            if cfg.rwkv else None)
    enc = (dataclasses.replace(cfg.encoder, num_layers=2, d_model=d_model,
                               num_heads=heads, d_ff=512)
           if cfg.encoder else None)
    fe = cfg.frontend
    if fe.kind != "none":
        fe = dataclasses.replace(fe, embed_dim=min(fe.embed_dim, 128),
                                 num_prefix=min(fe.num_prefix, 8))
    # keep the *pattern* (one period) but cap total depth at ~2 layers
    period = cfg.period if cfg.period else ()
    prefix = cfg.prefix
    if period:
        # keep at most 2 sub-layers of the period to preserve heterogeneity
        period = period[: max(1, min(2, len(period)))]
        repeats, prefix = 1, ()
    else:
        prefix, repeats = prefix[:2], 0
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", d_model=d_model,
        vocab_size=min(cfg.vocab_size, 1024),
        prefix=prefix, period=period, repeats=repeats,
        attn=attn, ffn=shrink_ffn(cfg.ffn), moe=shrink_ffn(cfg.moe),
        mamba=mamba, rwkv=rwkv, encoder=enc, frontend=fe,
    )
