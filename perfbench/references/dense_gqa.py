"""What the benchmark knows of a dense GQA decoder: the check that the
port runs the configuration the file states, the weight layout the
benchmark draws, the model operations of a step's rows, and the plain
float32 reference.

The reference computes the block as the port's configuration files define
it: pre-norm RMSNorm scaled by ``1 + w``, split-half RoPE, grouped-query
causal attention scaled by ``1 / sqrt(head_dim)``, a SiLU-gated FFN, a
final RMSNorm and the logits through the LM head or the tied embedding.
It works from the weights the benchmark made (``layout``) and the token
ids alone, upcast layer by layer, with TF32 off, and imports nothing of
the program.

``lowp="fp8"`` is the control: every product's operands rounded to
float8 e4m3 (a scale per row of activations, per output column of a
weight), the rest in float32 — the precision below the configuration's
bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def check_port_config(cfg, m: Dict) -> None:
    """Refuse a port configuration (``cfg``, the port's config object) that
    is not the one the file states (``m``, its sizes with its dtype)."""
    a, f = cfg.attn, cfg.ffn
    got = {"hidden_size": cfg.d_model, "vocab_size": cfg.vocab_size,
           "num_hidden_layers": cfg.num_layers,
           "num_attention_heads": a.num_heads,
           "num_key_value_heads": a.num_kv_heads, "head_dim": a.head_dim,
           "intermediate_size": f.d_ff,
           "tie_word_embeddings": cfg.tie_embeddings,
           "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
           "dtype": cfg.dtype}
    bad = {k: (v, m[k]) for k, v in got.items() if v != m[k]}
    layers = {(s.mixer, s.ffn, s.window, s.cross_attn)
              for s in cfg.layer_specs()}
    if (bad or layers != {("attn", "dense", 0, False)} or a.kind != "gqa"
            or f.activation != "silu" or cfg.final_logit_softcap
            or a.logit_softcap):
        raise ValueError(f"the port's {cfg.name} is not the configuration "
                         f"the benchmark states: {bad or layers}")


def layout(m: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str,
                                  float]]:
    """(path, shape, dtype, std) of every leaf, as the port's parameter
    tree takes them (``params=``): ``embed [V, d]``, ``lm_head [d, V]``
    unless tied, ``final_norm [d]``, and each layer's leaves stacked
    ``[L, ...]`` under ``period/sub0``: ``norm1``, ``norm2`` (float32,
    applied as ``1 + w``), ``attn/wq [d, H, hd]``, ``attn/wk``, ``attn/wv
    [d, KV, hd]``, ``attn/wo [H, hd, d]``, ``ffn/w_in [d, 2, ff]`` (gate,
    up) and ``ffn/w_out [ff, d]``.  Projections are drawn N(0, 1/fan_in),
    the embedding N(0, 0.02^2) and the norm weights N(0, 0.1^2), so every
    norm's gain is exercised."""
    d, v, L = m["hidden_size"], m["vocab_size"], m["num_hidden_layers"]
    h, kv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    ff = m["intermediate_size"]
    dt = m["dtype"]
    leaves = [(("embed",), (v, d), dt, 0.02),
              (("final_norm",), (d,), "float32", 0.1)]
    if not m["tie_word_embeddings"]:
        leaves.append((("lm_head",), (d, v), dt, 1 / math.sqrt(d)))
    lay = ("period", "sub0")
    leaves += [
        (lay + ("norm1",), (L, d), "float32", 0.1),
        (lay + ("norm2",), (L, d), "float32", 0.1),
        (lay + ("attn", "wq"), (L, d, h, hd), dt, 1 / math.sqrt(d)),
        (lay + ("attn", "wk"), (L, d, kv, hd), dt, 1 / math.sqrt(d)),
        (lay + ("attn", "wv"), (L, d, kv, hd), dt, 1 / math.sqrt(d)),
        (lay + ("attn", "wo"), (L, h, hd, d), dt, 1 / math.sqrt(h * hd)),
        (lay + ("ffn", "w_in"), (L, d, 2, ff), dt, 1 / math.sqrt(d)),
        (lay + ("ffn", "w_out"), (L, ff, d), dt, 1 / math.sqrt(ff)),
    ]
    return leaves


def flops(m: Dict, rows: int, context_sum: int, logit_rows: int) -> int:
    """Model operations (2 per multiply-add) of ``rows`` token rows through
    all layers whose causal contexts sum to ``context_sum`` keys, and of
    ``logit_rows`` rows through the LM head: every projection and the
    gated FFN a row, QK^T and PV at 4 x heads x head_dim a (row, key)
    pair."""
    d, h, kv, hd, ff = (m["hidden_size"], m["num_attention_heads"],
                        m["num_key_value_heads"], m["head_dim"],
                        m["intermediate_size"])
    per_row = 2 * (d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * ff)
    layers = per_row * rows + 4 * h * hd * context_sum
    return (m["num_hidden_layers"] * layers
            + 2 * d * m["vocab_size"] * logit_rows)


def _fp8(x, dim: int):
    """``x`` rounded to float8 e4m3 with a scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(a, w, lowp: Optional[str]):
    """a [S, k] @ w [k, n] in float32."""
    if lowp == "fp8":
        a, w = _fp8(a, -1), _fp8(w, 0)
    return a @ w


def _rms(x, w, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1 + w)


def _rope(x, pos, theta: float):
    """Split-half RoPE; x [S, H, hd], pos [S]."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = pos[:, None].float() * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, lowp: Optional[str], block: int):
    """Causal GQA attention; q [S, H, hd], k/v [S, KV, hd] -> [S, H*hd],
    in blocks of ``block`` query rows."""
    s, h, hd = q.shape
    kv = k.shape[1]
    if lowp == "fp8":
        q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
    qg = q.view(s, kv, h // kv, hd).permute(1, 2, 0, 3)     # [KV, G, S, hd]
    kt = k.permute(1, 2, 0)                                  # [KV, hd, S]
    vt = v.permute(1, 0, 2)                                  # [KV, S, hd]
    out = torch.empty(kv, h // kv, s, hd, device=q.device)
    keys = torch.arange(s, device=q.device)
    for r0 in range(0, s, block):
        r1 = min(s, r0 + block)
        sc = (qg[:, :, r0:r1] @ kt[:, None]) / hd ** 0.5     # [KV,G,B,S]
        rows = torch.arange(r0, r1, device=q.device)
        sc = sc.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        out[:, :, r0:r1] = torch.softmax(sc, dim=-1) @ vt[:, None]
    return out.permute(2, 0, 1, 3).reshape(s, h * hd)


@torch.no_grad()
def logits(w: Dict, m: Dict, tokens, want, *, lowp: Optional[str] = None,
           block: int = 512):
    """float32 logits [len(want), V] at positions ``want`` of the sequence
    ``tokens`` [S] (each position sees itself and what precedes it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = m["hidden_size"]
    h, kv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                 m["head_dim"])
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    x = w["embed"][tokens].float()
    lay = w["period"]["sub0"]
    for i in range(m["num_hidden_layers"]):
        a = lay["attn"]
        y = _rms(x, lay["norm1"][i].float(), eps)
        q = _mm(y, a["wq"][i].float().reshape(d, h * hd), lowp).view(s, h, hd)
        k = _mm(y, a["wk"][i].float().reshape(d, kv * hd), lowp).view(s, kv, hd)
        v = _mm(y, a["wv"][i].float().reshape(d, kv * hd), lowp).view(s, kv, hd)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        o = _attention(q, k, v, lowp, block)
        x = x + _mm(o, a["wo"][i].float().reshape(h * hd, d), lowp)
        y = _rms(x, lay["norm2"][i].float(), eps)
        f = lay["ffn"]
        gu = _mm(y, f["w_in"][i].float().reshape(d, -1), lowp)
        gate, up = gu.view(s, 2, -1).unbind(1)
        x = x + _mm(F.silu(gate) * up, f["w_out"][i].float(), lowp)
    y = _rms(x[want], w["final_norm"].float(), eps)
    head = (w["embed"].float().t() if m["tie_word_embeddings"]
            else w["lm_head"].float())
    return _mm(y, head, lowp)
