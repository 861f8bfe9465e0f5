"""Plain PyTorch paged attention (ragged mixed prefill+decode): the twin of
``repro/kernels/paged_attention/ref.py`` and the CUDA kernel's plain
version.

The general entry point is :func:`paged_attention_mixed_ref`: every batch
lane carries ``q_len >= 1`` query rows and a per-row *sequence position*;
causality is enforced inside the page walk by masking every key slot past
the row's position.  :func:`paged_attention_ref` is the ``q_len=1`` case.

Pages may be int8 with per-page-row scales ``[P, page, KV]``: gathered
pages are dequantized after the gather, so only the pages a lane touches
pay the dequant.
"""
from __future__ import annotations

import torch

_NEG_INF = -2.0e38


def _gather_pages(pages, block_tables, scales):
    """pages[block_tables] -> [B, PPS*page, KV, hd] in f32, dequantized."""
    b, pps = block_tables.shape
    page, kv, hd = pages.shape[1], pages.shape[2], pages.shape[3]
    idx = block_tables.long()
    g = pages[idx].reshape(b, pps * page, kv, hd).float()
    if scales is not None:
        s = scales[idx].reshape(b, pps * page, kv)
        g = g * s.float()[..., None]
    return g


def paged_attention_mixed_ref(q, k_pages, v_pages, block_tables, q_positions,
                              *, scale=None, k_scales=None, v_scales=None):
    """Ragged multi-row attention over a paged KV cache.

    q            [B, Q, H, hd]      (pad rows are harmless: position 0)
    k_pages      [P, page, KV, hd]  (global page pool; int8 if *_scales)
    v_pages      [P, page, KV, hd]
    block_tables [B, PPS] int32     (page ids per sequence)
    q_positions  [B, Q] int32       (row i attends key slots t <= pos[i])
    k_scales     [P, page, KV] f32  (optional int8 per-page-row scales)
    v_scales     [P, page, KV] f32
    Returns      [B, Q, H, hd] in q's dtype
    """
    b, qn, h, hd = q.shape
    kv = k_pages.shape[2]
    g = h // kv
    if scale is None:
        scale = 1.0 / float(hd) ** 0.5
    k = _gather_pages(k_pages, block_tables, k_scales)
    v = _gather_pages(v_pages, block_tables, v_scales)
    t = k.shape[1]
    qg = q.reshape(b, qn, kv, g, hd).float()
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k) * scale
    pos_k = torch.arange(t, dtype=torch.int32, device=q.device)
    mask = pos_k[None, None] <= q_positions[:, :, None]      # [B, Q, T]
    mask = mask[:, None, None]                               # [B,1,1,Q,T]
    s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, torch.zeros_like(p))
    p = p / (p.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bkgqt,btkh->bqkgh", p, v)
    return out.reshape(b, qn, h, hd).to(q.dtype)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                        scale=None, k_scales=None, v_scales=None):
    """Single-token decode: q [B, H, hd], lengths [B] (>= 1) -> [B, H, hd]."""
    qpos = (lengths - 1)[:, None].to(torch.int32)
    out = paged_attention_mixed_ref(q[:, None], k_pages, v_pages, block_tables,
                                    qpos, scale=scale, k_scales=k_scales,
                                    v_scales=v_scales)
    return out[:, 0]
