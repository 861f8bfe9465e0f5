"""Mixture-of-Experts FFN with sort-based (permutation) token dispatch: the
PyTorch twin of ``repro/models/moe.py``.

Flatten the (token, choice) pairs, stable-sort them by expert id, give each
pair its slot within its expert's segment (rank minus the segment's first
index, by ``searchsorted``), drop the pairs past the capacity into a
sacrificial slot, gather the tokens into an ``[E, C, d]`` buffer, run every
expert's gated MLP as a batched product and gather the results back,
weighted by the renormalised gates.  The sort is stable and the capacity
rule is the reference's, so the same pairs are dropped as in JAX.  The
expert products are plain products (JAX leaves them to XLA, outside any
Pallas kernel).  DeepSeek-V2 shared experts run densely on every token.

Routing is global in the reference: the capacity, the load-balance
loss's means and the dispatch ranks are taken over the whole batch's
tokens.  On a sharded step (``part``, ``models/partition.py``) every rank
gathers the rows of every row rank (in the order of the global batch;
the gather's backward reduce-scatters the cotangent back to each rank's
rows) and routes them all alike.  The ``[E, C, d]`` buffer is then split
as the policy's ``moe_buf`` says: experts over ``model`` where the
experts' leaves are split so (else each expert's ``d_ff`` is split over
``model``, tensor-parallel within the expert, as the leaves' ``alt``
says), capacity slots over the batch axes (padded to a multiple of their
ranks with the sentinel's zero row).  Each rank computes only its block
and combines, for every token, the share of its output that the block
holds; the shares meet in a reduce-scatter over the batch axes, which
brings each token's output back to the rank that owns its row, and a sum
over ``model``.  Shared experts run column- then row-parallel on the
rank's own rows.  Without ``part`` nothing is gathered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FFNSpec, ModelConfig
from repro_torch.launch import collectives as coll
from repro_torch.models.common import act_fn, einsum
from repro_torch.models.params import P


def moe_plan(cfg: ModelConfig, spec: FFNSpec) -> dict:
    d = cfg.d_model
    plan = {
        "router": P((d, spec.num_experts), dtype="float32", init="small",
                     pspec=("data", None)),
        # experts over `model`; tensor-parallel within an expert when the
        # experts do not divide it (Mixtral's 8 on 16)
        "wi": P((spec.num_experts, d, 2, spec.d_ff), fan_in=d,
                pspec=("model", "data", None, None),
                alt=(None, "data", None, "model")),
        "wo": P((spec.num_experts, spec.d_ff, d), fan_in=spec.d_ff,
                pspec=("model", None, "data"), alt=(None, "model", "data")),
    }
    if spec.num_shared_experts:
        sd = spec.d_ff * spec.num_shared_experts
        plan["shared_wi"] = P((d, 2, sd), pspec=("data", None, "model"))
        plan["shared_wo"] = P((sd, d), fan_in=sd, pspec=("model", "data"))
    return plan


def _capacity(num_tokens: int, spec: FFNSpec) -> int:
    c = int(num_tokens * spec.top_k * spec.capacity_factor / spec.num_experts)
    return max(8, min(c, num_tokens))


def route(params, tokens, spec: FFNSpec):
    """Router: f32 logits, softmax, top-k, renormalised gates.  tokens:
    [T, d].  Returns (probs [T,E], gates [T,k], expert ids [T,k])."""
    logits = einsum("td,de->te", tokens.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, spec.top_k, dim=-1)
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, gates, idx


def _experts(buf, wi, wo, activation: str, block):
    """The gated expert MLPs on buffer ``buf`` [E', C', d]: ``block``
    names the part of the ``[E, C, d]`` buffer (experts, slots) and of
    each expert's ``d_ff`` that ``buf``, ``wi`` and ``wo`` hold, as
    ``((e0, e1), (c0, c1), (f0, f1))``."""
    (e0, e1), (c0, c1), (f0, f1) = block
    if buf.shape[:2] != (e1 - e0, c1 - c0) or wi.shape[-1] != f1 - f0:
        raise ValueError(f"buffer {tuple(buf.shape)} is not block {block}")
    gu = einsum("ecd,edgf->ecgf", buf, wi)
    h = act_fn(activation)(gu[..., 0, :]) * gu[..., 1, :]
    return einsum("ecf,efd->ecd", h, wo)


def _dispatch(tokens, params, spec: FFNSpec):
    """Routing and the permutation dispatch over tokens [T, d]:
    (aux, gates [T,k], tok_for_slot [E, cap] (T = empty), the (token,
    choice) pairs' experts [T*k], slots [T*k] and kept flags [T*k],
    cap)."""
    t = tokens.shape[0]
    k = spec.top_k
    e = spec.num_experts
    dev = tokens.device
    probs, gates, idx = route(params, tokens, spec)
    me = probs.mean(dim=0)                                          # [E]
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = spec.router_aux_coef * e * torch.sum(me * ce)
    expert_ids = idx.reshape(-1)                     # [T*k]
    order = torch.argsort(expert_ids, stable=True)   # sorted (token, choice)
    sorted_eids = expert_ids[order]
    first = torch.searchsorted(sorted_eids, sorted_eids, side="left")
    slot = torch.arange(t * k, device=dev) - first
    cap = _capacity(t, spec)
    keep = slot < cap
    src_tok = order // k
    safe_slot = torch.where(keep, slot, torch.zeros_like(slot))
    drop_slot = torch.where(keep, slot, torch.full_like(slot, cap))
    tok_for_slot = torch.full((e, cap + 1), t, dtype=torch.long, device=dev)
    tok_for_slot[sorted_eids, drop_slot] = src_tok
    slot_unsorted = torch.zeros_like(slot)
    slot_unsorted[order] = safe_slot
    keep_unsorted = torch.zeros_like(keep)
    keep_unsorted[order] = keep
    return (aux, gates, tok_for_slot[:, :cap], expert_ids, slot_unsorted,
            keep_unsorted, cap)


def _moe_part(params, x, spec: FFNSpec, part):
    """``moe_ffn`` on a sharded step: global routing, this rank's block of
    the buffer, each token's share of it summed back to the token's
    rank."""
    b, s, d = x.shape
    own_tokens = x.reshape(-1, d)
    own = own_tokens.shape[0]
    tokens = part.gather_rows(own_tokens)            # [T, d], every rank's
    t, k, e = tokens.shape[0], spec.top_k, spec.num_experts
    aux, gates, tfs, eids, slot, keep, cap = _dispatch(tokens, params, spec)
    wi, wo = params["wi"], params["wo"]
    ep = wi.shape[0] != e                            # experts over `model`
    tp = not ep and wi.shape[3] != spec.d_ff         # d_ff over `model`
    slots = part.live(part.policy.moe_buf[1] if part.policy.moe_buf
                      else None)
    if slots != part.rows:
        raise ValueError(f"capacity slots over {slots}, rows over "
                         f"{part.rows}: the combine needs them alike")
    ci, nc = part.block(slots)
    cb = -(-cap // nc)
    if cb * nc > cap:                                # pad with the sentinel
        tfs = torch.cat([tfs, tfs.new_full((e, cb * nc - cap), t)], dim=1)
    el, fl = wi.shape[0], wi.shape[3]
    e0 = part.mi * el if ep else 0
    f0 = part.mi * fl if tp else 0
    c0 = ci * cb
    tfs = tfs[e0: e0 + el, c0: c0 + cb]
    src = part.f(tokens) if (ep or tp) else tokens
    tokens_pad = torch.cat([src, src.new_zeros((1, d))], dim=0)
    buf = tokens_pad[tfs].to(x.dtype)                         # [E', cb, d]
    out_blk = _experts(buf, wi, wo, spec.activation,
                       ((e0, e0 + el), (c0, c0 + cb), (f0, f0 + fl)))
    # every token's share of this block's outputs
    held = (keep & (eids >= e0) & (eids < e0 + el) & (slot >= c0)
            & (slot < c0 + cb))
    local = ((eids - e0).clamp(0, el - 1) * cb
             + (slot - c0).clamp(0, cb - 1))
    picked = out_blk.reshape(el * cb, d)[local]
    picked = picked * held[:, None].to(picked.dtype)
    g = gates.to(x.dtype)
    if ep or tp:
        g = part.f(g)
    out = einsum("tkd,tk->td", picked.reshape(t, k, d), g)
    out = coll.scatter_sum(out, part.row_groups, 0)   # this rank's rows
    if ep or tp:
        out = part.g(out)
    if spec.num_shared_experts:
        split = params["shared_wi"].shape[2] != (
            spec.d_ff * spec.num_shared_experts)
        xs = part.f(own_tokens) if split else own_tokens
        gu_s = einsum("td,dgf->tgf", xs, params["shared_wi"])
        hs = act_fn(spec.activation)(gu_s[:, 0]) * gu_s[:, 1]
        shared = einsum("tf,fd->td", hs, params["shared_wo"])
        out = out + (part.g(shared) if split else shared)
    return out.reshape(b, s, d), aux


def moe_ffn(params, x, spec: FFNSpec, cfg: ModelConfig, *, part=None):
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar); with ``part``
    routed over the rows of every row rank (``_moe_part``)."""
    if part is not None:
        return _moe_part(params, x, spec, part)
    b, s, d = x.shape
    tokens = x.reshape(-1, d)                        # [T, d]
    t = tokens.shape[0]
    k = spec.top_k
    e = spec.num_experts
    dev = x.device

    probs, gates, idx = route(params, tokens, spec)

    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)                                          # [E]
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = spec.router_aux_coef * e * torch.sum(me * ce)

    # ---- permutation dispatch ----
    expert_ids = idx.reshape(-1)                     # [T*k]
    order = torch.argsort(expert_ids, stable=True)   # sorted (token, choice)
    sorted_eids = expert_ids[order]
    # slot within expert segment = rank - first occurrence of that expert
    first = torch.searchsorted(sorted_eids, sorted_eids, side="left")
    slot = torch.arange(t * k, device=dev) - first
    cap = _capacity(t, spec)
    keep = slot < cap
    src_tok = order // k                             # originating token
    safe_slot = torch.where(keep, slot, torch.zeros_like(slot))
    # dropped pairs land in a sacrificial extra slot, cut off below
    drop_slot = torch.where(keep, slot, torch.full_like(slot, cap))
    tok_for_slot = torch.full((e, cap + 1), t, dtype=torch.long, device=dev)
    tok_for_slot[sorted_eids, drop_slot] = src_tok
    tokens_pad = torch.cat([tokens, tokens.new_zeros((1, d))], dim=0)
    buf = tokens_pad[tok_for_slot[:, :cap]].to(x.dtype)       # [E, C, d]

    # ---- expert FFN: gated MLP as batched products over experts ----
    gu = einsum("ecd,edgf->ecgf", buf, params["wi"])
    h = act_fn(spec.activation)(gu[..., 0, :]) * gu[..., 1, :]
    out_buf = einsum("ecf,efd->ecd", h, params["wo"])

    # ---- combine: gather back to (token, choice) pairs, weight, sum ----
    slot_unsorted = torch.zeros_like(slot)
    slot_unsorted[order] = safe_slot
    keep_unsorted = torch.zeros_like(keep)
    keep_unsorted[order] = keep
    flat_idx = expert_ids * cap + slot_unsorted                     # [T*k]
    picked = out_buf.reshape(e * cap, d)[flat_idx]
    picked = picked * keep_unsorted[:, None].to(picked.dtype)
    out = einsum("tkd,tk->td", picked.reshape(t, k, d),
                 gates.to(x.dtype))

    if spec.num_shared_experts:
        gu_s = einsum("td,dgf->tgf", tokens, params["shared_wi"])
        hs = act_fn(spec.activation)(gu_s[:, 0]) * gu_s[:, 1]
        out = out + einsum("tf,fd->td", hs, params["shared_wo"])
    return out.reshape(b, s, d), aux
