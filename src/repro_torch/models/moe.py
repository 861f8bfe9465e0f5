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
tokens.  A step whose batch rows lie on several ranks passes the process
groups of its batch axes (``batch_groups``, major first): the rows are
gathered from every rank before routing, in the order of the global
batch, and each rank keeps its own rows of the output; the gather's
backward sums the cotangent over the ranks, so each rank's rows get
every rank's share of the gradient.  Without groups nothing is gathered.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import FFNSpec, ModelConfig
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


def _rank_index(groups) -> int:
    """This rank's place among the ranks of ``groups`` (major first)."""
    import torch.distributed as dist
    index = 0
    for g in groups:
        index = index * dist.get_world_size(g) + dist.get_rank(g)
    return index


class _GatherRows(torch.autograd.Function):
    """Rows [T, d] of every rank of ``groups`` (major first), in the
    mixed-radix order of the ranks' group ranks; backward: the cotangent
    summed over the ranks, this rank's rows."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist
        ctx.groups, ctx.rows = groups, x.shape[0]
        ctx.index = _rank_index(groups)
        out = x.contiguous()
        for g in reversed(groups):       # minor first: blocks nest in order
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, out, group=g)
            out = torch.cat(parts)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        grad = grad.contiguous().clone()
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        lo = ctx.index * ctx.rows
        return grad[lo: lo + ctx.rows], None


def moe_ffn(params, x, spec: FFNSpec, cfg: ModelConfig, *,
            batch_groups=()):
    """x: [B, S, d] -> (out [B, S, d], aux_loss scalar), routed over the
    rows of every rank of ``batch_groups`` (this rank's alone when
    empty)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)                        # [T, d]
    own = tokens.shape[0]
    if batch_groups:
        tokens = _GatherRows.apply(tokens, tuple(batch_groups))
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

    if batch_groups:
        lo = _rank_index(batch_groups) * own
        out = out[lo: lo + own]
    return out.reshape(b, s, d), aux
