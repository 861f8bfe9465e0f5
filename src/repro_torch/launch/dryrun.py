"""Multi-pod dry run at plan level: build every (architecture x input
shape) step against the production mesh on ``device="meta"`` tensors,
check that every argument's shard is whole, and give the analytic memory
and roofline terms (the PyTorch twin of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm_3b \
        --shape train_4k [--multi-pod | --both-meshes]

The reference lowers and compiles each step with XLA on 512 placeholder
devices and reads the compiled program's ``memory_analysis``
(``bytes_per_device``), ``cost_analysis`` (the ``hlo_*`` terms) and its
collectives (``collective_bytes_from_hlo``).  An eager PyTorch step has no
compiled SPMD program whose HLO could be read, so the per-device figures
here are analytic: estimates from the plans, not measurements of any
device.  The collective term is the port's counterpart of
``collective_bytes_from_hlo``: ``collective_bytes`` counts, from the same
plans, resolved specs and policy the sharded steps follow
(``launch/steps.py``, ``models/partition.py``), the bytes each rank passes
to each collective kind in one step, by ``launch/collectives.py``'s ring
rules; a live step's tally equals it byte for byte
(``tests/test_torch_tensor_parallel.py``).  It feeds ``roofline_terms``'s
``coll_bytes``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      ModelConfig, get_config)
from repro_torch.launch import collectives as coll
from repro_torch.launch.mesh import batch_axes, make_production_mesh, mesh_view
from repro_torch.launch.shardings import axes_of, make_policy
from repro_torch.launch.specs import batch_plan, decode_arg_plans
from repro_torch.launch.steps import build_step, followed_policy
from repro_torch.models.model import ENCODER_LAYER, model_plan
from repro_torch.models.params import (_axis_size, count_params, param_bytes,
                                       plan_leaves, pspecs_from_plan,
                                       resolve_pspec, torch_dtype)

# NVIDIA H100 SXM, per card (NVIDIA's H100 data sheet, dense rates): bf16
# tensor-core peak, HBM3 bandwidth, and NVLink 4's 900 GB/s a card (both
# directions), 450e9 bytes/s each way
PEAK_FLOPS = 989e12          # bf16
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # bytes/s, NVLink 4, one direction


def roofline_terms(cost: dict, coll_bytes: float, num_chips: int,
                   scan_mult: int = 1) -> Dict[str, float]:
    """The reference's terms from a compiled program's cost analysis, on
    the H100's rates (the port has no compiled program to feed it)."""
    flops = float(cost.get("flops", 0.0)) * scan_mult
    hbm = float(cost.get("bytes accessed", 0.0)) * scan_mult
    return {
        "hlo_flops": flops,
        "hlo_bytes": hbm,
        "collective_bytes": coll_bytes,
        "t_compute": flops / (num_chips * PEAK_FLOPS),
        "t_memory": hbm / (num_chips * HBM_BW),
        "t_collective": coll_bytes / (num_chips * LINK_BW),
    }


def _leaf_bytes_per_device(plan, mesh) -> int:
    """Analytic per-device bytes for a plan tree under its resolved specs."""
    def leaf(p) -> int:
        spec = resolve_pspec(mesh, p)
        n = 1
        for dim, entry in zip(p.shape, tuple(spec) + (None,) * len(p.shape)):
            ext = _axis_size(mesh, entry) if entry is not None else 1
            n *= -(-dim // max(ext, 1))
        return n * torch_dtype(p.dtype).itemsize

    return int(sum(leaf(p) for p in plan_leaves(plan)))


def analytic_memory(cfg: ModelConfig, shape: InputShape, mesh,
                    policy=None) -> Dict[str, float]:
    """Per-device memory estimate from the plans (bf16 params and
    activations): params (+ grads + Adam moments for train), the remat
    residual stack, decode caches, and a working-set allowance.  The
    reference's arithmetic, term for term."""
    mesh = mesh_view(mesh)
    policy = policy or make_policy(cfg, shape, mesh)
    pplan = model_plan(cfg)
    params_b = _leaf_bytes_per_device(pplan, mesh)
    out: Dict[str, float] = {"params": params_b}
    data_shards = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            data_shards *= mesh.shape[a]
    if shape.mode == "train":
        out["grads"] = params_b
        out["adam_moments"] = 4 * count_params(pplan) // max(
            np.prod([mesh.shape[a] for a in mesh.axis_names]), 1) * 2
        b_local = max(1, shape.global_batch // data_shards)
        # one bf16 residual per layer (remat saves each repeat's input);
        # sequence parallelism shards the saved stack over `model`
        seq_shards = 1
        if policy.act and len(policy.act) > 1 and policy.act[1] == "model":
            seq_shards = mesh.shape.get("model", 1)
        out["residual_stack"] = (cfg.num_layers * b_local * shape.seq_len
                                 * cfg.d_model * 2 // seq_shards)
        out["working_set"] = 2 << 30
    else:
        cplan, _, _ = decode_arg_plans(cfg, shape, mesh)
        out["kv_cache"] = _leaf_bytes_per_device(cplan, mesh)
        out["working_set"] = 1 << 30
    out = {k: float(v) for k, v in out.items()}
    out["total"] = float(sum(out.values()))
    return out


def analytic_terms(cfg: ModelConfig, shape: InputShape, num_chips: int,
                   q_chunk: int = 512) -> Dict[str, float]:
    """Per-step FLOPs and bytes from the architecture math (bf16), and
    their times on ``num_chips`` H100s at the peak rates above."""
    mode = shape.mode
    tokens = shape.global_batch * (shape.seq_len if mode != "decode" else 1)
    d = cfg.d_model
    flops = 0.0
    hbm = 0.0

    def cap_of(w):
        return min(shape.seq_len, w) if w else shape.seq_len

    for layer in cfg.layer_specs():
        # ---- mixer ----
        if layer.mixer == "attn":
            a = cfg.attn
            if a.kind == "mla":
                qk = a.nope_head_dim + a.rope_head_dim
                proj = (d * a.q_lora_rank + a.q_lora_rank * a.num_heads * qk
                        + d * (a.kv_lora_rank + a.rope_head_dim)
                        + a.kv_lora_rank * a.num_heads
                        * (a.nope_head_dim + a.v_head_dim)
                        + a.num_heads * a.v_head_dim * d)
                hd_eff = qk
                kv_bytes_tok = (a.kv_lora_rank + a.rope_head_dim) * 2
                heads = a.num_heads
            else:
                proj = d * (a.num_heads + 2 * a.num_kv_heads) * a.head_dim \
                    + a.num_heads * a.head_dim * d
                hd_eff = a.head_dim
                kv_bytes_tok = 2 * a.num_kv_heads * a.head_dim * 2
                heads = a.num_heads
            flops += 2 * tokens * proj
            if mode == "decode":
                span = cap_of(layer.window)
                flops += 4 * shape.global_batch * heads * hd_eff * span
                hbm += shape.global_batch * span * kv_bytes_tok  # cache read
            else:
                # chunked causal attention; windowed layers clip to the span
                if layer.window and layer.window + q_chunk < shape.seq_len:
                    span = layer.window + q_chunk
                    flops += 4 * shape.global_batch * heads * hd_eff \
                        * shape.seq_len * span
                else:
                    flops += 4 * shape.global_batch * heads * hd_eff \
                        * shape.seq_len * (shape.seq_len + 1) / 2
        elif layer.mixer == "mamba":
            m = cfg.mamba
            d_in = m.expand * d
            dt_rank = m.dt_rank or -(-d // 16)
            proj = d * 2 * d_in + d_in * (dt_rank + 2 * m.d_state) \
                + dt_rank * d_in + d_in * d
            flops += 2 * tokens * proj + 6 * tokens * d_in * m.d_state
        elif layer.mixer == "rwkv6":
            r = cfg.rwkv
            flops += 2 * tokens * (5 * d * d + d * r.decay_lora * 2) \
                + 4 * tokens * d * r.head_dim
        # ---- ffn ----
        f = cfg.ffn_spec_for(layer)
        if layer.ffn == "dense":
            flops += 2 * tokens * 3 * d * f.d_ff
        elif layer.ffn == "moe":
            active = f.top_k + f.num_shared_experts
            flops += 2 * tokens * (d * f.num_experts
                                   + active * 3 * d * f.d_ff)
        elif layer.ffn == "rwkv_cm":
            flops += 2 * tokens * (2 * d * d + 2 * d * cfg.rwkv.d_ffn)
    # embeddings / logits
    flops += 2 * tokens * d * cfg.vocab_size if mode != "decode" else \
        2 * shape.global_batch * d * cfg.vocab_size
    if cfg.encoder is not None and mode != "decode":
        enc_tok = shape.global_batch * shape.seq_len
        enc = cfg.encoder
        per = 2 * (4 * d * d + 3 * d * enc.d_ff)
        flops += enc.num_layers * (enc_tok * per
                                   + 4 * enc_tok * shape.seq_len * d)
    if mode == "train":
        flops *= 3.0      # fwd + bwd (2x); remat recompute folded into hbm
    # memory: weights read once per step + activation IO (2 passes bf16)
    params_bytes = param_bytes(model_plan(cfg))
    hbm += params_bytes * (3.0 if mode == "train" else 1.0)
    hbm += tokens * d * 2 * cfg.num_layers * (4.0 if mode == "train" else 2.0)
    return {
        "flops_analytic": flops,
        "hbm_bytes_analytic": hbm,
        "t_compute_analytic": flops / (num_chips * PEAK_FLOPS),
        "t_memory_analytic": hbm / (num_chips * HBM_BW),
    }


# ---------------------------------------------------------------------------
# Collective bytes: the sharded steps' collectives, counted from the plans
# ---------------------------------------------------------------------------

class _Count:
    """Bytes a rank passes by kind (``collectives``'s ring rules), each
    event added ``times`` times."""

    def __init__(self, sizes: Dict[str, int]):
        self.sizes = sizes
        self.bytes = {k: 0 for k in coll.KINDS}

    def live(self, axes) -> tuple:
        return tuple(a for a in axes if self.sizes.get(a, 1) > 1)

    def ag(self, nbytes: int, axes, times: int = 1) -> None:
        for a in reversed(self.live(axes)):
            n = self.sizes[a]
            self.bytes["all_gather"] += times * (n - 1) * nbytes
            nbytes *= n

    def rs(self, nbytes: int, axes, times: int = 1) -> None:
        """``nbytes``: the whole input."""
        for a in self.live(axes):
            n = self.sizes[a]
            nbytes //= n
            self.bytes["reduce_scatter"] += times * (n - 1) * nbytes

    def ar(self, numel: int, itemsize: int, axes, times: int = 1) -> None:
        for a in self.live(axes):
            self.bytes["all_reduce"] += times * coll.ring_all_reduce_bytes(
                numel, itemsize, self.sizes[a])


def _split(spec, dim: int, sizes) -> bool:
    """Whether dim ``dim`` of a resolved spec is split over ``model``."""
    return (dim < len(spec) and "model" in axes_of(spec[dim])
            and sizes.get("model", 1) > 1)


def _live_axes(entry, sizes) -> tuple:
    return tuple(a for a in axes_of(entry) if sizes.get(a, 1) > 1)


class _StepCount:
    """One step's collectives, walked as the model functions make them:
    ``fwd`` times in the forward (2 for a remat-checkpointed layer, whose
    recompute makes them again) and ``bwd`` times in the backward."""

    def __init__(self, cfg: ModelConfig, shape: InputShape, mesh, remat,
                 plan=None, policy=None):
        view = mesh_view(mesh)
        self.cfg, self.shape = cfg, shape
        self.sizes = dict(view.shape)
        self.c = _Count(self.sizes)
        self.m = self.sizes.get("model", 1)
        self.batch = batch_axes(view)
        self.isz = torch_dtype(cfg.dtype).itemsize
        self.train = shape.mode == "train"
        self.remat = remat
        self.plan = plan if plan is not None else model_plan(cfg)
        self.specs = pspecs_from_plan(self.plan, view)
        bspec = pspecs_from_plan(batch_plan(cfg, shape, view), view)
        if shape.mode == "decode":
            cplan, tplan, _ = decode_arg_plans(cfg, shape, view)
            self.cspecs = pspecs_from_plan(cplan, view)
            bspec = {"tokens": pspecs_from_plan(tplan, view)}
        tok = bspec["tokens"]
        self.rows = _live_axes(tok[0] if tok else None, self.sizes)
        self.nr = int(np.prod([self.sizes[a] for a in self.rows]))
        self.b = shape.global_batch // self.nr
        self.policy = followed_policy(cfg, shape, view, policy)
        act = self.policy.act or ()
        # sequence parallelism: the residual stream split along S
        self.seq = (shape.mode != "decode" and len(act) > 1
                    and "model" in axes_of(act[1]) and self.m > 1)

    # ---- pieces
    def f(self, numel, bwd):
        """Megatron's f: an all-reduce over ``model`` in the backward."""
        if self.train:
            self.c.ar(numel, self.isz, ("model",), bwd)

    def g(self, numel, fwd):
        """Megatron's g: an all-reduce over ``model`` in the forward."""
        self.c.ar(numel, self.isz, ("model",), fwd)

    def enter(self, numel, split, fwd, bwd, isz=None):
        """``Part.enter`` of a stream of ``numel`` elements (the whole
        sequence's)."""
        isz = isz or self.isz
        if not self.seq:
            if split:
                self.f(numel, bwd)
            return
        self.c.ag(numel // self.m * isz, ("model",), fwd)
        if self.train and split:
            self.c.rs(numel * isz, ("model",), bwd)

    def leave(self, numel, split, fwd, bwd, isz=None):
        """``Part.leave`` of a block's output of ``numel`` elements."""
        isz = isz or self.isz
        if not self.seq:
            if split:
                self.c.ar(numel, isz, ("model",), fwd)
            return
        if split:
            self.c.rs(numel * isz, ("model",), fwd)
        if self.train:
            self.c.ag(numel // self.m * isz, ("model",), bwd)

    def shared(self, plan, specs, names, bwd, stacked=False):
        """``Part.shared`` on the named leaves (a weight applied to the
        rank's rows): an all-reduce of its gathered gradient over
        ``model`` in the backward."""
        if not (self.seq and self.train):
            return
        for name in names:
            p, spec = plan[name], specs[name]
            shape, spec = ((p.shape[1:], spec[1:]) if stacked
                           else (p.shape, spec))
            n = int(np.prod([dd // (self.m if _split(spec, i, self.sizes)
                                    else 1) for i, dd in enumerate(shape)]))
            self.c.ar(n, torch_dtype(p.dtype).itemsize, ("model",), bwd)

    def gather(self, tree, specs, fwd, bwd, stacked=False):
        """Parameters gathered at use over their batch-axis dims."""
        if isinstance(tree, dict):
            for k in tree:
                self.gather(tree[k], specs[k], fwd, bwd, stacked)
            return
        p, spec = tree, specs
        shape, spec = ((p.shape[1:], spec[1:]) if stacked
                       else (p.shape, spec))
        ext = [int(np.prod([self.sizes[a] for a in _live_axes(e, self.sizes)]
                           or [1])) for e in spec]
        ext += [1] * (len(shape) - len(ext))
        nbytes = int(np.prod([d // x for d, x in zip(shape, ext)])) \
            * torch_dtype(p.dtype).itemsize
        done = []
        for e in spec:
            axes = _live_axes(e, self.sizes)
            if not axes or any(a not in self.batch for a in axes):
                continue
            self.c.ag(nbytes, axes, fwd)
            nbytes *= int(np.prod([self.sizes[a] for a in axes]))
            done.append(axes)
        if self.train:
            for axes in reversed(done):
                self.c.rs(nbytes, axes, bwd)
                nbytes //= int(np.prod([self.sizes[a] for a in axes]))

    def attention(self, specs, cspec, s, fwd, bwd, *, memory_len=0,
                  decode=False, cross=False, plan=None, pspecs=None,
                  stacked=False):
        """``plan`` and ``pspecs``: the layer's attention leaves and their
        specs as stored (stacked when ``stacked``)."""
        a, cfg = self.cfg.attn, self.cfg
        b, d = self.b, cfg.d_model
        if a.kind == "mla" and not cross:
            split = _split(specs["wq_b"], 1, self.sizes)
        else:
            split = _split(specs["wq"], 1, self.sizes)
        hl = a.num_heads // self.m if split else a.num_heads
        if not decode:
            if a.kind == "mla" and not cross:
                self.shared(plan, pspecs, ("wq_a", "q_norm", "wkv_a",
                                           "kv_norm"), bwd, stacked)
                for width in (a.q_lora_rank, a.kv_lora_rank,
                              a.rope_head_dim):
                    self.enter(b * s * width, split, fwd, bwd)
            else:
                kv_whole = split and not _split(specs["wk"], 1, self.sizes)
                kv = a.num_kv_heads * a.head_dim
                if cross:
                    if self.seq or not kv_whole:
                        self.enter(b * memory_len * d, split, fwd, bwd)
                    if kv_whole:
                        self.f(b * memory_len * kv, 2 * bwd)
                self.enter(b * s * d, split, fwd, bwd)
                if kv_whole and not cross:
                    self.f(b * s * kv, 2 * bwd)
            self.leave(b * s * d, split, fwd, bwd)
            return
        # decode against the stored cache
        key = "ck" if cross else ("ckv" if a.kind == "mla" else "k")
        seq = _live_axes(cspec[key][1], self.sizes)
        every = split and "model" in seq
        hq = a.num_heads if (every or not split) else hl
        if every:
            if a.kind == "mla" and not cross:
                self.c.ag(b * hl * a.kv_lora_rank * self.isz, ("model",))
                self.c.ag(b * hl * a.rope_head_dim * self.isz, ("model",))
            else:
                self.c.ag(b * hl * a.head_dim * self.isz, ("model",))
        if seq:
            width = (a.kv_lora_rank if a.kind == "mla" and not cross
                     else a.head_dim)
            self.c.ar(b * hq, 4, seq)
            self.c.ar(b * hq * (width + 1), 4, seq)
        if split:
            self.g(b * d, 1)

    def ffn(self, layer, specs, s, fwd, bwd):
        cfg = self.cfg
        b, d = self.b, cfg.d_model
        if layer.ffn == "dense":
            split = _split(specs["ffn"]["w_in"], 2, self.sizes)
            self.enter(b * s * d, split, fwd, bwd)
            self.leave(b * s * d, split, fwd, bwd)
        elif layer.ffn == "moe":
            self.moe(cfg.ffn_spec_for(layer), specs["moe"], s, fwd, bwd)

    def moe(self, spec, specs, s, fwd, bwd):
        b, d, isz = self.b, self.cfg.d_model, self.isz
        own = b * s
        t = own * self.nr
        if self.seq:                                 # along S, to route
            self.enter(own * d, True, fwd, bwd)
        self.c.ag(own * d * isz, self.rows, fwd)     # the rows, for routing
        if self.train:
            self.c.rs(t * d * isz, self.rows, bwd)
        ep = _split(specs["wi"], 0, self.sizes)
        tp = not ep and _split(specs["wi"], 3, self.sizes)
        if ep or tp:
            self.f(t * d, bwd)                  # the tokens of the block
            self.f(t * spec.top_k, bwd)         # the gates
        self.c.rs(t * d * isz, self.rows, fwd)       # the shares, summed
        if self.train:
            self.c.ag(own * d * isz, self.rows, bwd)
        self.leave(own * d, ep or tp, fwd, bwd)
        if spec.num_shared_experts:
            split = _split(specs["shared_wi"], 2, self.sizes)
            if split and not self.seq:
                self.f(own * d, bwd)
            self.leave(own * d, split, fwd, bwd)

    def mamba(self, specs, s, fwd, bwd):
        cfg = self.cfg
        b, d = self.b, cfg.d_model
        split = _split(specs["in_proj"], 2, self.sizes)
        self.enter(b * s * d, split, fwd, bwd)
        if split:
            dt_rank = cfg.mamba.dt_rank or -(-d // 16)
            width = dt_rank + 2 * cfg.mamba.d_state
            self.g(b * s * width, fwd)
            self.f(b * s * width, bwd)
        self.leave(b * s * d, split, fwd, bwd)

    def rwkv(self, specs, s, fwd, bwd):
        cfg = self.cfg
        b, d = self.b, cfg.d_model
        split = _split(specs["wr"], 1, self.sizes)
        self.enter(b * s * d, False, fwd, bwd)       # before the shift
        if split:
            for _ in range(4):                       # xr, xk, xv, xg
                self.f(b * s * d, bwd)
            self.f(b * s * cfg.rwkv.decay_lora, bwd)
            if self.train:                           # ln_x's slice
                self.c.ag(d // self.m * 4, ("model",), bwd)
        self.leave(b * s * d, split, fwd, bwd)
        # the channel-mix
        self.enter(b * s * d, False, fwd, bwd)
        if _split(specs["cm_wr"], 1, self.sizes):
            self.f(b * s * d, bwd)
            self.c.ag(b * s * (d // self.m) * self.isz, ("model",), fwd)
        pk = _split(specs["cm_wk"], 1, self.sizes)
        if pk:
            self.f(b * s * d, bwd)
        self.leave(b * s * d, pk, fwd, bwd)          # o
        self.leave(b * s * d, False, fwd, bwd)       # r

    def layer(self, layer, specs, cspec, s, fwd, bwd, *, memory_len=0,
              stacked=False, plan=None):
        self.gather(plan, specs, fwd, bwd, stacked)
        norms = ["norm1"]
        if layer.cross_attn and memory_len:
            norms.append("norm_x")
        if layer.ffn in ("dense", "moe"):
            norms.append("norm2")
        self.shared(plan, specs, norms, bwd, stacked)
        pspecs = specs
        if stacked:
            specs = _strip(specs)
            cspec = _strip(cspec) if cspec is not None else None
        decode = self.shape.mode == "decode"
        if layer.mixer == "attn":
            self.attention(specs["attn"], cspec and cspec.get("self"), s,
                           fwd, bwd, decode=decode, plan=plan["attn"],
                           pspecs=pspecs["attn"], stacked=stacked)
            if layer.cross_attn and (memory_len or decode):
                self.attention(specs["cross"], cspec and cspec.get("cross"),
                               s, fwd, bwd, memory_len=memory_len,
                               decode=decode, cross=True)
        elif layer.mixer == "mamba":
            self.mamba(specs["mamba"], s, fwd, bwd)
        else:
            self.rwkv(specs["rwkv"], s, fwd, bwd)
        self.ffn(layer, specs, s, fwd, bwd)

    # ---- the step
    def count(self) -> Dict[str, int]:
        cfg, shape, plan, specs = self.cfg, self.shape, self.plan, self.specs
        b, d, v = self.b, cfg.d_model, cfg.vocab_size
        decode = shape.mode == "decode"
        bwd = 1 if self.train else 0
        nf = 2 if (self.train and self.remat) else 1
        s_text, memory_len = shape.seq_len, 0
        if decode:
            s_text = 1
        elif cfg.encoder is not None:
            s_text = min(128, shape.seq_len) if shape.mode == "prefill" \
                else shape.seq_len
            memory_len = shape.seq_len
        elif cfg.frontend.kind == "vision":
            s_text = shape.seq_len - cfg.frontend.num_prefix
        s = s_text + (cfg.frontend.num_prefix if cfg.frontend.kind == "vision"
                      and not decode else 0)
        if not decode and cfg.frontend.kind != "none":
            self.gather(plan["frontend_proj"], specs["frontend_proj"], 1, bwd)
        if not decode and cfg.encoder is not None:
            self.leave(b * memory_len * d, False, 1, bwd)   # the frames
            for _ in range(cfg.encoder.num_layers):
                self.layer(ENCODER_LAYER, specs["encoder"]["period"]["sub0"],
                           None, memory_len, nf, bwd, stacked=True,
                           plan=plan["encoder"]["period"]["sub0"])
            self.gather(plan["encoder"]["final_norm"],
                        specs["encoder"]["final_norm"], 1, bwd)
            self.shared(plan["encoder"], specs["encoder"], ("final_norm",),
                        bwd)
        # the embedding, masked to this rank's vocabulary rows and summed
        # (under sequence parallelism a reduce-scatter along S, or this
        # rank's rows of a whole vocabulary; a VLM's rows made whole, then
        # cut)
        self.gather(plan["embed"], specs["embed"], 1, bwd)
        esz = torch_dtype(plan["embed"].dtype).itemsize
        vision = cfg.frontend.kind == "vision" and not decode
        if _split(specs["embed"], 0, self.sizes):
            if self.seq and not vision:
                self.leave(b * s_text * d, True, 1, bwd, isz=esz)
            else:
                self.c.ar(b * s_text * d, esz, ("model",))
        elif not vision:
            self.shared(plan, specs, ("embed",), bwd)
        if vision:
            self.leave(b * s * d, False, 1, bwd)
        cs = self.cspecs if decode else {}
        for i, layer in enumerate(cfg.prefix):
            key = f"layer{i}"
            self.layer(layer, specs["prefix"][key],
                       cs.get("prefix", {}).get(key), s, nf, bwd,
                       memory_len=memory_len, plan=plan["prefix"][key])
        for _ in range(cfg.repeats if cfg.period else 0):
            for i, layer in enumerate(cfg.period):
                sub = f"sub{i}"
                self.layer(layer, specs["period"][sub],
                           cs.get("period", {}).get(sub), s, nf, bwd,
                           memory_len=memory_len, stacked=True,
                           plan=plan["period"][sub])
        self.gather(plan["final_norm"], specs["final_norm"], 1, bwd)
        head = "embed" if cfg.tie_embeddings else "lm_head"
        self.gather(plan[head], specs[head], 1, bwd)
        vsplit = _split(specs[head], 0 if cfg.tie_embeddings else 1,
                        self.sizes)
        rows = b * s_text
        if self.seq:
            self.shared(plan, specs, ("final_norm",), bwd)
            if self.train:                           # gathered for the head
                self.enter(b * s * d, vsplit, 1, bwd)
            else:                                    # the last position's
                self.c.ag(b * d * self.isz, ("model",))
        if vsplit and self.train:
            if not self.seq:
                self.f(rows * d, bwd)
            self.c.ar(rows, 4, ("model",))           # the row max
            self.c.ar(rows, 4, ("model",))           # the exponential sum
            self.c.ar(rows, 4, ("model",))           # the target's logit
        elif vsplit:
            self.c.ag(b * (v // self.m) * 4, ("model",))
        if self.train:
            view_axes = tuple(self.sizes)
            for p, spec in zip(plan_leaves(plan), plan_leaves(specs)):
                named = {a for e in spec for a in axes_of(e)}
                missing = tuple(a for a in self.batch if a not in named)
                n = int(np.prod([dd // int(np.prod(
                    [self.sizes[a] for a in _live_axes(e, self.sizes)]
                    or [1])) for dd, e in zip(
                        p.shape, tuple(spec) + (None,) * len(p.shape))]))
                self.c.ar(n, torch_dtype(p.dtype).itemsize, missing)
            self.c.ar(1, 4, self.rows)               # the loss
            self.c.ar(1, 4, view_axes)               # the clip's norm
        return dict(self.c.bytes)


def _strip(specs):
    """Per-repeat specs of stacked leaves (the stack's axis dropped)."""
    if isinstance(specs, dict):
        return {k: _strip(v) for k, v in specs.items()}
    return specs[1:]


def collective_bytes(cfg: ModelConfig, shape: InputShape, mesh, *,
                     remat: bool = True, plan=None,
                     policy=None) -> Dict[str, int]:
    """Bytes each rank passes to each collective kind in one step of
    ``launch/steps.py::build_step(cfg, shape, mesh, remat=remat,
    policy_override=policy)``, by ``launch/collectives.py``'s ring rules
    (every rank passes as many).  ``plan``: the parameters' plan, if they
    are stored in other dtypes than ``model_plan(cfg)``'s."""
    return _StepCount(cfg, shape, mesh, remat, plan, policy).count()


def _arg_leaves(tree):
    """Leaves of ``build_step``'s args or placements (a placements leaf is
    a list, one entry a mesh dim)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _arg_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _arg_leaves(t)]
    return [tree]


def _check_whole_shards(args, in_placements, mesh) -> int:
    """Every argument leaf's shard is whole: each dim divides by the ranks
    its placements shard it over.  Returns the leaves checked."""
    mesh = mesh_view(mesh)
    sizes = [mesh.shape[a] for a in mesh.axis_names]
    tensors, layouts = _arg_leaves(args), _arg_leaves(in_placements)
    if len(tensors) != len(layouts):
        raise AssertionError(f"{len(tensors)} args, {len(layouts)} layouts")
    for t, layout in zip(tensors, layouts):
        ext = [1] * t.dim()
        for size, pl in zip(sizes, layout):
            if pl.is_shard():
                ext[pl.dim] *= size
        for dim, e in zip(t.shape, ext):
            if dim % e:
                raise AssertionError(f"shape {tuple(t.shape)} does not "
                                     f"divide over {layout}")
    return len(tensors)


def dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
           verbose: bool = True, policy_override=None) -> Optional[dict]:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.supports_long_context:
        if verbose:
            print(f"SKIP {arch} x {shape_name}: full-attention arch "
                  f"(sub-quadratic rule, see DESIGN.md)")
        return None
    mesh = make_production_mesh(multi_pod=multi_pod)
    num_chips = int(np.prod(list(mesh.shape.values())))
    _, args, placements, _, _ = build_step(cfg, shape, mesh,
                                           policy_override=policy_override)
    leaves = _check_whole_shards(args, placements, mesh)
    comm = collective_bytes(cfg, shape, mesh, policy=policy_override)
    terms = analytic_terms(cfg, shape, num_chips,
                           q_chunk=int(os.environ.get("REPRO_Q_CHUNK", "512")))
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "num_chips": num_chips, "mode": shape.mode,
        "params": count_params(model_plan(cfg)),
        "arg_leaves": leaves,
        "analytic_memory": analytic_memory(cfg, shape, mesh,
                                           policy=policy_override),
        **terms,
        # per rank, by kind; the roofline's term takes every rank's bytes
        "collective_bytes_per_device": comm,
        **{k + "_analytic": v for k, v in roofline_terms(
            {"flops": terms["flops_analytic"],
             "bytes accessed": terms["hbm_bytes_analytic"]},
            float(sum(comm.values())) * num_chips, num_chips).items()
           if k in ("collective_bytes", "t_collective")},
    }
    if verbose:
        agb = result["analytic_memory"]["total"] / 2**30
        dom = max(("t_compute_analytic", "t_memory_analytic",
                   "t_collective_analytic"), key=lambda k: result[k])
        gib = {k: v / 2**30 for k, v in comm.items()}
        print(f"{arch:24s} {shape_name:12s} chips={num_chips:3d} "
              f"(H100 analytic est {agb:6.2f}GiB/dev) "
              f"Tc={result['t_compute_analytic']*1e3:8.3f}ms "
              f"Tm={result['t_memory_analytic']*1e3:8.3f}ms "
              f"Tcoll={result['t_collective_analytic']*1e3:8.3f}ms "
              f"dom={dom} coll GiB/dev ag={gib['all_gather']:.3f} "
              f"rs={gib['reduce_scatter']:.3f} ar={gib['all_reduce']:.3f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="input shape (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="run single-pod and multi-pod")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                try:
                    res = dryrun(arch, shape, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 — report, keep going
                    failures.append((tag, repr(e)[:200]))
                    print(f"FAIL {tag}: {repr(e)[:200]}")
                    continue
                if res is not None:
                    with open(os.path.join(args.out, tag + ".json"), "w") as f:
                        json.dump(res, f, indent=2)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(" ", tag, err)
        raise SystemExit(1)
    print("\nAll dry-runs passed.")


if __name__ == "__main__":
    main()
