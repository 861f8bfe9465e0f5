"""Multi-pod dry run at plan level: build every (architecture x input
shape) step against the production mesh on ``device="meta"`` tensors,
check that every argument's shard is whole, and give the analytic memory
and roofline terms (the PyTorch twin of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm_3b \
        --shape train_4k [--multi-pod | --both-meshes]

Not ported: the reference lowers and compiles each step with XLA on 512
placeholder devices and reads the compiled program's ``memory_analysis``
(``bytes_per_device``), ``cost_analysis`` (the ``hlo_*`` terms) and its
collectives (``collective_bytes_from_hlo``).  An eager PyTorch step has no
compiled SPMD program whose HLO could be read, so the per-device figures
here are the analytic ones only: estimates from the plans, not
measurements of any device.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      ModelConfig, get_config)
from repro_torch.launch.mesh import make_production_mesh, mesh_view
from repro_torch.launch.shardings import make_policy
from repro_torch.launch.specs import decode_arg_plans
from repro_torch.launch.steps import build_step
from repro_torch.models.model import model_plan
from repro_torch.models.params import (_axis_size, count_params, param_bytes,
                                       plan_leaves, resolve_pspec, torch_dtype)

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
    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "num_chips": num_chips, "mode": shape.mode,
        "params": count_params(model_plan(cfg)),
        "arg_leaves": leaves,
        "analytic_memory": analytic_memory(cfg, shape, mesh,
                                           policy=policy_override),
        **analytic_terms(cfg, shape, num_chips,
                         q_chunk=int(os.environ.get("REPRO_Q_CHUNK", "512"))),
    }
    if verbose:
        agb = result["analytic_memory"]["total"] / 2**30
        dom = max(("t_compute_analytic", "t_memory_analytic"),
                  key=lambda k: result[k])
        print(f"{arch:24s} {shape_name:12s} chips={num_chips:3d} "
              f"(H100 analytic est {agb:6.2f}GiB/dev) "
              f"Tc={result['t_compute_analytic']*1e3:8.3f}ms "
              f"Tm={result['t_memory_analytic']*1e3:8.3f}ms dom={dom}")
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
