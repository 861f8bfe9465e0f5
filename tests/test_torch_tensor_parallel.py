"""The sharded steps' division of work (``launch/steps.py``,
``models/partition.py``) on live ``gloo`` meshes against the
single-process port step.

One spawn of four ranks a mesh: 2 x 2 and 1 x 4 (``data``, ``model``),
rendezvous through a ``FileStore`` under ``tmp_path``.  Eight reduced
float32 configs and a variant, two period repeats deep: StableLM-3B (heads divide
``model``), Mixtral 8x7B (1 KV head: K/V whole, the decode cache split by
sequence; experts over ``model``; capacity factor 0.5, so tokens drop),
Jamba (Mamba and MoE; capacity factor 0.55, so the capacity pads to the
data ranks), RWKV-6, DeepSeek-V2 (MLA, its latent cache split by
sequence, a shared expert), Gemma 2 (window, softcaps, tied embeddings;
2 KV heads, split on 2 x 2 and whole on 1 x 4), Phi-3-vision (the patch
prefix), SeamlessM4T (the encoder and cross-attention; a 128-token
decoder prompt over 160 frames, so that the plans' decoder prompt,
min(128, seq), is the one run) and Jamba with 2 experts (expert-parallel
on 2 x 2; on 1 x 4 tensor-parallel within each expert).

Each rank runs one train step, a prefill and two decode steps on its
shards and rows, and the single-process step on the whole batch from the
same weights (the unscaled stacked leaves redrawn at unit gain, as
``tests/test_torch_training.py`` draws them; ``_inputs``).  Held:

* the loss, every gradient shard within 1e-4 of the leaf's max |value|,
  every updated shard within 1e-4 of AdamW applied in lockstep to the
  whole parameters with the step's own gradients and norm;
* prefill and decode logits within 1e-4 of their max |value|, greedy
  tokens identical;
* the gathered parameter bytes alive at once never above the largest
  prefix layer's, period repeat's or embedding's (the gather's tally);
* each attention, scan and FFN piece a rank runs sees its ``1/m`` of the
  heads, channels or columns, and each MoE buffer block is computed by
  exactly one rank;
* each rank's collective tally equals the dry run's analytic count
  (``launch/dryrun.py::collective_bytes``) byte for byte.
"""
import dataclasses
import math
import multiprocessing
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.base import InputShape, get_config, reduced

ARCHS = ("stablelm_3b", "mixtral_8x7b", "jamba_v0_1_52b", "rwkv6_1_6b",
         "deepseek_v2_236b", "gemma2_27b", "phi_3_vision_4_2b",
         "seamless_m4t_large_v2", "jamba_2_experts")
# reduced Jamba with 2 experts: on 1 x 4 they do not divide `model`, so
# the experts' leaves take their `alt` (each expert's d_ff split)
VARIANTS = {"jamba_2_experts": ("jamba_v0_1_52b", 2)}
# (arch, query heads, KV heads): on a `model` axis of 4 neither count
# divides, so every rank computes the attention block alike
# (tests/test_torch_live_meshes.py)
HEADS = {"stablelm_6_heads": ("stablelm_3b", 6, 6),
         "starcoder2_6_heads": ("starcoder2_7b", 6, 2)}
CAPACITY = {"mixtral_8x7b": 0.5, "jamba_v0_1_52b": 0.55}
# SeamlessM4T's decoder prompt and cache (= frames): the plans give a
# prefill min(128, seq) decoder tokens over seq frames
PROMPT = {"seamless_m4t_large_v2": 128}
CAPS = {"seamless_m4t_large_v2": 160}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
BATCH, SEQ, CAP = 4, 16, 24
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=4)


def _cfg(name):
    if name in HEADS:
        arch, heads, kv = HEADS[name]
        cfg = reduced(get_config(arch)).replace(dtype="float32", repeats=2)
        return cfg.replace(attn=dataclasses.replace(
            cfg.attn, num_heads=heads, num_kv_heads=kv))
    arch, experts = VARIANTS.get(name, (name, None))
    cfg = reduced(get_config(arch)).replace(dtype="float32", repeats=2)
    if arch in CAPACITY:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=CAPACITY[arch]))
    if experts:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=experts))
    return cfg


def _inputs(cfg, seed):
    """Float32 weights from a seeded generator, every stacked period leaf
    (the encoder's too) without a ``fan_in`` redrawn at unit gain (a std of 1/sqrt(its first
    unstacked dimension), as ``tests/test_torch_training.py::_unit_gain``
    does: the plan draws them at 1/sqrt(repeats), and the gradients of
    such a stack are so ill-conditioned that a 1e-7 relative change of
    the weights moves Gemma 2's by 6e-3 of their max); a numpy batch."""
    from repro_torch.models.model import Model, model_plan
    from repro_torch.models.params import map_plan
    params = map_plan(lambda t: t.detach().float().clone(),
                      Model(cfg, seed=seed, device="cpu").params)
    rng = np.random.default_rng(seed + 100)
    for path, p in _leaf_items(model_plan(cfg)):
        if "period" in path and p.fan_in is None and p.init == "normal":
            node = params
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = torch.from_numpy((rng.standard_normal(
                p.shape) / np.sqrt(p.shape[1])).astype(np.float32))
    rng = np.random.default_rng(seed)
    batch = _batch(cfg, rng, SEQ, SEQ)
    batch["labels"] = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, tuple(batch["tokens"].shape)))
    return params, batch


def _batch(cfg, rng, positions, frames):
    """Tokens filling ``positions`` after a VLM's patch prefix, the
    patches, or an enc-dec model's ``frames`` frames."""
    out = {}
    if cfg.frontend.kind == "vision":
        positions -= cfg.frontend.num_prefix
        out["embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, cfg.frontend.num_prefix, cfg.frontend.embed_dim))
            .astype(np.float32))
    if cfg.encoder is not None:
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (BATCH, frames, cfg.frontend.embed_dim)).astype(np.float32))
    out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                  (BATCH, positions)))
    return out


def _f32_plan(plan):
    """The plan with its bf16 leaves as the float32 the tests store."""
    from repro_torch.models.params import map_plan
    return map_plan(lambda p: dataclasses.replace(p, dtype="float32")
                    if p.dtype == "bfloat16" else p, plan)


def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _leaf_items(tree[k], path + (k,))]
    return [(path, tree)]


def _rel(a, b):
    top = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / top if top else (0.0 if diff == 0 else math.inf)


def _worst(got, want):
    from repro_torch.models.params import plan_leaves
    return max(_rel(a, b) for a, b in zip(plan_leaves(got),
                                          plan_leaves(want)))


class _Record:
    """The model modules' kernel, FFN and expert calls, with the shapes
    each sees (only while ``on``)."""

    def __init__(self):
        self.on = False
        self.calls = []

    def wrap(self, module, name, what):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            if self.on:
                self.calls.append(what(*args, **kw))
            return fn(*args, **kw)
        setattr(module, name, wrapped)


def _install(record):
    from repro_torch.models import attention, model, moe, rwkv, ssm
    record.wrap(attention, "flash_attention",
                lambda q, k, v, **kw: ("flash", q.shape[2], k.shape[2]))
    record.wrap(rwkv, "rwkv6_scan", lambda r, *a, **kw: ("wkv", r.shape[2]))
    record.wrap(ssm, "selective_scan",
                lambda x, *a, **kw: ("scan", x.shape[-1]))
    record.wrap(model, "gated_ffn",
                lambda x, w_in, w_out, act: ("ffn", w_in.shape[2]))
    record.wrap(moe, "_experts",
                lambda buf, wi, wo, act, block: ("experts", block))


def _gathered_bound(cfg, mesh):
    """Bytes of the largest prefix layer, period repeat, embedding or head
    gathered over the batch axes (model dims kept local)."""
    from repro_torch.models.model import model_plan
    from repro_torch.models.params import plan_leaves, pspecs_from_plan
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    plan = model_plan(cfg)
    specs = pspecs_from_plan(plan, mesh)

    def size(p, spec, per=1):
        axes = [a for e in spec for a in
                ((e,) if isinstance(e, str) else (e or ()))]
        if not any(a in ("pod", "data") and shape[a] > 1 for a in axes):
            return 0
        n = int(np.prod(p.shape))
        if "model" in axes:
            n //= shape["model"]
        return n * 4 // per

    def group(tree, spec, per=1):
        return sum(size(p, s, per) for p, s in zip(plan_leaves(tree),
                                                  plan_leaves(spec)))

    parts = [group(plan["embed"], specs["embed"])]
    if "frontend_proj" in plan:
        parts.append(group(plan["frontend_proj"], specs["frontend_proj"]))
    if "encoder" in plan:
        parts.append(group(plan["encoder"]["period"],
                           specs["encoder"]["period"],
                           cfg.encoder.num_layers))
    if "lm_head" in plan:
        parts.append(group(plan["lm_head"], specs["lm_head"]))
    for key in plan.get("prefix", {}):
        parts.append(group(plan["prefix"][key], specs["prefix"][key]))
    if "period" in plan:
        parts.append(group(plan["period"], specs["period"], cfg.repeats))
    return max(parts)


def _run_arch(arch, mesh, rank, record):
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import mesh_view
    from repro_torch.launch.shardings import (gather_tree, local_shard,
                                              shard_tree)
    from repro_torch.launch.specs import batch_plan, decode_arg_plans
    from repro_torch.launch.steps import build_step
    from repro_torch.models import partition
    from repro_torch.models.model import decode_step, model_plan, prefill
    from repro_torch.models.params import map_plan, pspecs_from_plan
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import make_train_step, trainable

    cfg = _cfg(arch)
    params, batch = _inputs(cfg, seed=7)
    ocfg = opt.AdamWConfig(**OCFG)
    view = mesh_view(mesh)
    out = {"coord": tuple(mesh.get_coordinate())}
    pplan = model_plan(cfg)
    p_specs = pspecs_from_plan(pplan, mesh)

    # the prefill's inputs: the prompt (a VLM's patches first) fills
    # `first` positions, which the decode steps follow
    cap = CAPS.get(arch, CAP)
    first = PROMPT.get(arch, SEQ)
    pre_batch = _batch(cfg, np.random.default_rng(11), first, cap)
    extra = {k: pre_batch[k] for k in ("embeds", "frames") if k in pre_batch}

    # ---- the single-process step and serving on the whole batch
    held = {}
    one = make_train_step(cfg, ocfg, remat=True,
                          on_grads=lambda p, g: held.update(grads=g))
    full = trainable(params, "cpu")
    full, _, fdiag = one(full, opt.init_state(full), batch)
    ref_grads = held.pop("grads")
    logits, cache = prefill(params, cfg, pre_batch["tokens"], seq_cap=cap,
                            **extra)
    ref_logs, ref_toks = [logits], [logits.argmax(-1).to(torch.int32)]
    for i in range(2):
        pos = torch.full((BATCH,), first + i, dtype=torch.int32)
        logits = decode_step(params, cfg, cache, ref_toks[-1], pos)
        ref_logs.append(logits)
        ref_toks.append(logits.argmax(-1).to(torch.int32))

    # ---- one sharded train step
    shape = InputShape("t", SEQ, BATCH, "train")
    step, *_ = build_step(cfg, shape, mesh, ocfg=ocfg,
                          on_grads=lambda p, g: held.update(grads=g))
    local = shard_tree(map_plan(torch.clone, params), p_specs, mesh)
    state = opt.init_state(local)
    rows = shard_tree(batch, pspecs_from_plan(batch_plan(cfg, shape, mesh),
                                              mesh), mesh)
    coll.reset_tally()
    partition.reset_gathered()
    record.calls.clear()
    record.on = True
    local, state, diag = step(local, state, rows)
    record.on = False
    out["tally"] = {"train": coll.read_tally()}
    f32 = _f32_plan(pplan)
    out["count"] = {"train": collective_bytes(cfg, shape, view, plan=f32)}
    out["gathered"] = partition.read_gathered()
    out["bound"] = _gathered_bound(cfg, mesh)
    out["calls"] = {"train": list(record.calls)}
    grads = held.pop("grads")
    whole = gather_tree(grads, p_specs, mesh)
    lock = map_plan(torch.clone, params)
    lock, _, _ = opt.apply_updates(ocfg, lock, whole, opt.init_state(lock),
                                   gnorm=diag["grad_norm"])
    cut = shard_tree(ref_grads, p_specs, mesh)
    out["train"] = {
        "loss": (float(diag["loss"]), float(fdiag["loss"])),
        "grad_norm": (float(diag["grad_norm"]), float(fdiag["grad_norm"])),
        "grads": _worst(grads, cut),
        "params": _worst(local, shard_tree(lock, p_specs, mesh))}

    # ---- a prefill and two decode steps
    pshape = InputShape("p", cap, BATCH, "prefill")
    dshape = InputShape("d", cap, BATCH, "decode")
    pre, *_ = build_step(cfg, pshape, mesh)
    serve, *_ = build_step(cfg, dshape, mesh)
    cplan, tplan, _ = decode_arg_plans(cfg, dshape, mesh)
    tspec = pspecs_from_plan(tplan, mesh)
    c_specs = pspecs_from_plan(cplan, mesh)
    local = shard_tree(params, p_specs, mesh)
    prow = shard_tree(pre_batch,
                      pspecs_from_plan(batch_plan(cfg, pshape, mesh), mesh),
                      mesh)
    coll.reset_tally()
    record.calls.clear()
    record.on = True
    logits, cache = pre(local, prow)
    out["tally"]["prefill"] = coll.read_tally()
    # a prefill's collectives follow its prompt, not the cache's capacity
    # (the shape's seq_len; an enc-dec prompt is min(128, seq) over seq
    # frames)
    out["count"]["prefill"] = collective_bytes(
        cfg, InputShape("p", cap if cfg.encoder is not None else SEQ, BATCH,
                        "prefill"), view, plan=f32)
    out["calls"]["prefill"] = list(record.calls)
    stored = map_plan(lambda t: tuple(t.shape), cache)
    logs, toks = [logits], [logits.argmax(-1).to(torch.int32)]
    out["tally"]["decode"] = []
    for i in range(2):
        pos = torch.full((BATCH,), first + i, dtype=torch.int32)
        coll.reset_tally()
        logits, cache = serve(local, cache, toks[-1],
                              shard_tree(pos, tspec, mesh))
        out["tally"]["decode"].append(coll.read_tally())
        logs.append(logits)
        toks.append(logits.argmax(-1).to(torch.int32))
    record.on = False
    out["calls"]["decode"] = list(record.calls[len(out["calls"]["prefill"]):])
    out["count"]["decode"] = collective_bytes(cfg, dshape, view, plan=f32)
    out["cache_kept"] = stored == map_plan(lambda t: tuple(t.shape), cache)
    out["cache_stored"] = stored == zip_shapes(cplan, c_specs, mesh)
    rows_of = local_shard(torch.arange(BATCH), tspec, mesh)
    out["decode"] = {
        "logits": max(_rel(a, b[rows_of]) for a, b in zip(logs, ref_logs)),
        "tokens": all(torch.equal(a, b[rows_of])
                      for a, b in zip(toks, ref_toks))}
    return out


def zip_shapes(plan, specs, mesh):
    """Each cache leaf's stored shape on this rank."""
    from repro_torch.launch.shardings import zip_map
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def leaf(p, spec):
        out = []
        for dim, e in zip(p.shape, tuple(spec) + (None,) * len(p.shape)):
            axes = (e,) if isinstance(e, str) else (e or ())
            out.append(dim // int(np.prod([shape[a] for a in axes] or [1])))
        return tuple(out)
    return zip_map(leaf, plan, specs)


def _worker(rank, world, shape, store_path, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_device_mesh(shape, ("data", "model"), "cpu")
        record = _Record()
        _install(record)
        res = {arch: _run_arch(arch, mesh, rank, record) for arch in ARCHS}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, shape in MESHES.items():
        d = tmp_path_factory.mktemp(f"tp{name}")
        world = int(np.prod(shape))
        procs = [ctx.Process(target=_worker,
                             args=(r, world, shape, str(d / "store"), str(d)))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive, f"mesh {name}: ranks still running after 240 s"
        assert all(p.exitcode == 0 for p in procs), \
            f"mesh {name}: exit codes {[p.exitcode for p in procs]}"
        out[name] = [torch.load(d / f"rank{r}.pt", weights_only=False)
                     for r in range(world)]
    return out


CASES = [(mesh, arch) for mesh in MESHES for arch in ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_train_step_matches_single_process(runs, mesh, arch):
    for r in runs[mesh]:
        got = r[arch]["train"]
        assert got["loss"][0] == pytest.approx(got["loss"][1], rel=1e-6)
        assert got["grad_norm"][0] == pytest.approx(got["grad_norm"][1],
                                                     rel=1e-5)
        assert got["grads"] <= 1e-4
        assert got["params"] <= 1e-4


@pytest.mark.parametrize("mesh,arch", CASES)
def test_prefill_and_decode_match_single_process(runs, mesh, arch):
    for r in runs[mesh]:
        got = r[arch]["decode"]
        assert got["tokens"]
        assert got["logits"] <= 1e-4
        assert r[arch]["cache_stored"] and r[arch]["cache_kept"]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_collective_tally_equals_the_dry_run_count(runs, mesh, arch):
    for r in runs[mesh]:
        tally, count = r[arch]["tally"], r[arch]["count"]
        assert tally["train"] == count["train"]
        assert tally["prefill"] == count["prefill"]
        for step in tally["decode"]:
            assert step == count["decode"]
        assert sum(count["train"].values()) > 0


@pytest.mark.parametrize("mesh,arch", CASES)
def test_gathered_parameters_stay_within_one_layer(runs, mesh, arch):
    data = MESHES[mesh][0]
    for r in runs[mesh]:
        got, bound = r[arch]["gathered"], r[arch]["bound"]
        assert got["peak"] <= bound
        assert got["largest"] <= bound
        if data > 1:
            assert got["peak"] > 0 and bound > 0
        else:
            assert got["made"] == 0


def _pieces(cfg, m):
    """What each recorded call must see on a ``model`` axis of ``m``."""
    a = cfg.attn
    want = {"flash": a.num_heads // m, "ffn": cfg.ffn.d_ff // m}
    if cfg.mamba is not None:
        want["scan"] = cfg.mamba.expand * cfg.d_model // m
    if cfg.rwkv is not None:
        want["wkv"] = cfg.d_model // cfg.rwkv.head_dim // m
    return want


@pytest.mark.parametrize("mesh,arch", CASES)
def test_each_rank_runs_its_share(runs, mesh, arch):
    cfg = _cfg(arch)
    m = MESHES[mesh][1]
    want = _pieces(cfg, m)
    ranks = runs[mesh]
    mixers = {l.mixer for l in cfg.layer_specs()}
    for phase in ("train", "prefill", "decode"):
        seen = set()
        for r in ranks:
            for call in r[arch]["calls"][phase]:
                if call[0] in want:
                    assert call[1] == want[call[0]], (phase, call)
                    seen.add(call[0])
        kinds = {"scan"} if "mamba" in mixers else set()
        kinds |= {"wkv"} if "rwkv6" in mixers else set()
        if phase != "decode" and "attn" in mixers:
            kinds.add("flash")
        assert kinds <= seen, (phase, seen)
    # every MoE buffer block computed by exactly one rank, call by call
    if cfg.moe is None:
        return
    spec = cfg.moe
    per_rank = [[c[1] for c in r[arch]["calls"]["train"]
                 if c[0] == "experts"] for r in ranks]
    assert len({len(p) for p in per_rank}) == 1 and per_rank[0]
    for blocks in zip(*per_rank):
        slots = max(b[1][1] for b in blocks)
        grid = np.zeros((spec.num_experts, slots, spec.d_ff), dtype=int)
        for (e0, e1), (c0, c1), (f0, f1) in blocks:
            grid[e0:e1, c0:c1, f0:f1] += 1
        assert (grid == 1).all()                # each cell by one rank
