"""Megatron sequence parallelism in the sharded steps (``launch/steps.py``
with ``policy_override=make_policy(..., seq_parallel=True)``,
``models/partition.py``'s ``enter`` / ``leave`` / ``shared``) on live
``gloo`` meshes against the single-process port step.

One spawn of four ranks a mesh: 2 x 2 and 1 x 4 (``data``, ``model``),
rendezvous through a ``FileStore`` under ``tmp_path``.  The configs and
weights are ``tests/test_torch_tensor_parallel.py``'s (reduced float32,
two period repeats; MoE capacity factors that drop tokens; Jamba with 2
experts; the unscaled stacked leaves redrawn at unit gain).  Each rank
runs two train steps and a prefill under the ``seq_parallel`` policy.
Held:

* each train step's loss, and every gradient shard within 1e-4 of the
  leaf's max |value| against the single-process step's gradients at the
  same (gathered) parameters; every updated shard within 1e-4 of AdamW
  applied in lockstep to the whole parameters with the step's own
  gradients and norm;
* the prefill's last-position logits within 1e-4 of the single-process
  prefill's on every rank, greedy tokens identical, and each stored cache
  shard within 1e-4 of the single-process cache's (positions exact);
* each rank's collective tally equals the dry run's count under the same
  policy (``dryrun.collective_bytes(..., policy=...)``) byte for byte;
* every layer (and encoder layer) a rank runs sees its ``S / m`` rows of
  the residual stream.
"""
import multiprocessing
import os

import numpy as np
import pytest
import torch

from test_torch_tensor_parallel import (ARCHS, CAP, CAPS, MESHES, OCFG,
                                        PROMPT, SEQ, _batch, _cfg, _f32_plan,
                                        _inputs, _rel, _worst)


class _Rows:
    """The rows of the residual stream each layer of a sequence forward
    sees (only while ``on``)."""

    def __init__(self):
        self.on = False
        self.seen = []

    def install(self):
        from repro_torch.models import model
        for name, kind in (("apply_layer_seq", "layer"),
                           ("_encoder_layer", "encoder")):
            fn = getattr(model, name)

            def wrapped(lp, h, *a, fn=fn, kind=kind, **kw):
                if self.on:
                    self.seen.append((kind, h.shape[1]))
                return fn(lp, h, *a, **kw)
            setattr(model, name, wrapped)


def _rows_want(cfg, seq, frames, m):
    want = {"layer": seq // m}
    if cfg.encoder is not None:
        want["encoder"] = frames // m
    return want


def _cache_err(got, want):
    """Worst relative error over a cache's float leaves; int leaves must
    be equal (inf otherwise)."""
    from repro_torch.models.params import plan_leaves
    worst = 0.0
    for a, b in zip(plan_leaves(got), plan_leaves(want)):
        if a.shape != b.shape:
            return float("inf")
        if a.is_floating_point():
            worst = max(worst, _rel(a.float(), b.float()))
        elif not torch.equal(a, b):
            return float("inf")
    return worst


def _run_arch(arch, mesh, rows):
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import mesh_view
    from repro_torch.launch.shardings import (gather_tree, make_policy,
                                              shard_tree)
    from repro_torch.launch.specs import batch_plan, decode_arg_plans
    from repro_torch.launch.steps import build_step
    from repro_torch.configs.base import InputShape
    from repro_torch.models.model import model_plan, prefill
    from repro_torch.models.params import map_plan, pspecs_from_plan
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import make_train_step, trainable

    cfg = _cfg(arch)
    params, batch = _inputs(cfg, seed=7)
    ocfg = opt.AdamWConfig(**OCFG)
    view = mesh_view(mesh)
    m = view.shape["model"]
    p_specs = pspecs_from_plan(model_plan(cfg), mesh)
    f32 = _f32_plan(model_plan(cfg))
    out = {"train": [], "tally": {}, "count": {}, "rows": {}}

    # ---- two sharded train steps, each against the single-process step
    # at the same (gathered) parameters
    held = {}
    one = make_train_step(cfg, ocfg, remat=True,
                          on_grads=lambda p, g: held.update(ref=g))
    shape = InputShape("t", SEQ, len(batch["tokens"]), "train")
    policy = make_policy(cfg, shape, view, seq_parallel=True)
    step, *_ = build_step(cfg, shape, mesh, ocfg=ocfg, policy_override=policy,
                          on_grads=lambda p, g: held.update(grads=g))
    local = shard_tree(map_plan(torch.clone, params), p_specs, mesh)
    state = opt.init_state(local)
    lock, lock_state = map_plan(torch.clone, params), opt.init_state(params)
    data = shard_tree(batch, pspecs_from_plan(batch_plan(cfg, shape, mesh),
                                              mesh), mesh)
    count = collective_bytes(cfg, shape, view, plan=f32, policy=policy)
    out["count"]["train"] = count
    out["tally"]["train"] = []
    for _ in range(2):
        whole = gather_tree(local, p_specs, mesh)
        _, _, fdiag = one(trainable(whole, "cpu"),
                          opt.init_state(whole), batch)
        coll.reset_tally()
        rows.seen.clear()
        rows.on = True
        local, state, diag = step(local, state, data)
        rows.on = False
        out["tally"]["train"].append(coll.read_tally())
        out["rows"].setdefault("train", list(rows.seen))
        grads = held.pop("grads")
        lock, lock_state, _ = opt.apply_updates(
            ocfg, lock, gather_tree(grads, p_specs, mesh), lock_state,
            gnorm=diag["grad_norm"])
        out["train"].append({
            "loss": (float(diag["loss"]), float(fdiag["loss"])),
            "grads": _worst(grads, shard_tree(held.pop("ref"), p_specs,
                                              mesh)),
            "params": _worst(local, shard_tree(lock, p_specs, mesh))})

    # ---- a prefill under the same policy
    cap = CAPS.get(arch, CAP)
    first = PROMPT.get(arch, SEQ)
    pre_batch = _batch(cfg, np.random.default_rng(11), first, cap)
    extra = {k: pre_batch[k] for k in ("embeds", "frames") if k in pre_batch}
    logits, cache = prefill(params, cfg, pre_batch["tokens"], seq_cap=cap,
                            **extra)
    pshape = InputShape("p", cap, len(pre_batch["tokens"]), "prefill")
    ppolicy = make_policy(cfg, pshape, view, seq_parallel=True)
    pre, *_ = build_step(cfg, pshape, mesh, policy_override=ppolicy)
    b_specs = pspecs_from_plan(batch_plan(cfg, pshape, mesh), mesh)
    c_specs = pspecs_from_plan(decode_arg_plans(cfg, pshape, mesh)[0], mesh)
    coll.reset_tally()
    rows.seen.clear()
    rows.on = True
    got, got_cache = pre(shard_tree(params, p_specs, mesh),
                         shard_tree(pre_batch, b_specs, mesh))
    rows.on = False
    out["tally"]["prefill"] = coll.read_tally()
    out["rows"]["prefill"] = list(rows.seen)
    out["count"]["prefill"] = collective_bytes(
        cfg, InputShape("p", cap if cfg.encoder is not None else SEQ,
                        len(pre_batch["tokens"]), "prefill"), view,
        plan=f32, policy=ppolicy)
    rows_of = shard_tree(torch.arange(len(logits)), (b_specs["tokens"][0],),
                         mesh)
    out["prefill"] = {
        "logits": _rel(got, logits[rows_of]),
        "tokens": torch.equal(got.argmax(-1), logits[rows_of].argmax(-1)),
        "cache": _cache_err(got_cache, shard_tree(cache, c_specs, mesh))}
    out["want_rows"] = {
        "train": _rows_want(cfg, SEQ, SEQ, m),
        "prefill": _rows_want(cfg, first, cap, m)}
    return out


def _worker(rank, world, shape, store_path, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_device_mesh(shape, ("data", "model"), "cpu")
        rows = _Rows()
        rows.install()
        res = {arch: _run_arch(arch, mesh, rows) for arch in ARCHS}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, shape in MESHES.items():
        d = tmp_path_factory.mktemp(f"sp{name}")
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
def test_train_steps_match_single_process(runs, mesh, arch):
    for r in runs[mesh]:
        for got in r[arch]["train"]:
            assert got["loss"][0] == pytest.approx(got["loss"][1], rel=1e-6)
            assert got["grads"] <= 1e-4
            assert got["params"] <= 1e-4


@pytest.mark.parametrize("mesh,arch", CASES)
def test_prefill_matches_single_process(runs, mesh, arch):
    for r in runs[mesh]:
        got = r[arch]["prefill"]
        assert got["tokens"]
        assert got["logits"] <= 1e-4
        assert got["cache"] <= 1e-4


@pytest.mark.parametrize("mesh,arch", CASES)
def test_tally_equals_the_dry_run_count(runs, mesh, arch):
    for r in runs[mesh]:
        tally, count = r[arch]["tally"], r[arch]["count"]
        for step in tally["train"]:
            assert step == count["train"]
        assert tally["prefill"] == count["prefill"]
        assert count["train"]["reduce_scatter"] > 0


@pytest.mark.parametrize("mesh,arch", CASES)
def test_each_layer_sees_its_rows_of_the_stream(runs, mesh, arch):
    for r in runs[mesh]:
        for phase in ("train", "prefill"):
            seen, want = r[arch]["rows"][phase], r[arch]["want_rows"][phase]
            assert seen and {k for k, _ in seen} == set(want)
            for kind, n in seen:
                assert n == want[kind], (phase, kind, n)


def test_a_sequence_that_does_not_divide_model_is_refused():
    """Before any collective: a prompt (with a VLM's patch prefix) whose
    length does not divide ``model`` under ``seq_parallel``."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.common import ShardPolicy
    from repro_torch.models.model import Model, prefill, train_loss
    from repro_torch.models.partition import Part
    part = Part(sizes={"data": 1, "model": 4}, coord={"data": 0, "model": 0},
                groups={}, rows=(), policy=ShardPolicy(), specs=None,
                seq=True)
    for arch, n in (("stablelm_3b", 10), ("phi_3_vision_4_2b", 6)):
        cfg = reduced(get_config(arch)).replace(dtype="float32")
        params = Model(cfg, device="cpu").params
        tokens = torch.zeros((2, n), dtype=torch.long)
        kw = {}
        if cfg.frontend.kind == "vision":
            kw["embeds"] = torch.zeros((2, cfg.frontend.num_prefix,
                                        cfg.frontend.embed_dim))
            assert (n + cfg.frontend.num_prefix) % 4
        with pytest.raises(ValueError, match="C1"):
            train_loss(params, cfg, {"tokens": tokens, "labels": tokens,
                                     **kw}, part=part)
        with pytest.raises(ValueError, match="C1"):
            prefill(params, cfg, tokens, part=part, **kw)
