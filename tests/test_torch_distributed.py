"""The sharded steps of ``repro_torch.launch.steps`` on a live
``torch.distributed`` mesh against the single-process port step.

Four spawned ``gloo`` processes form a 2 x 2 (``data``, ``model``) mesh
(rendezvous through a ``FileStore`` under ``tmp_path``, never a port), and
one process a 1 x 1 mesh.  Each rank stores the parameters, Adam moments
and decode caches as its shards of their resolved specs and its rows of
the batch.  Models: reduced float32 StableLM-3B and reduced Mixtral 8x7B
(4 experts over ``model`` = 2, capacity factor 0.5 so that tokens drop),
each two period repeats deep.  Every rank runs one train step, a prefill
and two decode steps; rank 0 then runs the single-process step on the
whole batch (``training/trainer.make_train_step``, ``models/model.prefill``
and ``decode_step``) from the same weights and inputs, in the same
process, and every result is written for the checks below: the loss
within 1e-6 relative; every gathered gradient within 1e-4 of the leaf's
max |value|; every updated parameter within 1e-4 of the leaf's max
|value| of AdamW applied to the whole parameters with the step's own
gathered gradients and norm (in lockstep: Adam's g / (|g| + eps) turns
rounding in a near-zero gradient into a full-size update, so the update
is held to the single-process optimizer on the same gradients, and the
gradients to the single-process step's); each rank's stored bytes equal
to the dry run's ``_leaf_bytes_per_device``; decoded tokens identical and
logits within 1e-4 of their max |value|.  On the 1 x 1 mesh every result
has the single-process step's bits.
"""
import dataclasses
import math
import multiprocessing
import os

import numpy as np
import pytest
import torch

from repro_torch.configs.base import InputShape, get_config, reduced

ARCHS = ("stablelm_3b", "mixtral_8x7b")
MESHES = {"2x2": (2, 2), "1x1": (1, 1)}
BATCH, SEQ, CAP = 4, 16, 24
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=4)


def _cfg(arch):
    cfg = reduced(get_config(arch)).replace(dtype="float32", repeats=2)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    return cfg


def _inputs(cfg, seed):
    """Float32 weights from a seeded generator, a numpy batch."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import map_plan
    params = map_plan(lambda t: t.detach().float().clone(),
                      Model(cfg, seed=seed, device="cpu").params)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    labels = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
    return params, {"tokens": torch.from_numpy(tokens),
                    "labels": torch.from_numpy(labels)}


def _f32_plan(plan):
    from repro_torch.models.params import map_plan
    return map_plan(lambda p: dataclasses.replace(p, dtype="float32")
                    if p.dtype == "bfloat16" else p, plan)


def _nbytes(tree):
    from repro_torch.models.params import plan_leaves
    return sum(t.numel() * t.element_size() for t in plan_leaves(tree))


def _greedy(logits):
    return logits.argmax(-1).to(torch.int32)


def _run_arch(arch, mesh, rank):
    """This rank's results for one model; rank 0 adds the single-process
    step's."""
    from repro_torch.launch.dryrun import _leaf_bytes_per_device
    from repro_torch.launch.shardings import gather_tree, shard_tree
    from repro_torch.launch.specs import batch_plan, decode_arg_plans
    from repro_torch.launch.steps import build_step
    from repro_torch.models.model import (decode_step, model_plan, prefill)
    from repro_torch.models.params import map_plan, pspecs_from_plan
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import make_train_step, trainable

    cfg = _cfg(arch)
    params, batch = _inputs(cfg, seed=5)
    ocfg = opt.AdamWConfig(**OCFG)
    out = {"coord": tuple(mesh.get_coordinate())}

    # ---- one train step on the mesh
    shape = InputShape("t", SEQ, BATCH, "train")
    held = {}
    step, *_ = build_step(cfg, shape, mesh, ocfg=ocfg,
                          on_grads=lambda p, g: held.update(grads=g))
    pplan = model_plan(cfg)
    p_specs = pspecs_from_plan(pplan, mesh)
    local = shard_tree(map_plan(torch.clone, params), p_specs, mesh)
    state = opt.init_state(local)
    rows = shard_tree(batch, pspecs_from_plan(batch_plan(cfg, shape, mesh),
                                              mesh), mesh)
    local, state, diag = step(local, state, rows)
    splan = opt.state_plan(_f32_plan(pplan))
    out["bytes"] = (_nbytes(local), _nbytes(state.mu), _nbytes(state.nu))
    out["want_bytes"] = (_leaf_bytes_per_device(_f32_plan(pplan), mesh),
                         _leaf_bytes_per_device(splan.mu, mesh),
                         _leaf_bytes_per_device(splan.nu, mesh))
    grads = gather_tree(held.pop("grads"), p_specs, mesh)
    lock = map_plan(torch.clone, params)
    lock, _, _ = opt.apply_updates(ocfg, lock, grads, opt.init_state(lock),
                                   gnorm=diag["grad_norm"])
    out["train"] = {"loss": float(diag["loss"]),
                    "grad_norm": float(diag["grad_norm"]),
                    "params": gather_tree(local, p_specs, mesh),
                    "mu": gather_tree(state.mu, p_specs, mesh),
                    "grads": grads, "lockstep_params": lock}

    # ---- prefill and two decode steps on the mesh
    pshape = InputShape("p", CAP, BATCH, "prefill")
    dshape = InputShape("d", CAP, BATCH, "decode")
    pre, *_ = build_step(cfg, pshape, mesh)
    serve, *_ = build_step(cfg, dshape, mesh)
    _, tplan, _ = decode_arg_plans(cfg, dshape, mesh)
    tspec = pspecs_from_plan(tplan, mesh)
    local = shard_tree(params, p_specs, mesh)
    logits, cache = pre(local, {"tokens": rows["tokens"]})
    logs, toks = [logits], [_greedy(logits)]
    for i in range(2):
        pos = torch.full((BATCH,), SEQ + i, dtype=torch.int32)
        logits, cache = serve(local, cache, toks[-1],
                              shard_tree(pos, tspec, mesh))
        logs.append(logits)
        toks.append(_greedy(logits))
    out["decode"] = {"logits": logs, "tokens": toks}

    if rank != 0:
        return out
    # ---- the single-process port step on the whole batch
    held = {}
    one = make_train_step(cfg, ocfg, remat=True,
                          on_grads=lambda p, g: held.update(grads=g))
    full = trainable(params, "cpu")
    full, fstate, fdiag = one(full, opt.init_state(full), batch)
    out["single_train"] = {"loss": float(fdiag["loss"]),
                           "grad_norm": float(fdiag["grad_norm"]),
                           "params": map_plan(torch.Tensor.detach, full),
                           "mu": fstate.mu, "grads": held["grads"]}
    logits, cache = prefill(params, cfg, batch["tokens"], seq_cap=CAP)
    logs, toks = [logits], [_greedy(logits)]
    for i in range(2):
        pos = torch.full((BATCH,), SEQ + i, dtype=torch.int32)
        logits = decode_step(params, cfg, cache, toks[-1], pos)
        logs.append(logits)
        toks.append(_greedy(logits))
    out["single_decode"] = {"logits": logs, "tokens": toks}
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
        res = {arch: _run_arch(arch, mesh, rank) for arch in ARCHS}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh, every rank's results (one spawn of the mesh's ranks)."""
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, shape in MESHES.items():
        d = tmp_path_factory.mktemp(f"mesh{name}")
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


def _leaves(tree):
    from repro_torch.models.params import plan_leaves
    return plan_leaves(tree)


def _rel(a, b):
    top = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / top if top else (0.0 if diff == 0 else math.inf)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_single_process(runs, arch):
    ranks = runs["2x2"]
    ref = ranks[0][arch]["single_train"]
    for r in ranks:
        got = r[arch]["train"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-6)
        assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-5)
        for g, want in zip(_leaves(got["grads"]), _leaves(ref["grads"])):
            assert _rel(g, want) <= 1e-4
        for p, want in zip(_leaves(got["params"]),
                           _leaves(got["lockstep_params"])):
            assert _rel(p, want) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_stores_the_planned_bytes(runs, arch):
    for r in runs["2x2"]:
        assert r[arch]["bytes"] == r[arch]["want_bytes"]
    # the 2 x 2 mesh holds less a rank than one rank holds
    assert runs["2x2"][0][arch]["bytes"][0] < runs["1x1"][0][arch]["bytes"][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_matches_single_process(runs, arch):
    ranks = runs["2x2"]
    ref = ranks[0][arch]["single_decode"]
    per = BATCH // 2
    for r in ranks:
        data = r[arch]["coord"][0]
        rows = slice(data * per, (data + 1) * per)
        got = r[arch]["decode"]
        for t, want in zip(got["tokens"], ref["tokens"]):
            assert torch.equal(t, want[rows])
        for lg, want in zip(got["logits"], ref["logits"]):
            assert _rel(lg, want[rows]) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_mesh_gives_the_single_process_bits(runs, arch):
    r = runs["1x1"][0][arch]
    assert r["bytes"] == r["want_bytes"]
    got, ref = r["train"], r["single_train"]
    assert got["loss"] == ref["loss"]
    assert got["grad_norm"] == ref["grad_norm"]
    for key in ("params", "mu", "grads"):
        for a, b in zip(_leaves(got[key]), _leaves(ref[key])):
            assert torch.equal(a, b)
    for key in ("tokens", "logits"):
        for a, b in zip(r["decode"][key], r["single_decode"][key]):
            assert torch.equal(a, b)
