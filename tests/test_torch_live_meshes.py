"""The sharded steps on the meshes and shapes the dry run counts beyond 2 x 2
and 1 x 4 (``launch/steps.py::build_step``): the ``pod`` axis, a decode
step of batch 1 (``long_500k``'s policy: the cache split along its
sequence, or its heads over ``model`` and its sequence over ``data``),
and query heads that do not divide ``model`` (every rank computes the
attention block alike), on live ``gloo`` meshes against the
single-process port step.

One spawn a mesh, rendezvous through a ``FileStore`` under ``tmp_path``;
the configs, weights and inputs are ``tests/test_torch_tensor_parallel.py``'s
(reduced float32, two period repeats, the unscaled stacked leaves redrawn
at unit gain):

* 2 x 2 x 2 (``pod``, ``data``, ``model``): StableLM-3B, Mixtral 8x7B
  (capacity factor 0.5) and Jamba: a train step, a prefill and two decode
  steps (``test_torch_tensor_parallel._run_arch``);
* 2 x 2 (``data``, ``model``), batch 1: two decode steps from a
  single-process prefill's cache, cut to each rank's shard under the
  batch-1 decode policy, for the long-context configs: Gemma 2, Mixtral,
  StarCoder2, RWKV-6, DeepSeek-V2 and Jamba;
* 1 x 4: StableLM with 6 query heads over 6 KV heads and StarCoder2 with
  6 over 2, under the default policy (a train step, a prefill, two
  decodes) and under ``seq_parallel`` (two train steps and a prefill,
  ``test_torch_seq_parallel._run_arch``).

Held: gradients and updated shards within 1e-4 of each leaf's max
|value|, logits within 1e-4 of their max, greedy tokens identical, and
each rank's collective tally equal to ``dryrun.collective_bytes`` byte
for byte in every step.
"""
import multiprocessing
import os

import numpy as np
import pytest
import torch

import test_torch_seq_parallel as sp
import test_torch_tensor_parallel as tp
from repro_torch.configs.base import InputShape

POD = ("stablelm_3b", "mixtral_8x7b", "jamba_v0_1_52b")
BATCH1 = ("gemma2_27b", "mixtral_8x7b", "starcoder2_7b", "rwkv6_1_6b",
          "deepseek_v2_236b", "jamba_v0_1_52b")
ALIKE = tuple(tp.HEADS)
# name -> (shape, axis names, jobs)
MESHES = {
    "pod_2x2x2": ((2, 2, 2), ("pod", "data", "model"),
                  [("steps", a) for a in POD]),
    "batch1_2x2": ((2, 2), ("data", "model"),
                   [("batch1", a) for a in BATCH1]),
    "alike_1x4": ((1, 4), ("data", "model"),
                  [(k, a) for a in ALIKE for k in ("steps", "seq_parallel")]),
}


def _batch1(arch, mesh):
    """Two decode steps of batch 1 through ``build_step`` from a
    single-process prefill's cache cut to this rank's shard, against
    ``decode_step`` on the whole cache."""
    from repro_torch.launch import collectives as coll
    from repro_torch.launch.dryrun import collective_bytes
    from repro_torch.launch.mesh import mesh_view
    from repro_torch.launch.shardings import shard_tree
    from repro_torch.launch.specs import decode_arg_plans
    from repro_torch.launch.steps import build_step
    from repro_torch.models.model import decode_step, model_plan, prefill
    from repro_torch.models.params import map_plan, pspecs_from_plan
    cfg = tp._cfg(arch)
    params, _ = tp._inputs(cfg, seed=7)
    tokens = tp._batch(cfg, np.random.default_rng(11), tp.SEQ,
                       tp.CAP)["tokens"][:1]
    _, cache = prefill(params, cfg, tokens, seq_cap=tp.CAP)
    shape = InputShape("d", tp.CAP, 1, "decode")
    cplan = decode_arg_plans(cfg, shape, mesh)[0]
    local = shard_tree(map_plan(torch.clone, cache),
                       pspecs_from_plan(cplan, mesh), mesh)
    params_local = shard_tree(params, pspecs_from_plan(model_plan(cfg), mesh),
                              mesh)
    serve, *_ = build_step(cfg, shape, mesh)
    token = tokens[:, -1].to(torch.int32)
    want_tok, got_tok = token, token
    out = {"logits": 0.0, "tokens": True, "tally": [],
           "count": collective_bytes(cfg, shape, mesh_view(mesh),
                                     plan=tp._f32_plan(model_plan(cfg)))}
    for i in range(2):
        pos = torch.full((1,), tp.SEQ + i, dtype=torch.int32)
        want = decode_step(params, cfg, cache, want_tok, pos)
        coll.reset_tally()
        got, local = serve(params_local, local, got_tok, pos)
        out["tally"].append(coll.read_tally())
        out["logits"] = max(out["logits"], tp._rel(got, want))
        want_tok = want.argmax(-1).to(torch.int32)
        got_tok = got.argmax(-1).to(torch.int32)
        out["tokens"] &= bool(torch.equal(got_tok, want_tok))
    return out


def _worker(rank, world, shape, names, jobs, store_path, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_device_mesh(shape, names, "cpu")
        record, rows = tp._Record(), sp._Rows()
        tp._install(record)
        rows.install()
        res = {}
        for kind, arch in jobs:
            if kind == "steps":
                res[(kind, arch)] = tp._run_arch(arch, mesh, rank, record)
            elif kind == "seq_parallel":
                res[(kind, arch)] = sp._run_arch(arch, mesh, rows)
            else:
                res[(kind, arch)] = _batch1(arch, mesh)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, (shape, names, jobs) in MESHES.items():
        d = tmp_path_factory.mktemp(name)
        world = int(np.prod(shape))
        procs = [ctx.Process(target=_worker,
                             args=(r, world, shape, names, jobs,
                                   str(d / "store"), str(d)))
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


STEPS = [(mesh, arch) for mesh in ("pod_2x2x2", "alike_1x4")
         for kind, arch in MESHES[mesh][2] if kind == "steps"]


@pytest.mark.parametrize("mesh,arch", STEPS)
def test_train_prefill_and_decode_match_single_process(runs, mesh, arch):
    for r in runs[mesh]:
        got = r[("steps", arch)]
        train = got["train"]
        assert train["loss"][0] == pytest.approx(train["loss"][1], rel=1e-6)
        assert train["grads"] <= 1e-4 and train["params"] <= 1e-4
        assert got["decode"]["tokens"]
        assert got["decode"]["logits"] <= 1e-4
        assert got["cache_stored"] and got["cache_kept"]


@pytest.mark.parametrize("mesh,arch", STEPS)
def test_steps_tally_equals_the_dry_run_count(runs, mesh, arch):
    for r in runs[mesh]:
        tally, count = r[("steps", arch)]["tally"], r[("steps", arch)]["count"]
        assert tally["train"] == count["train"]
        assert tally["prefill"] == count["prefill"]
        assert all(step == count["decode"] for step in tally["decode"])
        assert sum(count["train"].values()) > 0


@pytest.mark.parametrize("arch", POD)
def test_pod_axis_splits_the_rows_and_gathers_the_parameters(runs, arch):
    """Each of the 8 ranks holds its (pod, data) row of the batch: the
    ranks of one (pod, data) pair agree, the four pairs differ; the
    parameters sharded over ``data`` are gathered at use."""
    ranks = runs["pod_2x2x2"]
    coords = [r[("steps", arch)]["coord"] for r in ranks]
    assert sorted(coords) == [(p, d, m) for p in range(2) for d in range(2)
                              for m in range(2)]
    for r in ranks:
        assert r[("steps", arch)]["gathered"]["peak"] > 0


@pytest.mark.parametrize("arch", BATCH1)
def test_batch1_decode_matches_single_process(runs, arch):
    for r in runs["batch1_2x2"]:
        got = r[("batch1", arch)]
        assert got["tokens"]
        assert got["logits"] <= 1e-4
        assert len(got["tally"]) == 2
        assert all(step == got["count"] for step in got["tally"])
        assert sum(got["count"].values()) > 0


@pytest.mark.parametrize("arch", ALIKE)
def test_heads_not_dividing_model_run_alike(runs, arch):
    """Every rank's attention sees all the query heads (the block is
    computed alike), its FFN a quarter of the columns."""
    cfg = tp._cfg(arch)
    assert cfg.attn.num_heads % 4 and cfg.attn.num_kv_heads % 4
    for r in runs["alike_1x4"]:
        calls = r[("steps", arch)]["calls"]
        for phase in ("train", "prefill"):
            flash = [c for c in calls[phase] if c[0] == "flash"]
            ffn = [c for c in calls[phase] if c[0] == "ffn"]
            assert flash and all(c[1] == cfg.attn.num_heads for c in flash)
            assert ffn and all(c[1] == cfg.ffn.d_ff // 4 for c in ffn)


@pytest.mark.parametrize("arch", ALIKE)
def test_heads_not_dividing_model_under_seq_parallel(runs, arch):
    for r in runs["alike_1x4"]:
        got = r[("seq_parallel", arch)]
        for step in got["train"]:
            assert step["loss"][0] == pytest.approx(step["loss"][1],
                                                    rel=1e-6)
            assert step["grads"] <= 1e-4 and step["params"] <= 1e-4
        assert got["prefill"]["tokens"]
        assert got["prefill"]["logits"] <= 1e-4
        assert got["prefill"]["cache"] <= 1e-4
        for step in got["tally"]["train"]:
            assert step == got["count"]["train"]
        assert got["tally"]["prefill"] == got["count"]["prefill"]
        want = got["want_rows"]
        for phase in ("train", "prefill"):
            assert got["rows"][phase]
            assert all(n == want[phase][kind]
                       for kind, n in got["rows"][phase])
