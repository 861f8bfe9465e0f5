"""Both serving engines under a ``policy`` on a live ``model`` mesh
(``serving/engine.py::serving_part``, the dense slot cache and the paged
runtime on this rank's shares) against the JAX ``ServingEngine`` on the
same weights, on the CPU.

The JAX engines run here, in the test process: reduced float32 StableLM
(MHA, 4 KV heads) and Granite 3 8B cut to 8 query heads over 4 KV heads
(GQA), each dense and paged (plain; a step budget of 5 tokens on a pool
so small that a lane is preempted; speculative lanes, spec_k 3, drafting
from the plain run's output), and dense Granite with its reduced single
KV head (the slot cache then split along its sequence).  Their weights,
as numpy, go to spawned ``gloo`` ranks on 1 x 2 and 1 x 4 (``data``,
``model``) meshes, where every rank builds the port's engine with
``policy=make_policy(cfg, <decode shape>, mesh), mesh=mesh`` and serves
the same requests.  Held:

* every rank's tokens and every step's prefill / decode / drafted /
  accepted counts are the JAX engine's;
* every rank plans the same steps: chunks, preemptions and block tables
  agree across the ranks of a mesh;
* each rank's page pools hold 1/m of the unsharded pools' bytes, and its
  parameters 1/m of the split leaves';
* a sharded paged engine refuses to export its lanes.

Without spawned ranks: the refusals of ``serving_part`` (a foreign or
sequence-split policy, a mesh without a policy, batch axes of more than
one rank, KV heads that do not divide ``model`` in the paged backend),
each naming ROADMAP A7.7, and a policy without a mesh serving the same
tokens as none.
"""
import dataclasses
import multiprocessing
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models.model import Model as JaxModel
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import InputShape
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced

MESHES = {"1x2": (1, 2), "1x4": (1, 4)}
BASE = dict(max_slots=4, seq_cap=96, page_size=8, seed=0, chunk_tokens=16,
            attn_impl="ref")
TRACE = [(40, 4), (7, 8), (21, 2), (3, 6)]
# (backend, engine kwargs, trace): the tight pool preempts the second
# request (tests/test_torch_paged_runtime.py's forced preemption)
VARIANTS = {
    "dense": ("dense", {}, "trace"),
    "paged": ("paged", {}, "trace"),
    "paged_tight": ("paged", dict(seq_cap=32, page_size=4, pool_pages=6,
                                  chunk_tokens=8, step_tokens=5), "preempt"),
    "paged_spec": ("paged", dict(spec_k=3), "hints"),
}
CONFIGS = {"stablelm_3b": tuple(VARIANTS), "granite_gqa": tuple(VARIANTS),
           "granite_kv1": ("dense",)}
CASES = [(c, v) for c in CONFIGS for v in CONFIGS[c]]


def _cut(cfg, arch):
    if arch == "granite_gqa":
        return cfg.replace(attn=dataclasses.replace(
            cfg.attn, num_heads=8, num_kv_heads=4))
    return cfg


def _configs(name):
    arch = "granite_3_8b" if name.startswith("granite") else name
    return (_cut(reduced(get_config(arch)).replace(dtype="float32"), name),
            _cut(t_reduced(t_get_config(arch)).replace(dtype="float32"),
                 name))


def _specs(cfg, trace, hints=None):
    """(req_id, prompt, max_new, request kwargs) of a trace."""
    rng = np.random.default_rng(11)
    if trace == "preempt":
        return [(0, rng.integers(0, cfg.vocab_size, 8), 8,
                 dict(slo_ms=50.0, priority=2.0)),
                (1, rng.integers(0, cfg.vocab_size, 8), 8,
                 dict(priority=0.5))]
    out = [(i, rng.integers(0, cfg.vocab_size, n), mn, {})
           for i, (n, mn) in enumerate(TRACE)]
    if trace == "hints":
        out = [(i, p, mn, dict(draft_hints=np.array(hints[i])))
               for i, p, mn, _ in out]
    return out


def _drive(eng, requests, rows=None):
    """Serve ``requests``; the per-step counts, and (``rows``) each step's
    plan: chunks, preemptions and the block tables."""
    for r in requests:
        assert eng.submit(r)
    counts, plans = [], []
    while eng.has_work():
        rep = eng.step()
        eng.finalize_step(rep, float(len(counts)))
        counts.append((rep.kind, rep.prefill_tokens, rep.decode_tokens,
                       rep.drafted_tokens, rep.accepted_tokens))
        if rows is not None:
            plans.append(([(c[0].req_id,) + tuple(c[1:]) for c in rep.chunks],
                          list(rep.preempt_pairs),
                          {k: list(e.pages) for k, e in
                           sorted(eng.kv.tables.items())}))
        assert len(counts) < 500, "engine did not converge"
    return [list(r.output_tokens) for r in requests], counts, plans


def _kw(variant):
    backend, kw, _ = VARIANTS[variant]
    return {**BASE, **kw, "backend": backend}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX engines' tokens and step counts, and the weights (numpy)
    the spawned ranks load."""
    d = tmp_path_factory.mktemp("engines")
    out, weights = {}, {}
    for name, variants in CONFIGS.items():
        jcfg, _ = _configs(name)
        jparams = JaxModel(jcfg).init(jax.random.key(0))
        weights[name] = jax.tree.map(np.asarray, jparams)
        for variant in variants:
            trace = VARIANTS[variant][2]
            hints = out.get((name, "paged"), {}).get("tokens")
            specs = _specs(jcfg, trace, hints)
            eng = JaxEngine(jcfg, params=jparams, **_kw(variant))
            reqs = [JaxRequest(req_id=i, tenant="T1", prompt_len=len(p),
                               max_new_tokens=mn, arrival=0.0,
                               prompt_tokens=np.array(p), **kw)
                    for i, p, mn, kw in specs]
            tokens, counts, _ = _drive(eng, reqs)
            out[(name, variant)] = {"tokens": tokens, "counts": counts,
                                    "specs": specs}
    torch.save({"weights": weights, "runs": out}, d / "jax.pt")
    return d, out


def _worker(rank, world, shape, store_path, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.shardings import make_policy
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.params import plan_leaves
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_device_mesh(shape, ("data", "model"), "cpu")
        saved = torch.load(os.path.join(out_dir, "..", "jax.pt"),
                           weights_only=False)
        res = {}
        for name, variant in CASES:
            _, cfg = _configs(name)
            params = params_from_numpy(saved["weights"][name], device="cpu")
            policy = make_policy(cfg, InputShape("serve", 96, 4, "decode"),
                                 mesh)
            eng = ServingEngine(cfg, params, device="cpu", policy=policy,
                                mesh=mesh, **_kw(variant))
            specs = saved["runs"][(name, variant)]["specs"]
            reqs = [Request(req_id=i, tenant="T1", prompt_len=len(p),
                            max_new_tokens=mn, arrival=0.0,
                            prompt_tokens=np.array(p), **kw)
                    for i, p, mn, kw in specs]
            tokens, counts, plans = _drive(eng, reqs, rows=True)
            got = {"tokens": tokens, "counts": counts, "plans": plans,
                   "param_bytes": sum(t.numel() * t.element_size()
                                      for t in plan_leaves(eng.params))}
            if eng.runtime is not None:
                got["pool_bytes"] = sum(t.numel() * t.element_size()
                                        for t in plan_leaves(
                                            eng.runtime.pools))
                try:
                    eng.drain_requests(ship_state=True)
                    got["export"] = "exported"
                except ValueError as err:
                    got["export"] = str(err)
            res[(name, variant)] = got
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(jax_runs):
    base, _ = jax_runs
    ctx = multiprocessing.get_context("spawn")
    out = {}
    for name, shape in MESHES.items():
        d = base / f"mesh{name}"
        d.mkdir()
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


def _whole_bytes(name, variant):
    """The unsharded port engine's parameter and pool bytes."""
    from repro_torch.models.params import plan_leaves
    from repro_torch.serving.engine import ServingEngine
    _, cfg = _configs(name)
    eng = ServingEngine(cfg, device="cpu", **_kw(variant))
    pools = (sum(t.numel() * t.element_size()
                 for t in plan_leaves(eng.runtime.pools))
             if eng.runtime is not None else None)
    return eng.params, pools


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name,variant", CASES)
def test_tokens_and_step_counts_are_the_jax_engines(jax_runs, runs, mesh,
                                                    name, variant):
    want = jax_runs[1][(name, variant)]
    for r in runs[mesh]:
        got = r[(name, variant)]
        assert got["tokens"] == want["tokens"]
        assert got["counts"] == want["counts"]
    if variant == "paged_tight":
        assert any(plan[1] for plan in runs[mesh][0][(name, variant)]
                   ["plans"]), "the tight pool never preempted"
    if variant == "paged_spec":
        assert sum(c[4] for c in want["counts"]) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name,variant", CASES)
def test_every_rank_plans_the_same_steps(runs, mesh, name, variant):
    plans = [r[(name, variant)]["plans"] for r in runs[mesh]]
    assert plans[0] and all(p == plans[0] for p in plans[1:])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name,variant", CASES)
def test_each_rank_holds_its_share(runs, mesh, name, variant):
    from repro_torch.models.params import plan_leaves
    m = MESHES[mesh][1]
    whole, pools = _whole_bytes(name, variant)
    _, cfg = _configs(name)
    split = sum(t.numel() * t.element_size() for t in plan_leaves(whole))
    for r in runs[mesh]:
        got = r[(name, variant)]
        # every leaf divides or stays whole: the shards hold less than
        # the whole and at least 1/m of it
        assert split / m <= got["param_bytes"] < split
        if pools is not None:
            assert got["pool_bytes"] * m == pools
            assert "A7.7" in got["export"]


def _fake_mesh(shape):
    return SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)


def test_serving_part_refusals():
    from repro_torch.launch.shardings import make_policy
    from repro_torch.models.common import NO_POLICY
    from repro_torch.serving.engine import ServingEngine, serving_part
    _, cfg = _configs("stablelm_3b")
    _, kv1 = _configs("granite_kv1")
    mesh = _fake_mesh((1, 2))
    decode = make_policy(cfg, InputShape("s", 96, 4, "decode"), mesh)
    refusals = [
        (cfg, NO_POLICY, mesh, "dense"),
        (cfg, make_policy(cfg, InputShape("s", 96, 4, "decode"),
                          _fake_mesh((2, 2))), _fake_mesh((2, 2)), "dense"),
        (cfg, dataclasses.replace(decode, logits=None), mesh, "dense"),
        (cfg, make_policy(cfg, InputShape("p", 96, 4, "prefill"), mesh,
                          seq_parallel=True), mesh, "dense"),
        (kv1, make_policy(kv1, InputShape("s", 96, 4, "decode"), mesh),
         mesh, "paged"),
    ]
    for c, policy, m, backend in refusals:
        with pytest.raises(ValueError, match="A7.7"):
            serving_part(c, policy, m, backend)
        with pytest.raises(ValueError, match="A7.7"):
            ServingEngine(c, device="cpu", policy=policy, mesh=m,
                          backend=backend)


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_a_policy_without_a_mesh_changes_nothing(jax_runs, backend):
    from repro_torch.launch.shardings import make_policy
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    _, cfg = _configs("stablelm_3b")
    saved = torch.load(jax_runs[0] / "jax.pt", weights_only=False)
    from repro_torch.models.bridge import params_from_numpy
    params = params_from_numpy(saved["weights"]["stablelm_3b"], device="cpu")
    policy = make_policy(cfg, InputShape("s", 96, 4, "decode"),
                         _fake_mesh((1, 4)))
    want = jax_runs[1][("stablelm_3b", backend)]
    for kw in ({}, {"policy": policy}):
        eng = ServingEngine(cfg, params, device="cpu", **_kw(backend), **kw)
        reqs = [Request(req_id=i, tenant="T1", prompt_len=len(p),
                        max_new_tokens=mn, arrival=0.0,
                        prompt_tokens=np.array(p), **rkw)
                for i, p, mn, rkw in want["specs"]]
        tokens, counts, _ = _drive(eng, reqs)
        assert tokens == want["tokens"] and counts == want["counts"]
