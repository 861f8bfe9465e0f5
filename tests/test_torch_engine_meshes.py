"""The dense serving engine on live meshes whose batch axes have more than
one rank (``serving/engine.py``: the slot cache's slots split over
``data``, a prefill's row computed alike and kept by the slot's rank, a
decode step on each rank's slots with the logits gathered over the batch
axes) against the unsharded port engine and the JAX engine, on the CPU.

Six reduced float32 configs: StableLM-3B, Mixtral 8x7B (1 KV head: its
slot cache split along the sequence over ``model``; MoE routed over every
rank's rows), Jamba with its whole 8-layer period (Mamba, MoE, one
attention layer), DeepSeek-V2 (MLA: the latent cache split along the
sequence), SeamlessM4T (the encoder, and ``cross_len`` cut to each rank's
slots) and RWKV-6.  The weights are drawn by the port's ``Model`` and
bridged to JAX (JAX's own init compiles for seconds a config); the JAX
dense engine and the port's unsharded engine serve the trace here, in the
test process, and the weights, as numpy, go to spawned ``gloo`` ranks
on 2 x 1 and 2 x 2 (``data``, ``model``) meshes, where every rank builds
the engine with ``policy=make_policy(cfg, <decode shape>, mesh),
mesh=mesh`` and serves the same requests.  Held:

* every rank's tokens and every step's kind and counts are the unsharded
  port engine's, and the JAX engine's for the five configs the reference
  serves (SeamlessM4T aside: the reference cannot merge an enc-dec
  prefill, ROADMAP Queue C; Jamba and RWKV-6 with the float32 state plans
  ``tests/test_torch_dense_engine.py`` gives the JAX engine);
* each rank stores its planned share of the slot cache: every leaf's
  slots split over ``data``, its heads or sequence over ``model`` as the
  resolved spec says, ``1 / (2 x its model share)`` of the leaf's bytes.
"""
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import rwkv as jax_rwkv
from repro.models import ssm as jax_ssm
from repro.models.params import P as JaxP
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import InputShape
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced

ARCHS = ("stablelm_3b", "mixtral_8x7b", "jamba_v0_1_52b", "deepseek_v2_236b",
         "seamless_m4t_large_v2", "rwkv6_1_6b")
# the reference's dense engine cannot merge an enc-dec prefill
NOT_JAX = ("seamless_m4t_large_v2",)
MESHES = {"2x1": (2, 1), "2x2": (2, 2)}
ENGINE = dict(max_slots=4, seq_cap=96, page_size=8, seed=0)
# five requests behind four slots; three prompt lengths, so the JAX
# engine compiles three prefills
TRACE = [(40, 4), (7, 8), (40, 2), (7, 6), (21, 3)]


def _configs(arch):
    jcfg = reduced(get_config(arch)).replace(dtype="float32")
    tcfg = t_reduced(t_get_config(arch)).replace(dtype="float32")
    if arch == "jamba_v0_1_52b":       # the whole period: Mamba, MoE, attn
        period = get_config(arch).period
        jcfg, tcfg = jcfg.replace(period=period), tcfg.replace(period=period)
    return jcfg, tcfg


def _specs(cfg):
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, cfg.vocab_size, n), mn)
            for i, (n, mn) in enumerate(TRACE)]


def _drive(eng, requests):
    """Serve ``requests``: their tokens and each step's (kind, prefill
    tokens, decode tokens)."""
    for r in requests:
        assert eng.submit(r)
    counts = []
    while eng.has_work():
        rep = eng.step()
        eng.finalize_step(rep, float(len(counts)))
        counts.append((rep.kind, rep.prefill_tokens, rep.decode_tokens))
        assert len(counts) < 500, "engine did not converge"
    return [list(r.output_tokens) for r in requests], counts


def _requests(cls, specs):
    return [cls(req_id=i, tenant="T1", prompt_len=len(p), max_new_tokens=mn,
                arrival=0.0, prompt_tokens=np.array(p)) for i, p, mn in specs]


def _f32_state_plans(mp):
    """The JAX RWKV shift states and Mamba conv tail in the model dtype
    (``tests/test_torch_dense_engine.py``'s ``jax_rwkv_f32_shift`` and
    ``jax_mamba_f32_conv``)."""
    rwkv_plan, mamba_plan = jax_rwkv.rwkv_state_plan, jax_ssm.mamba_state_plan

    def f32(p, cfg):
        return JaxP(p.shape, dtype=cfg.dtype, init=p.init, pspec=p.pspec)

    mp.setattr(jax_rwkv, "rwkv_state_plan", lambda cfg, batch, policy: {
        k: f32(p, cfg) if k.startswith("shift") else p
        for k, p in rwkv_plan(cfg, batch, policy).items()})
    mp.setattr(jax_ssm, "mamba_state_plan", lambda cfg, batch, policy: {
        **mamba_plan(cfg, batch, policy),
        "conv": f32(mamba_plan(cfg, batch, policy)["conv"], cfg)})


def _weights(cfg, seed):
    """The port model's weights from ``seed`` as numpy (bf16 leaves as
    ml_dtypes' bfloat16, which both packages read)."""
    from repro_torch.models.model import Model
    from repro_torch.models.params import map_plan

    def host(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(jnp.bfloat16).copy()
        return t.numpy().copy()
    return map_plan(host, Model(cfg, seed=seed, device="cpu").params)


@pytest.fixture(scope="module")
def unsharded(tmp_path_factory):
    """The JAX engine's and the unsharded port engine's tokens and step
    counts, and the weights (numpy) the spawned ranks load."""
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    d = tmp_path_factory.mktemp("engine_meshes")
    weights, out = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        _f32_state_plans(mp)
        for i, arch in enumerate(ARCHS):
            jcfg, tcfg = _configs(arch)
            weights[arch] = _weights(tcfg, seed=i)
            specs = _specs(tcfg)
            port = ServingEngine(tcfg, params_from_numpy(
                weights[arch], device="cpu"), device="cpu", **ENGINE)
            out[arch] = {"specs": specs,
                         "port": _drive(port, _requests(Request, specs))}
            if arch not in NOT_JAX:
                eng = JaxEngine(jcfg, params=jax.tree.map(
                    jnp.asarray, weights[arch]), backend="dense", **ENGINE)
                out[arch]["jax"] = _drive(eng, _requests(JaxRequest, specs))
    torch.save({"weights": weights, "runs": out}, d / "weights.pt")
    return d, out


def _worker(rank, world, shape, store_path, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.launch.shardings import make_policy
    from repro_torch.models.bridge import params_from_numpy
    from repro_torch.models.params import map_plan
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.request import Request
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = make_device_mesh(shape, ("data", "model"), "cpu")
        saved = torch.load(os.path.join(out_dir, "..", "weights.pt"),
                           weights_only=False)
        res = {}
        for arch in ARCHS:
            _, cfg = _configs(arch)
            params = params_from_numpy(saved["weights"][arch], device="cpu")
            policy = make_policy(cfg, InputShape("serve", 96, 4, "decode"),
                                 mesh)
            eng = ServingEngine(cfg, params, device="cpu", policy=policy,
                                mesh=mesh, **ENGINE)
            stored = map_plan(lambda t: tuple(t.shape), eng.cache)
            specs = saved["runs"][arch]["specs"]
            tokens, counts = _drive(eng, _requests(Request, specs))
            res[arch] = {"tokens": tokens, "counts": counts,
                         "stored": stored}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(unsharded):
    base, _ = unsharded
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


CASES = [(mesh, arch) for mesh in MESHES for arch in ARCHS]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_tokens_and_step_counts_are_the_unsharded_engines(unsharded, runs,
                                                          mesh, arch):
    want = unsharded[1][arch]["port"]
    for r in runs[mesh]:
        assert (r[arch]["tokens"], r[arch]["counts"]) == want
    # the trace queues a request behind four slots and decodes batches
    assert [c[0] for c in want[1]].count("decode") > 1


@pytest.mark.parametrize("mesh,arch",
                         [c for c in CASES if c[1] not in NOT_JAX])
def test_tokens_and_step_counts_are_the_jax_engines(unsharded, runs, mesh,
                                                    arch):
    want = unsharded[1][arch]["jax"]
    for r in runs[mesh]:
        assert (r[arch]["tokens"], r[arch]["counts"]) == want


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("mesh,arch", CASES)
def test_each_rank_stores_its_share_of_the_slot_cache(runs, mesh, arch):
    """Every leaf's stored shape is its planned shape cut by its resolved
    spec: the slots over ``data`` (2 ranks), the heads or the sequence
    over ``model`` where the spec splits them."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.launch.shardings import axes_of, make_policy
    from repro_torch.models.model import cache_plan
    from repro_torch.models.params import pspecs_from_plan, torch_dtype
    _, cfg = _configs(arch)
    view = MeshShape(("data", "model"), MESHES[mesh])
    policy = make_policy(cfg, InputShape("serve", 96, 4, "decode"), view)
    enc = ENGINE["seq_cap"] if cfg.encoder is not None else 0
    plan = cache_plan(cfg, ENGINE["max_slots"], ENGINE["seq_cap"], enc,
                      policy=policy)
    specs = dict(_leaves(pspecs_from_plan(plan, view)))
    whole = stored = 0
    for path, leaf in _leaves(plan):
        spec = specs[path]
        slot_dim = 1 if path[0] == "period" else 0
        assert axes_of(spec[slot_dim]) == ("data",), (path, spec)
        want = list(leaf.shape)
        for dim, entry in enumerate(spec):
            for a in axes_of(entry):
                want[dim] //= view.shape[a]
        size = torch_dtype(leaf.dtype).itemsize
        whole += int(np.prod(leaf.shape)) * size
        stored += int(np.prod(want)) * size
        for r in runs[mesh]:
            got = dict(_leaves(r[arch]["stored"]))
            assert got[path] == tuple(want), path
    m = MESHES[mesh][1]
    assert whole / (2 * m) <= stored <= whole / 2
