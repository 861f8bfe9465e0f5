"""The port's launch layer against the JAX package's: batch and decode
argument plans, the dry run's analytic memory (number for number) and
analytic FLOPs and bytes (their times on the H100's rates), the meta
arguments of ``build_step`` against the reference's, the dry run of every
config, and twins of ``tests/test_launch.py``'s batch-plan, chip-scaling
and window-clipping tests."""
import os

import jax
import pytest

from repro.configs.base import INPUT_SHAPES, InputShape, get_config, reduced
from repro.launch.shardings import make_policy as jax_policy
from repro.launch.specs import batch_plan as jax_batch_plan
from repro.launch.specs import decode_arg_plans as jax_decode_arg_plans
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.configs.base import InputShape as TInputShape
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.launch import dryrun as t_dryrun
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.shardings import make_policy
from repro_torch.launch.specs import batch_plan, decode_arg_plans
from repro_torch.launch.steps import build_step

ARCHS = tuple(ARCH_IDS) + ("olmo2_7b",)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "2x2": {"data": 2, "model": 2},
}
MESH = FakeMesh(MESHES["16x16"])
MESH_MP = FakeMesh(MESHES["2x16x16"])


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``.  Importing it sets a 512-device XLA flag
    for backends started later; the backend is started first and the flag
    put back, so the rest of this process keeps one CPU device."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


def _flat(plan):
    return [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype, l.init,
             l.fan_in, tuple(l.pspec),
             None if l.alt is None else tuple(l.alt))
            for p, l in jax.tree_util.tree_flatten_with_path(
                plan, is_leaf=lambda x: hasattr(x, "shape"))[0]]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_plans_match_the_reference(arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        assert _flat(batch_plan(tcfg, T_SHAPES[name], fake)) == \
            _flat(jax_batch_plan(jcfg, shape, fake))
        if shape.mode == "decode":
            assert _flat(decode_arg_plans(tcfg, T_SHAPES[name], fake)) == \
                _flat(jax_decode_arg_plans(jcfg, shape, fake))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_memory_matches_the_reference(ref_dryrun, arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for seq_parallel in (False, True):
            got = t_dryrun.analytic_memory(
                tcfg, T_SHAPES[name], fake,
                policy=make_policy(tcfg, T_SHAPES[name], fake, seq_parallel))
            want = ref_dryrun.analytic_memory(
                jcfg, shape, fake,
                policy=jax_policy(jcfg, shape, fake, seq_parallel))
            assert got == want, (name, seq_parallel)


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_terms_match_the_reference_on_h100_rates(ref_dryrun, arch):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for chips in (256, 512):
            for q_chunk in (512, 32768):
                got = t_dryrun.analytic_terms(tcfg, T_SHAPES[name], chips,
                                              q_chunk)
                want = ref_dryrun.analytic_terms(jcfg, shape, chips, q_chunk)
                assert got["flops_analytic"] == want["flops_analytic"]
                assert got["hbm_bytes_analytic"] == want["hbm_bytes_analytic"]
                assert got["t_compute_analytic"] == pytest.approx(
                    got["flops_analytic"] / (chips * 989e12), rel=1e-12)
                assert got["t_memory_analytic"] == pytest.approx(
                    got["hbm_bytes_analytic"] / (chips * 3.35e12), rel=1e-12)


def test_roofline_terms_take_the_h100_rates():
    t = t_dryrun.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12},
                                450e9, 1)
    assert t["t_compute"] == t["t_memory"] == t["t_collective"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_runs_every_shape_on_both_meshes(ref_dryrun, arch):
    jcfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for multi_pod, fake in ((False, MESH), (True, MESH_MP)):
            res = t_dryrun.dryrun(arch, name, multi_pod=multi_pod,
                                  verbose=False)
            if name == "long_500k" and not jcfg.supports_long_context:
                assert res is None
                continue
            assert res["num_chips"] == (512 if multi_pod else 256)
            assert res["arg_leaves"] > 0
            assert res["analytic_memory"] == ref_dryrun.analytic_memory(
                jcfg, shape, fake)


def _args_flat(tree):
    def dt(x):
        return str(x.dtype).replace("torch.", "")
    return [(jax.tree_util.keystr(p), tuple(x.shape), dt(x))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_build_step_args_match_the_reference(arch, mode):
    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import build_step as jax_build_step
    jcfg, tcfg = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    jshape = InputShape(mode, 64, 2, mode)
    tshape = TInputShape(mode, 64, 2, mode)
    _, jargs, *_ = jax_build_step(jcfg, jshape, make_local_mesh())
    fn, targs, in_pl, out_pl, donate = build_step(
        tcfg, tshape, MeshShape(("data", "model"), (1, 1)))
    assert _args_flat(targs) == _args_flat(jargs)
    assert all(x.device.type == "meta" for x in jax.tree.leaves(targs))
    assert donate == {"train": (0, 1), "prefill": (), "decode": (1,)}[mode]
    with pytest.raises(TypeError, match="live DeviceMesh"):
        fn(*targs)


def test_train_full_runs_the_dry_run(capsys):
    from repro_torch.launch.train import main
    res = main(["--full", "--arch", "stablelm_3b"])
    assert (res["shape"], res["mode"], res["num_chips"]) == (
        "train_4k", "train", 256)
    assert "H100 analytic est" in capsys.readouterr().out


# ---- twins of tests/test_launch.py's batch-plan, chip-scaling and
# window-clipping tests

def test_batch_plan_shapes_dense_train():
    plan = batch_plan(t_get_config("granite_3_8b"), T_SHAPES["train_4k"],
                      MESH)
    assert plan["tokens"].shape == (256, 4096)
    assert plan["labels"].shape == (256, 4096)
    assert plan["tokens"].pspec[0] == "data"


def test_batch_plan_vlm_subtracts_patches():
    plan = batch_plan(t_get_config("phi_3_vision_4_2b"),
                      T_SHAPES["train_4k"], MESH)
    assert plan["embeds"].shape == (256, 576, 1024)
    assert plan["tokens"].shape == (256, 4096 - 576)   # total positions 4096


def test_batch_plan_encdec_frames():
    plan = batch_plan(t_get_config("seamless_m4t_large_v2"),
                      T_SHAPES["prefill_32k"], MESH)
    assert plan["frames"].shape == (32, 32768, 1024)
    assert plan["tokens"].shape[1] <= 128               # decoder prompt


def test_decode_arg_plans_cache_capacity():
    from repro_torch.models.params import plan_leaves
    cplan, tok, pos = decode_arg_plans(t_get_config("mixtral_8x7b"),
                                       T_SHAPES["long_500k"], MESH)
    kv_leaves = [p for p in plan_leaves(cplan) if len(p.shape) == 5]
    # window cache capacity == 4096, not 524288
    assert kv_leaves and all(p.shape[2] == 4096 for p in kv_leaves)
    assert tok.shape == (1,)


def test_multipod_policy_batch_axes():
    pol = make_policy(t_get_config("granite_3_8b"), T_SHAPES["train_4k"],
                      MESH_MP)
    assert pol.act[0] == ("pod", "data")


def test_analytic_terms_scale_with_chips():
    cfg = t_get_config("stablelm_3b")
    t256 = t_dryrun.analytic_terms(cfg, T_SHAPES["train_4k"], 256)
    t512 = t_dryrun.analytic_terms(cfg, T_SHAPES["train_4k"], 512)
    assert t256["flops_analytic"] == t512["flops_analytic"]
    assert t256["t_compute_analytic"] == pytest.approx(
        2 * t512["t_compute_analytic"])


def test_window_clipping_reduces_analytic_compute():
    cfg = t_get_config("mixtral_8x7b")
    clipped = t_dryrun.analytic_terms(cfg, T_SHAPES["prefill_32k"], 256,
                                      q_chunk=512)
    unclipped = t_dryrun.analytic_terms(cfg, T_SHAPES["prefill_32k"], 256,
                                        q_chunk=32768)
    assert clipped["flops_analytic"] < 0.9 * unclipped["flops_analytic"]


# ---- the dry run's collective term (launch/dryrun.py::collective_bytes)

@pytest.mark.parametrize("arch", ARCHS)
def test_collective_bytes_are_finite_on_the_production_meshes(arch):
    import math
    for name in T_SHAPES:
        for multi_pod in (False, True):
            res = t_dryrun.dryrun(arch, name, multi_pod=multi_pod,
                                  verbose=False)
            if res is None:
                continue
            comm = res["collective_bytes_per_device"]
            assert set(comm) == {"all_gather", "reduce_scatter",
                                 "all_reduce"}
            assert all(isinstance(v, int) and v >= 0 for v in comm.values())
            assert sum(comm.values()) > 0
            assert res["collective_bytes_analytic"] == \
                sum(comm.values()) * res["num_chips"]
            assert math.isfinite(res["t_collective_analytic"])


@pytest.mark.parametrize("arch", ARCHS)
def test_collective_bytes_are_zero_on_one_rank(arch):
    one = MeshShape(("data", "model"), (1, 1))
    cfg = t_reduced(t_get_config(arch))
    for mode in ("train", "prefill", "decode"):
        got = t_dryrun.collective_bytes(cfg, TInputShape(mode, 64, 2, mode),
                                        one)
        assert got == {"all_gather": 0, "reduce_scatter": 0,
                       "all_reduce": 0}


def test_collective_bytes_hand_count_reduced_stablelm_2x2():
    """Reduced StableLM (bf16 leaves, d 256, vocab 1024, 4 heads of 64, 4
    KV heads, d_ff 512, one layer), train, batch 4 x 16, remat, on 2 x 2
    (data, model): 2 rows a rank.  Every group has 2 ranks, so an
    all-gather passes its input once, a reduce-scatter its output once
    and an all-reduce its bytes once."""
    # parameters gathered over `data` (the local shards' bytes): the
    # embedding and the head 512 x 128 x 2 each, once; the layer's wq,
    # wk, wv, wo 128 x 2 x 64 x 2 each, w_in 128 x 2 x 256 x 2, w_out
    # 256 x 128 x 2, twice (the forward and remat's recompute); the
    # backward reduce-scatters each gradient once
    embed = head = 512 * 128 * 2
    layer = 4 * (128 * 2 * 64 * 2) + 128 * 2 * 256 * 2 + 256 * 128 * 2
    want_ag = embed + head + 2 * layer
    want_rs = embed + head + layer
    # all-reduces over `model` of [2, 16, 256] bf16 (8192 B x 2): the
    # embedding's rows (forward), attention's and the FFN's f (backward)
    # and g (forward and recompute), the head's f (backward); the loss's
    # three [2, 16] f32 sums; over `data` the gradients of norm1, norm2
    # and final_norm (256 f32 each), the loss (4 B: 2 x ceil(1/2) x 4)
    # and over both axes the clip's norm
    act = 2 * 16 * 256 * 2
    want_ar = (act + 2 * (act + 2 * act) + act + 3 * 2 * 16 * 4
               + 3 * 256 * 4 + 8 + 2 * 8)
    got = t_dryrun.collective_bytes(
        t_reduced(t_get_config("stablelm_3b")),
        TInputShape("t", 16, 4, "train"),
        MeshShape(("data", "model"), (2, 2)))
    assert got == {"all_gather": want_ag, "reduce_scatter": want_rs,
                   "all_reduce": want_ar}
