"""The port's sharding plans against the JAX package's: every plan leaf's
spec, ``resolve_pspec``, ``make_policy`` and the cache plans under each
decode shape's policy, for the ten ``ARCH_IDS`` and OLMo 2, on the mesh
shapes of ``tests/test_sharding.py`` (``FakeMesh``), plus twins of that
file's resolve and policy tests."""
import dataclasses

import jax
import pytest

from repro.configs.base import INPUT_SHAPES, get_config
from repro.launch.shardings import make_policy as jax_make_policy
from repro.models import model as jax_model
from repro.models.params import resolve_pspec as jax_resolve
from repro.training import optimizer as jax_opt
from repro_torch.configs.base import ARCH_IDS
from repro_torch.configs.base import INPUT_SHAPES as T_SHAPES
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.launch.mesh import MeshShape, make_production_mesh, mesh_view
from repro_torch.launch.shardings import make_policy
from repro_torch.models import model as t_model
from repro_torch.models.params import P, resolve_pspec
from repro_torch.training import optimizer as t_opt

ARCHS = tuple(ARCH_IDS) + ("olmo2_7b",)


class FakeMesh:
    """Duck-typed mesh, as tests/test_sharding.py's."""
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
    "4x2": {"data": 4, "model": 2},
    "2x2": {"data": 2, "model": 2},
}


def _flat(plan):
    """(path, shape, dtype, init, fan_in, pspec, alt) of every leaf."""
    return [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype, l.init,
             l.fan_in, tuple(l.pspec),
             None if l.alt is None else tuple(l.alt))
            for p, l in jax.tree_util.tree_flatten_with_path(
                plan, is_leaf=lambda x: hasattr(x, "shape"))[0]]


def _leaves(plan):
    return [l for _, l in jax.tree_util.tree_flatten_with_path(
        plan, is_leaf=lambda x: hasattr(x, "shape"))[0]]


def _decode_shapes():
    return [s for s in INPUT_SHAPES.values() if s.mode == "decode"]


def _plans(arch, mesh):
    """(reference plans, port plans): model, optimizer state and the cache
    under each decode shape's policy."""
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    jp, tp = jax_model.model_plan(jcfg), t_model.model_plan(tcfg)
    jout, tout = [jp, jax_opt.state_plan(jp)], [tp, t_opt.state_plan(tp)]
    for shape in _decode_shapes():
        enc = shape.seq_len if jcfg.encoder is not None else 0
        jout.append(jax_model.cache_plan(
            jcfg, shape.global_batch, shape.seq_len,
            jax_make_policy(jcfg, shape, mesh), enc_len=enc))
        tout.append(t_model.cache_plan(
            tcfg, shape.global_batch, shape.seq_len, enc,
            policy=make_policy(tcfg, T_SHAPES[shape.name], mesh)))
    return jout, tout


@pytest.mark.parametrize("arch", ARCHS)
def test_plans_match_the_reference_leaf_for_leaf(arch):
    jplans, tplans = _plans(arch, FakeMesh(MESHES["16x16"]))
    for jplan, tplan in zip(jplans, tplans):
        assert _flat(tplan) == _flat(jplan)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_pspec_matches_the_reference(arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    jplans, tplans = _plans(arch, fake)
    n = 0
    for jplan, tplan in zip(jplans, tplans):
        for jl, tl in zip(_leaves(jplan), _leaves(tplan)):
            assert resolve_pspec(fake, tl) == tuple(jax_resolve(fake, jl))
            n += 1
    assert n > 10


def _policy_fields(pol):
    return {f.name: getattr(pol, f.name) for f in dataclasses.fields(pol)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_make_policy_matches_the_reference(arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        for seq_parallel in (False, True):
            assert _policy_fields(make_policy(tcfg, T_SHAPES[name], fake,
                                              seq_parallel)) == \
                _policy_fields(jax_make_policy(jcfg, shape, fake,
                                               seq_parallel))


def test_mesh_view_gives_one_view_of_both_kinds():
    prod = make_production_mesh(multi_pod=True)
    assert prod.shape == MESHES["2x16x16"]
    assert prod.axis_names == ("pod", "data", "model")
    assert mesh_view(prod) is prod
    fake = FakeMesh(MESHES["4x2"])
    assert mesh_view(fake) is fake

    class Live:                      # DeviceMesh's two attributes
        mesh_dim_names = ("data", "model")
        shape = (4, 2)
    assert mesh_view(Live()) == MeshShape(("data", "model"), (4, 2))
    assert mesh_view(Live()).shape == fake.shape


# ---- twins of tests/test_sharding.py's resolve and policy tests

def test_resolve_drops_nondivisible_axes():
    mesh = FakeMesh({"data": 16, "model": 16})
    # 36 heads on a 16-way axis: dropped
    p = P((4608, 36, 128), pspec=("data", "model", None))
    assert resolve_pspec(mesh, p) == ("data", None, None)
    # 49155 vocab likewise
    p = P((49155, 4096), pspec=("model", "data"))
    assert resolve_pspec(mesh, p) == (None, "data")


def test_resolve_uses_alt_when_primary_underutilises():
    mesh = FakeMesh({"data": 16, "model": 16})
    # Mixtral: 8 experts < 16-way model axis -> tensor-parallel-in-expert
    p = P((8, 4096, 2, 14336), pspec=("model", "data", None, None),
          alt=(None, "data", None, "model"))
    assert resolve_pspec(mesh, p) == (None, "data", None, "model")
    # DeepSeek: 160 experts divide 16 -> expert parallel kept
    p = P((160, 5120, 2, 1536), pspec=("model", "data", None, None),
          alt=(None, "data", None, "model"))
    assert resolve_pspec(mesh, p) == ("model", "data", None, None)


def test_resolve_drops_axes_missing_from_mesh():
    mesh = FakeMesh({"data": 4, "model": 2})
    p = P((64, 64), pspec=(("pod", "data"), "model"))
    assert resolve_pspec(mesh, p) == (("data",), "model")


def test_policy_long_context_shards_cache_sequence():
    mesh = MeshShape(("data", "model"), (16, 16))
    pol = make_policy(t_get_config("deepseek_v2_236b"),
                      T_SHAPES["long_500k"], mesh)
    assert pol.mla_cache[1] == ("data", "model")   # seq over both axes
    pol2 = make_policy(t_get_config("gemma2_27b"),   # kv=16 divides 16
                       T_SHAPES["long_500k"], mesh)
    assert pol2.kv_cache == (None, "data", "model", None)


class _LiveAt:
    """A live mesh's coordinate view: ``DeviceMesh``'s names, shape and
    ``get_coordinate``, without ranks."""
    def __init__(self, names, shape, coord):
        self.mesh_dim_names, self.shape = names, shape
        self._coord = list(coord)

    def get_coordinate(self):
        return self._coord


def test_local_shard_takes_the_reference_layouts_block():
    """A dim over ("pod", "data") is split major axis first, as JAX lays a
    PartitionSpec tuple entry out: (p, d) holds block p * |data| + d, the
    blocks tile the dim in order, and ``model`` replicates it."""
    import itertools
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.shardings import local_shard, placements
    names, shape = ("pod", "data", "model"), (2, 3, 2)
    full = torch.arange(12 * 5).reshape(12, 5)
    spec = (("pod", "data"), None)
    blocks = {}
    for p, d, m in itertools.product(*(range(n) for n in shape)):
        got = local_shard(full, spec, _LiveAt(names, shape, (p, d, m)))
        assert torch.equal(got, full[(p * 3 + d) * 2:(p * 3 + d + 1) * 2])
        blocks[(p, d)] = got
    assert torch.equal(torch.cat([blocks[k] for k in sorted(blocks)]), full)
    assert placements(spec, MeshShape(names, shape)) == [
        Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"), None), MeshShape(names, shape))
