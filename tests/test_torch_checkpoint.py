"""The port's checkpoints are the reference's container: a JAX-saved
checkpoint (reduced RWKV-6, bf16 and f32 leaves) loads into the port bit
for bit, a port-saved one loads through ``repro.training.checkpoint.load``
bit for bit, and the port's own round trip keeps dtypes, values, an
optimizer state and the zlib fallback (``zstandard`` may be missing)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models.model import Model as JaxModel
from repro.training import checkpoint as jax_ckpt
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.models.params import plan_leaves
from repro_torch.training import checkpoint as t_ckpt
from repro_torch.training import optimizer as t_opt


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as an integer array (bf16 through uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy().view(np.uint32 if x.element_size() == 4 else
                              np.uint8)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint8)


def _jax_rwkv(seed=0):
    cfg = reduced(get_config("rwkv6_1_6b"))
    return JaxModel(cfg).init(jax.random.key(seed))


def test_jax_checkpoint_loads_into_the_port_bit_for_bit(tmp_path):
    jparams = _jax_rwkv()
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save(path, jparams, {"step": 7, "arch": "rwkv6_1_6b"})
    like = Model(t_reduced(t_get_config("rwkv6_1_6b")), seed=1,
                 device="cpu").params
    got, meta = t_ckpt.load(path, like=like)
    assert meta == {"step": 7, "arch": "rwkv6_1_6b"}
    want = jax.tree.map(np.asarray, jparams)
    dtypes = set()
    for w, g in zip(jax.tree.leaves(want), plan_leaves(got)):
        assert g.dtype == torch.bfloat16 or g.dtype == torch.float32
        dtypes.add(g.dtype)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert dtypes == {torch.bfloat16, torch.float32}
    flat, _ = t_ckpt.load(path)                   # without ``like``: flat
    assert flat["period/sub0/rwkv/wr"].dtype == torch.bfloat16


def test_port_checkpoint_loads_into_jax_bit_for_bit(tmp_path):
    jparams = _jax_rwkv(seed=2)
    tparams = params_from_numpy(jax.tree.map(np.asarray, _jax_rwkv(seed=3)),
                                device="cpu")
    path = str(tmp_path / "port.ckpt")
    n = t_ckpt.save(path, tparams, {"steps": 3})
    assert n == len(open(path, "rb").read())
    got, meta = jax_ckpt.load(path, like=jparams)
    assert meta == {"steps": 3}
    for w, g in zip(plan_leaves(tparams), jax.tree.leaves(got)):
        assert str(g.dtype) == str(w.dtype).replace("torch.", "")
        np.testing.assert_array_equal(_bits(np.asarray(g)), _bits(w))


def test_optimizer_state_round_trips_with_jax_paths(tmp_path):
    """An AdamW state (a named tuple) is written under the paths
    ``jax.tree_util`` gives it (``.step``, ``.mu/...``) and comes back."""
    params = Model(t_reduced(t_get_config("stablelm_3b")), seed=0,
                   device="cpu").params
    state = t_opt.init_state(params)
    state = state._replace(step=5, mu={k: v + 1 if isinstance(
        v, torch.Tensor) else v for k, v in state.mu.items()})
    path = str(tmp_path / "state.ckpt")
    t_ckpt.save(path, {"params": params, "opt": state})
    flat, _ = t_ckpt.load(path)
    assert "opt/.step" in flat and "opt/.mu/embed" in flat
    assert flat["opt/.step"].dtype == torch.int32
    back, _ = t_ckpt.load(path, like={"params": params, "opt": state})
    assert isinstance(back["opt"], t_opt.AdamWState)
    assert back["opt"].step == 5
    for a, b in zip(plan_leaves(state.mu), plan_leaves(back["opt"].mu)):
        assert torch.equal(a, b)


def test_zlib_fallback_is_read_by_both(tmp_path, monkeypatch):
    monkeypatch.setattr(t_ckpt, "zstandard", None)
    tparams = params_from_numpy(jax.tree.map(np.asarray, _jax_rwkv(seed=4)),
                                device="cpu")
    path = str(tmp_path / "zlib.ckpt")
    t_ckpt.save(path, tparams)
    assert open(path, "rb").read(4) != b"\x28\xb5\x2f\xfd"
    back, _ = t_ckpt.load(path, like=tparams)
    for a, b in zip(plan_leaves(tparams), plan_leaves(back)):
        assert torch.equal(a, b)
    got, _ = jax_ckpt.load(path, like=_jax_rwkv(seed=4))
    for a, b in zip(plan_leaves(tparams), jax.tree.leaves(got)):
        np.testing.assert_array_equal(_bits(np.asarray(b)), _bits(a))


def test_load_refuses_a_tree_of_other_keys(tmp_path):
    params = Model(t_reduced(t_get_config("stablelm_3b")), seed=0,
                   device="cpu").params
    path = str(tmp_path / "ck.zst")
    t_ckpt.save(path, params)
    with pytest.raises(KeyError, match="mismatch"):
        t_ckpt.load(path, like={"embed": params["embed"]})


def test_checkpoint_roundtrip_preserves_dtypes(tmp_path):
    """Twin of tests/test_training.py's round trip."""
    cfg = t_reduced(t_get_config("rwkv6_1_6b"))
    params = Model(cfg, seed=0, device="cpu").params
    path = str(tmp_path / "ck.zst")
    t_ckpt.save(path, params, {"step": 5})
    restored, meta = t_ckpt.load(path, like=params)
    assert meta["step"] == 5
    for a, b in zip(plan_leaves(params), plan_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
