"""Training in the port against the JAX package, on the CPU: the loss and
the gradient of every leaf of ``train_loss`` (reduced float32 configs,
bridged weights, batches of the copied pipeline) against
``jax.value_and_grad`` of the reference's; ``remat`` changes nothing;
``apply_updates`` on identical gradients and ``lr_at`` match the
reference's optimizer; five steps of ``make_train_step`` track JAX's; and
the port's twins of ``tests/test_training.py``.

Tolerances: the loss to 1e-5 relative; a leaf's gradient to 1e-4 times
max(1, its largest |value|) (f32 sums in another order); the optimizer to
1e-6 relative on identical gradients; five steps' losses to 1e-4
relative, looser because Adam's g / (|g| + eps) amplifies rounding in
near-zero gradients."""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import model as jax_model
from repro.models.common import NO_POLICY
from repro.training import optimizer as jax_opt
from repro.training.trainer import make_train_step as jax_make_train_step
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.launch import train as t_launch
from repro_torch.models import attention as t_attn
from repro_torch.models import model as t_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.params import map_plan, plan_leaves
from repro_torch.training import optimizer as t_opt
from repro_torch.training.data import SyntheticTokenPipeline
from repro_torch.training.trainer import (_unflatten, batch_to_torch,
                                          make_train_step, train, trainable)

# the head_dim-128 stacks (OLMo 2, Granite, StarCoder2) are the widths whose
# training backward the wgmma design of the flash backward serves on a card
ARCHS = ("stablelm_3b", "gemma2_27b", "mixtral_8x7b", "jamba_v0_1_52b",
         "rwkv6_1_6b", "deepseek_v2_236b", "phi_3_vision_4_2b",
         "seamless_m4t_large_v2", "olmo2_7b", "granite_3_8b",
         "starcoder2_7b")
WINDOW = 8          # Gemma 2's windows, cut so that 24-token batches see them


def _cut_windows(cfg):
    def cut(layer):
        return dataclasses.replace(layer, window=WINDOW) if layer.window \
            else layer
    return cfg.replace(prefix=tuple(cut(layer) for layer in cfg.prefix),
                       period=tuple(cut(layer) for layer in cfg.period))


def _unit_gain(plan, params, seed):
    """``params`` with every stacked leaf that has no ``fan_in`` redrawn
    at a std of 1/sqrt(its first unstacked dimension), as its unstacked
    twin draws (``tests/test_torch_frontends.py`` does the same).  The
    plans draw such leaves (``wq``, ``wk``, ``wv``, ``w_in`` of the period
    and the encoder) at 1/sqrt(repeats), 1 at the reduced depth, and the
    gradients of such a stack are so ill-conditioned that a 1e-7 relative
    change of the weights moves the embedding's by 18 times the tolerance
    below, in either package."""
    rng = np.random.default_rng(seed + 100)

    def leaf(path, p, a):
        if "period" in jax.tree_util.keystr(path) and p.fan_in is None \
                and p.init == "normal":
            return jnp.asarray(rng.standard_normal(a.shape).astype(
                np.float32) / np.sqrt(a.shape[1]))
        return a.astype(jnp.float32)
    return jax.tree_util.tree_map_with_path(
        leaf, plan, params, is_leaf=lambda x: hasattr(x, "pspec"))


def _setup(arch, seed=0, seq=24):
    """Reduced float32 configs, the JAX plan's weights drawn from ``seed``
    (``_unit_gain``) and held in float32 (the plans keep matrices in bf16,
    whose gradients would round at 4e-3), and the copied pipeline's first
    batch."""
    jcfg = _cut_windows(reduced(get_config(arch)).replace(dtype="float32"))
    tcfg = _cut_windows(t_reduced(t_get_config(arch)).replace(
        dtype="float32"))
    model = jax_model.Model(jcfg)
    jparams = _unit_gain(model.plan, model.init(jax.random.key(seed)), seed)
    np_params = jax.tree.map(np.asarray, jparams)
    pipe = SyntheticTokenPipeline(jcfg.vocab_size, 2, seq, seed=seed,
                                  frontend=t_launch.frontend_of(tcfg))
    return jcfg, tcfg, jparams, np_params, next(pipe)


def _jax_loss_and_grads(jcfg, jparams, batch, remat=True):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.train_loss(p, jcfg, b, NO_POLICY,
                                          remat=remat)))
    loss, grads = fn(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(tcfg, np_params, batch, remat=True):
    """(loss, raw gradients in ``plan_leaves`` order, None where autograd
    does not reach a leaf, gradient tree)."""
    params = trainable(params_from_numpy(np_params, device="cpu"), "cpu",
                       copy=False)
    loss = t_model.train_loss(params, tcfg, batch_to_torch(batch, "cpu"),
                              remat=remat)
    raw = torch.autograd.grad(loss, plan_leaves(params), allow_unused=True)
    return float(loss.detach()), raw, _unflatten(params, raw)


def _flat(tree):
    """path -> leaf of a nested dict."""
    if isinstance(tree, dict):
        return {f"{k}/{p}" if p else k: v for k in tree
                for p, v in _flat(tree[k]).items()}
    return {"": tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_jax(arch):
    jcfg, tcfg, jparams, np_params, batch = _setup(arch)
    jloss, jgrads = _jax_loss_and_grads(jcfg, jparams, batch)
    tloss, raw, tgrads = _port_loss_and_grads(tcfg, np_params, batch)
    assert np.isfinite(tloss)
    assert tloss == pytest.approx(jloss, rel=1e-5)
    # autograd reaches every leaf (none is unused)
    assert all(g is not None for g in raw)
    want, got = _flat(jgrads), _flat(tgrads)
    assert set(want) == set(got)
    for path, w in want.items():
        g = got[path].detach().numpy()
        assert g.shape == w.shape, path
        assert np.isfinite(g).all(), path
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=path)
        if np.abs(w).max() > 0:
            assert np.abs(g).max() > 0, path


@pytest.mark.parametrize("arch", ["stablelm_3b", "mixtral_8x7b",
                                  "rwkv6_1_6b", "seamless_m4t_large_v2"])
def test_remat_gives_the_same_gradients(arch):
    _, tcfg, _, np_params, batch = _setup(arch, seed=1)
    out = {}
    for remat in (True, False):
        loss, _, grads = _port_loss_and_grads(tcfg, np_params, batch,
                                              remat=remat)
        out[remat] = (loss, _flat(grads))
    assert out[True][0] == out[False][0]
    for path, g in out[True][1].items():
        np.testing.assert_allclose(g.numpy(), out[False][1][path].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=path)


def test_training_forward_builds_no_cache(monkeypatch):
    """``train_loss`` makes no K/V copy: ``build_gqa_cache`` and
    ``build_mla_cache`` never run."""
    def refuse(*a, **k):
        raise AssertionError("a training forward built a cache")
    monkeypatch.setattr(t_attn, "build_gqa_cache", refuse)
    monkeypatch.setattr(t_attn, "build_mla_cache", refuse)
    for arch in ("stablelm_3b", "deepseek_v2_236b"):
        _, tcfg, _, np_params, batch = _setup(arch)
        _port_loss_and_grads(tcfg, np_params, batch)


def test_moe_aux_loss_is_in_the_loss():
    """Mixtral's loss is the cross-entropy plus the summed load-balance
    loss of its MoE layers, as in the reference."""
    jcfg, tcfg, jparams, np_params, batch = _setup("mixtral_8x7b")
    params = params_from_numpy(np_params, device="cpu")
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        h = t_model.embed_tokens(params, tcfg, tb["tokens"])
        _, _, aux = t_model.forward_seq(
            params, tcfg, h, t_model._positions(h), seq_cap=h.shape[1],
            want_cache=False)
        loss = t_model.train_loss(params, tcfg, tb)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jh = jax_model.embed_tokens(jparams, jcfg, jb["tokens"], NO_POLICY)
    pos = jnp.broadcast_to(jnp.arange(jh.shape[1]), jh.shape[:2])
    _, _, jaux = jax_model.forward_seq(jparams, jcfg, jh, pos, NO_POLICY,
                                       want_cache=False,
                                       seq_cap=jh.shape[1])
    assert float(aux) > 0
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(loss) == pytest.approx(float(jax_model.train_loss(
        jparams, jcfg, jb, NO_POLICY)), rel=1e-5)


def _compare_states(jparams, jstate, tparams, tstate, p_tol, m_tol):
    for name, jt, tt, tol in (("params", jparams, tparams, p_tol),
                              ("mu", jstate.mu, tstate.mu, m_tol),
                              ("nu", jstate.nu, tstate.nu, m_tol)):
        want, got = _flat(jax.tree.map(np.asarray, jt)), _flat(tt)
        assert set(want) == set(got), name
        for path, w in want.items():
            g = got[path]
            assert str(g.dtype).endswith(str(w.dtype)), (name, path)
            w = w.astype(np.float32)
            # an entry near 0 is a difference of larger numbers: held to
            # the tolerance of the leaf's scale
            np.testing.assert_allclose(
                g.float().numpy(), w, rtol=tol,
                atol=tol * float(np.abs(w).max()), err_msg=f"{name} {path}")


@pytest.mark.parametrize("dtype,p_tol", [("float32", 1e-6),
                                         ("bfloat16", 2.0 ** -7)])
def test_apply_updates_matches_jax_on_identical_gradients(dtype, p_tol):
    """Two AdamW steps from the same weights and the same numpy gradients:
    params, mu and nu as the reference's (f32 weights, or the plan's bf16
    matrices, which may round one bf16 step apart).  The first step's
    gradients are inside the clip norm; the second's are clipped, and the
    clip factor carries the relative difference of the two f32 global
    norms (a sum of ~1e6 squares in another order, ~1.3e-6), which mu and
    nu (as g and g^2) then show, so they are held to 1e-5 after it; the
    parameters, whose update m / sqrt(v) cancels the factor, stay at
    1e-6."""
    jcfg = reduced(get_config("stablelm_3b"))
    jparams = jax_model.Model(jcfg).init(jax.random.key(3))
    if dtype == "float32":
        jparams = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(4)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    jstate = jax_opt.init_state(jparams)
    tparams = params_from_numpy(np_params, device="cpu")
    tstate = t_opt.init_state(tparams)
    for i, scale in enumerate((1e-4, 1.0)):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                         .astype(np.float32).astype(a.dtype), np_params)
        jparams, jstate, jdiag = jax_opt.apply_updates(
            jax_opt.AdamWConfig(**ocfg), jparams,
            jax.tree.map(jnp.asarray, g), jstate)
        tparams, tstate, tdiag = t_opt.apply_updates(
            t_opt.AdamWConfig(**ocfg), tparams,
            params_from_numpy(g, device="cpu"), tstate)
        clipped = float(jdiag["grad_norm"]) > 1.0
        assert clipped == (i == 1)
        assert float(tdiag["grad_norm"]) == pytest.approx(
            float(jdiag["grad_norm"]), rel=1e-5)
        assert tdiag["lr"] == pytest.approx(float(jdiag["lr"]), rel=1e-6)
        _compare_states(jparams, jstate, tparams, tstate, p_tol,
                        1e-5 if clipped else 1e-6)
    assert tstate.step == int(jstate.step) == 2


def test_lr_at_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 10, 55, 100, 130):
        want = float(jax_opt.lr_at(jax_opt.AdamWConfig(**cfg),
                                   jnp.asarray(step)))
        assert t_opt.lr_at(t_opt.AdamWConfig(**cfg), step) == \
            pytest.approx(want, rel=1e-6, abs=1e-12), step


def test_state_plan_mirrors_the_param_plan():
    plan = t_model.model_plan(t_reduced(t_get_config("stablelm_3b")))
    st = t_opt.state_plan(plan)
    assert st.step.shape == () and st.step.dtype == "int32"
    for p, m, v in zip(plan_leaves(plan), plan_leaves(st.mu),
                       plan_leaves(st.nu)):
        assert m.shape == v.shape == p.shape
        assert m.dtype == v.dtype == "float32"


@pytest.mark.parametrize("arch", ["stablelm_3b", "mixtral_8x7b",
                                  "jamba_v0_1_52b", "rwkv6_1_6b"])
def test_train_steps_track_jax(arch):
    """Five steps of ``make_train_step`` (for Jamba and RWKV-6 through the
    scans' Functions and their formula backward, as ``launch.train``'s
    ``train_small`` twin runs them) track JAX's from bridged weights."""
    jcfg, tcfg, jparams, np_params, batch = _setup(arch, seed=2)
    jo = jax_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    to = t_opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=5)
    jstep = jax.jit(jax_make_train_step(jcfg, jo))
    tstep = make_train_step(tcfg, to)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = batch_to_torch(batch, "cpu")
    jstate = jax_opt.init_state(jparams)
    tparams = trainable(params_from_numpy(np_params, device="cpu"), "cpu")
    tstate = t_opt.init_state(tparams)
    jl, tl = [], []
    for _ in range(5):
        jparams, jstate, jaux = jstep(jparams, jstate, jb)
        tparams, tstate, taux = tstep(tparams, tstate, tb)
        jl.append(float(jaux["loss"]))
        tl.append(float(taux["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_trainer_leaves_the_serving_model_frozen_and_its_input_unchanged():
    _, tcfg, _, np_params, batch = _setup("stablelm_3b")
    model = t_model.Model(tcfg, params_from_numpy(np_params, device="cpu"),
                          device="cpu")
    before = map_plan(lambda t: t.detach().clone(), model.params)
    res = train(tcfg, itertools.repeat(batch), 2, device="cpu",
                params=model.params)
    assert all(not p.requires_grad for p in plan_leaves(model.params))
    for a, b in zip(plan_leaves(before), plan_leaves(model.params)):
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in plan_leaves(res.final_params))
    assert any(not torch.equal(a, b) for a, b in zip(
        plan_leaves(before), plan_leaves(res.final_params)))


def test_full_width_run_at_reduced_width_on_cpu():
    """``launch.train``'s full-width run, given a reduced config: the
    loss falls on the memorised batch and every leaf gets a finite
    nonzero gradient."""
    cfg = t_reduced(t_get_config("stablelm_3b"))
    res = t_launch.train_full_width(cfg=cfg, steps=4, batch=2, seq=32,
                                    device="cpu", log=lambda *_: None)
    assert res["bad_grad_leaves"] == []
    assert res["losses"][-1] < res["losses"][0]
    assert len(res["step_ms"]) == 4 and res["tokens_per_s"] > 0


def test_launch_train_cli(tmp_path, capsys):
    path = str(tmp_path / "ck.zst")
    res = t_launch.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--checkpoint", path])
    out = capsys.readouterr().out
    assert "final loss" in out and "checkpoint written" in out
    assert len(res.losses) == 3
    # --full runs the plan-level dry run of the full config's train_4k step
    res = t_launch.main(["--full"])
    assert (res["arch"], res["shape"], res["num_chips"]) == (
        "stablelm_3b", "train_4k", 256)
    assert "H100 analytic est" in capsys.readouterr().out


def test_period_layers_cut_keeps_widths_and_loss_check_exits():
    """``with_period_layers`` keeps the first layers of the period at the
    published widths (Jamba: Mamba + dense FFN, Mamba + MoE), and
    ``--expect-loss-drop`` exits non-zero when the last loss is not below
    the first (one step: the two are the same)."""
    full = t_get_config("jamba_v0_1_52b")
    cut = t_launch.with_period_layers(full, 2)
    assert [(ls.mixer, ls.ffn) for ls in cut.layer_specs()] == [
        ("mamba", "dense"), ("mamba", "moe")]
    assert (cut.d_model, cut.moe, cut.mamba) == (full.d_model, full.moe,
                                                 full.mamba)
    for bad in (0, len(full.period) + 1):
        with pytest.raises(ValueError, match="cannot keep"):
            t_launch.with_period_layers(full, bad)
    with pytest.raises(SystemExit, match="failed to reduce loss"):
        t_launch.main(["--device", "cpu", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--expect-loss-drop"])


# ---- twins of tests/test_training.py ---------------------------------------

def test_loss_decreases_dense():
    cfg = t_reduced(t_get_config("stablelm_3b"))
    pipe = SyntheticTokenPipeline(cfg.vocab_size, batch=4, seq_len=32, seed=0)
    res = train(cfg, iter(pipe), steps=12, device="cpu")
    assert res.losses[-1] < res.losses[0]


def test_loss_decreases_moe():
    """Memorise one fixed batch: loss must drop through the MoE router."""
    cfg = t_reduced(t_get_config("mixtral_8x7b"))
    pipe = SyntheticTokenPipeline(cfg.vocab_size, batch=4, seq_len=32, seed=0)
    batch = next(iter(pipe))
    res = train(cfg, itertools.repeat(batch), steps=15,
                ocfg=t_opt.AdamWConfig(lr=1e-3, warmup_steps=3,
                                       total_steps=15), device="cpu")
    assert res.losses[-1] < res.losses[0] - 0.2, res.losses


def test_lr_schedule_warmup_and_cosine():
    cfg = t_opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    assert t_opt.lr_at(cfg, 0) == pytest.approx(0.0)
    assert t_opt.lr_at(cfg, 10) == pytest.approx(1e-3, rel=1e-3)
    assert t_opt.lr_at(cfg, 100) == pytest.approx(1e-4, rel=1e-2)


def test_pipeline_shapes_multimodal():
    cfg = t_reduced(t_get_config("phi_3_vision_4_2b"))
    pipe = SyntheticTokenPipeline(
        cfg.vocab_size, batch=2, seq_len=32, seed=0,
        frontend=t_launch.frontend_of(cfg))
    b = next(iter(pipe))
    p = cfg.frontend.num_prefix
    assert b["embeds"].shape == (2, p, cfg.frontend.embed_dim)
    assert b["tokens"].shape == (2, 32 - p)


def test_pipeline_throttle_accounts_sleeps():
    pipe = SyntheticTokenPipeline(1024, batch=8, seq_len=512, seed=0,
                                  bytes_per_s_cap=1e6)
    it = iter(pipe)
    for _ in range(3):
        next(it)
    assert pipe.stats.throttle_sleeps > 0      # cap is binding
    pipe.set_throttle(None)                    # controller releases it
    assert pipe.bytes_per_s_cap is None
