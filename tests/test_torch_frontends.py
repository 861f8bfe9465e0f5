"""The VLM frontend (Phi-3-vision) and the encoder-decoder (SeamlessM4T) in
the port against the JAX package, on the same numpy inputs and bridged
weights (the stacked leaves that the plans draw unscaled redrawn at unit
gain, see ``_unit_gain``), in float32 at the reduced widths:

* the full-width model and cache plans equal the JAX plans leaf for leaf
  (the cross-attention leaves with ``enc_len`` > 0);
* ``_merge_frontend``, ``encode``, ``cross_attn_kv`` and ``cross_attn``
  equal JAX's to 1e-5 scaled on seeded random embeds, frames and memory,
  and decode's masked cross-attention over a padded cache equals the
  reference's unmasked one over the valid frames;
* ``prefill`` and 8 ``decode_step``s give JAX's tokens and logits when
  both are called at the right positions (after the image prefix; from
  the decoder's own tokens, not the frames);
* the port's dense engine is token-identical to a loop over JAX's
  ``prefill`` / ``decode_step`` at those positions, fed the reference
  engine's zero stubs.

Two faults of the reference's dense engine are pinned here (ROADMAP Queue
C) and repaired in the port's: it decodes a VLM request at ``prompt_len``,
inside the image prefix, and it cannot merge an enc-dec prefill's cache
into its slot cache."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, reduced
from repro.models import attention as jax_attn
from repro.models import model as jax_model
from repro.models.common import NO_POLICY
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as t_attn
from repro_torch.models import model as t_model
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import EXCEEDS_SEQ_CAP, Request

VLM, ENC_DEC = "phi_3_vision_4_2b", "seamless_m4t_large_v2"
TOL = 1e-5


def _close(ours, theirs, tol=TOL):
    """tests/test_torch_models.py's tolerance: ``tol`` relative to the
    output's own scale."""
    theirs = np.asarray(theirs, np.float32)
    scale = max(1.0, float(np.abs(theirs).max()))
    np.testing.assert_allclose(ours.detach().float().numpy(), theirs,
                               rtol=tol, atol=tol * scale)


def _flat(plan):
    return [(jax.tree_util.keystr(p), tuple(l.shape), l.dtype)
            + ((l.init, l.fan_in) if hasattr(l, "init") else ())
            for p, l in jax.tree_util.tree_flatten_with_path(
                plan, is_leaf=lambda x: hasattr(x, "shape"))[0]]


def _unit_gain(plan, params, seed):
    """``params`` with every stacked leaf that has no ``fan_in`` redrawn
    at a std of 1/sqrt(its first unstacked dimension), as its unstacked
    twin draws.  The plans draw such leaves (``wq``, ``wk``, ``wv``,
    ``w_in`` of the period and the encoder) at 1/sqrt(repeats), 1 at the
    reduced depth, so the activations grow 16x a projection, the softmax
    saturates, and float32 rounding alone puts either package ~1e-4 of
    the output's scale from a float64 evaluation of the same function."""
    rng = np.random.default_rng(seed)

    def leaf(path, p, a):
        if "period" in jax.tree_util.keystr(path) and p.fan_in is None \
                and p.init == "normal":
            return jnp.asarray(_np(rng, *a.shape) / np.sqrt(a.shape[1]))
        return a
    return jax.tree_util.tree_map_with_path(
        leaf, plan, params, is_leaf=lambda x: hasattr(x, "pspec"))


def _bridged(arch, seed):
    jcfg = reduced(get_config(arch)).replace(dtype="float32")
    tcfg = t_reduced(t_get_config(arch)).replace(dtype="float32")
    model = jax_model.Model(jcfg)
    jparams = _unit_gain(model.plan, model.init(jax.random.key(seed)), seed)
    return jcfg, tcfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def vlm():
    return _bridged(VLM, 6)


@pytest.fixture(scope="module")
def enc_dec():
    return _bridged(ENC_DEC, 7)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("arch,enc_len", [(VLM, 0), (ENC_DEC, 0),
                                          (ENC_DEC, 2048)])
def test_plans_match_jax_at_full_width(arch, enc_len):
    jcfg, tcfg = get_config(arch), t_get_config(arch)
    tplan = t_model.model_plan(tcfg)
    assert _flat(tplan) == _flat(jax_model.model_plan(jcfg))
    assert tplan["frontend_proj"].shape == (1024, tcfg.d_model)
    tcache = t_model.cache_plan(tcfg, 8, 2048, enc_len)
    assert _flat(tcache) == _flat(jax_model.cache_plan(
        jcfg, 8, 2048, NO_POLICY, enc_len=enc_len))
    layer = tcache["period"]["sub0"]
    if arch == ENC_DEC:
        assert tplan["encoder"]["period"]["sub0"]["attn"]["wq"].shape == (
            24, 1024, 16, 64)
        assert set(tplan["period"]["sub0"]) >= {"norm_x", "cross"}
        assert ("cross" in layer) == bool(enc_len)
    if enc_len:
        assert layer["cross"]["ck"].shape == (24, 8, enc_len, 16, 64)


# ---------------------------------------------------- the model functions
def test_merge_frontend_matches_jax(vlm):
    jcfg, tcfg, jp, tp = vlm
    rng = np.random.default_rng(31)
    embeds = _np(rng, 2, tcfg.frontend.num_prefix, tcfg.frontend.embed_dim)
    toks = rng.integers(0, tcfg.vocab_size, (2, 5))
    ours = t_model._merge_frontend(tp, tcfg, torch.from_numpy(toks),
                                   torch.from_numpy(embeds))
    assert ours.shape == (2, tcfg.frontend.num_prefix + 5, tcfg.d_model)
    _close(ours, jax_model._merge_frontend(
        jp, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(embeds),
        NO_POLICY))
    # no embeds: the token embeddings alone
    _close(t_model._merge_frontend(tp, tcfg, torch.from_numpy(toks)),
           jax_model.embed_tokens(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                  NO_POLICY))


def test_encode_matches_jax(enc_dec):
    jcfg, tcfg, jp, tp = enc_dec
    frames = _np(np.random.default_rng(32), 2, 13, tcfg.frontend.embed_dim)
    before = flash_kernel.launches
    ours = t_model.encode(tp, tcfg, torch.from_numpy(frames))
    assert flash_kernel.launches == before      # the CPU runs the plain one
    _close(ours, jax_model.encode(jp, jcfg, jnp.asarray(frames), NO_POLICY))


def test_cross_attention_matches_jax(enc_dec):
    """Prefill's call (every frame, through flash's plain version) and
    decode's masked call over a slot cache padded with garbage past each
    row's frames both equal the reference's unmasked ``cross_attn``."""
    jcfg, tcfg, jparams, tparams = enc_dec
    jp = jax.tree.map(lambda a: a[0], jparams["period"]["sub0"]["cross"])
    tp = jax.tree.map(lambda a: a[0], dict(tparams["period"]["sub0"]["cross"]))
    rng = np.random.default_rng(33)
    memory = _np(rng, 2, 11, tcfg.d_model)
    x = _np(rng, 2, 3, tcfg.d_model)
    jck, jcv = jax_attn.cross_attn_kv(jp, jnp.asarray(memory))
    tck, tcv = t_attn.cross_attn_kv(tp, torch.from_numpy(memory))
    _close(tck, jck)
    _close(tcv, jcv)
    theirs = jax_attn.cross_attn(jp, jnp.asarray(x), jck, jcv, jcfg,
                                 NO_POLICY)
    _close(t_attn.cross_attn(tp, torch.from_numpy(x), tck, tcv, tcfg),
           theirs)
    # decode's call: row 0 holds 11 frames of a 16-frame slot, row 1 the
    # first 6 frames of its memory
    pad = torch.from_numpy(_np(rng, 2, 16, *tck.shape[2:])) * 1e3
    ck, cv = pad.clone(), pad.clone()
    ck[:, :11], cv[:, :11] = tck, tcv
    lens = torch.tensor([11, 6])
    x1 = x[:, :1]
    ours = t_attn.cross_attn(tp, torch.from_numpy(x1), ck, cv, tcfg,
                             kv_len=lens)
    _close(ours[:1], jax_attn.cross_attn(jp, jnp.asarray(x1[:1]), jck[:1],
                                         jcv[:1], jcfg, NO_POLICY))
    _close(ours[1:], jax_attn.cross_attn(jp, jnp.asarray(x1[1:]),
                                         jck[1:, :6], jcv[1:, :6], jcfg,
                                         NO_POLICY))


def _greedy_pair(jcfg, tcfg, jp, tp, tokens, batch_extra, first_pos,
                 steps=8, seq_cap=48):
    """Prefill then ``steps`` greedy decode steps in both packages, decode
    at ``first_pos + i``; the logits of every call are held to 1e-5 and
    the greedy tokens must be equal."""
    b = tokens.shape[0]
    kw = {k: torch.from_numpy(v) for k, v in batch_extra.items()}
    logits, cache = t_model.prefill(tp, tcfg, torch.from_numpy(tokens),
                                    seq_cap=seq_cap, **kw)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              **{k: jnp.asarray(v) for k, v in batch_extra.items()}}
    jlogits, jcache = jax_model.prefill(jp, jcfg, jbatch, NO_POLICY,
                                        seq_cap=seq_cap)
    jdecode = jax.jit(lambda p, c, t, q: jax_model.decode_step(
        p, jcfg, c, t, q, NO_POLICY))
    out, jout = [], []
    for i in range(steps + 1):
        _close(logits, jlogits)
        tok, jtok = logits.argmax(-1), np.asarray(jnp.argmax(jlogits, -1))
        out.append(tok.tolist())
        jout.append(jtok.tolist())
        if i == steps:
            break
        pos = np.full((b,), first_pos + i, np.int32)
        logits = t_model.decode_step(tp, tcfg, cache, tok,
                                     torch.from_numpy(pos))
        jlogits, jcache = jdecode(jp, jcache, jnp.asarray(jtok, jnp.int32),
                                  jnp.asarray(pos))
    assert out == jout
    return out


def test_vlm_prefill_and_decode_token_identical_to_jax(vlm):
    jcfg, tcfg, jp, tp = vlm
    rng = np.random.default_rng(34)
    fe = tcfg.frontend
    embeds = _np(rng, 2, fe.num_prefix, fe.embed_dim)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12))
    _greedy_pair(jcfg, tcfg, jp, tp, toks, {"embeds": embeds},
                 fe.num_prefix + 12)


def test_enc_dec_prefill_and_decode_token_identical_to_jax(enc_dec):
    jcfg, tcfg, jp, tp = enc_dec
    rng = np.random.default_rng(35)
    frames = _np(rng, 2, 17, tcfg.frontend.embed_dim)
    toks = rng.integers(0, tcfg.vocab_size, (2, 3))
    _greedy_pair(jcfg, tcfg, jp, tp, toks, {"frames": frames}, 3)


# ----------------------------------------------------------------- engine
TRACE = [(40, 4), (7, 8), (21, 2), (3, 6), (60, 3)]


def _jax_loop(jcfg, jp, prompts, seq_cap):
    """The JAX model functions request by request, fed the reference
    engine's stubs and decoding at the right positions."""
    fe = jcfg.frontend
    jprefill = jax.jit(lambda p, b: jax_model.prefill(p, jcfg, b, NO_POLICY,
                                                      seq_cap=seq_cap))
    jdecode = jax.jit(lambda p, c, t, q: jax_model.decode_step(
        p, jcfg, c, t, q, NO_POLICY))
    outs = []
    for p, (n, mn) in zip(prompts, TRACE):
        batch = {"tokens": jnp.asarray(p[None], jnp.int32)}
        pos = fe.num_prefix + n
        if fe.kind == "vision":
            batch["embeds"] = jnp.zeros((1, fe.num_prefix, fe.embed_dim))
        if jcfg.encoder is not None:
            batch["frames"] = jnp.zeros((1, n, fe.embed_dim))
            batch["tokens"] = jnp.ones((1, 1), jnp.int32)
            pos = 1
        logits, cache = jprefill(jp, batch)
        out = [int(jnp.argmax(logits[0]))]
        for i in range(mn - 1):
            logits, cache = jdecode(jp, cache, jnp.asarray([out[-1]]),
                                    jnp.asarray([pos + i], jnp.int32))
            out.append(int(jnp.argmax(logits[0])))
        outs.append(out)
    return outs


@pytest.mark.parametrize("arch", [VLM, ENC_DEC])
def test_dense_engine_token_identical_to_the_jax_model_loop(arch, vlm,
                                                            enc_dec):
    jcfg, tcfg, jp, tp = vlm if arch == VLM else enc_dec
    rng = np.random.default_rng(36)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n, _ in TRACE]
    eng = ServingEngine(tcfg, params=tp, max_slots=4, seq_cap=96,
                        page_size=8, seed=0, device="cpu")
    reqs = [Request(req_id=i, tenant="T1", prompt_len=n, max_new_tokens=mn,
                    arrival=0.0, prompt_tokens=p.copy())
            for i, (p, (n, mn)) in enumerate(zip(prompts, TRACE))]
    for r in reqs:
        assert eng.submit(r)
    steps = 0
    while eng.has_work():
        eng.finalize_step(eng.step(), float(steps))
        steps += 1
        assert steps < 400, "engine did not converge"
    assert [r.output_tokens for r in reqs] == _jax_loop(jcfg, jp, prompts,
                                                        96)
    assert eng.logits_finite and eng.prefill_passes == len(TRACE)
    assert eng.kv.reserved_pages == 0
    if arch == ENC_DEC:
        # the slot cache holds up to seq_cap frames; each slot keeps the
        # frame count of the last request it served
        assert eng.cache["period"]["sub0"]["cross"]["ck"].shape[2] == 96
        assert set(eng.cross_len.tolist()) <= {n for n, _ in TRACE}


def test_seq_cap_counts_the_image_prefix_and_the_frames():
    tcfg = t_reduced(t_get_config(VLM))
    eng = ServingEngine(tcfg, max_slots=2, seq_cap=96, page_size=8,
                        device="cpu")
    p = tcfg.frontend.num_prefix

    def req(n, mn):
        return Request(req_id=0, tenant="T1", prompt_len=n,
                       max_new_tokens=mn, arrival=0.0)
    assert eng.submit(req(96 - p - 4, 4))
    assert eng.submit(req(96 - p - 3, 4)) == EXCEEDS_SEQ_CAP
    eng = ServingEngine(t_reduced(t_get_config(ENC_DEC)), max_slots=2,
                        seq_cap=96, page_size=8, device="cpu")
    assert eng.submit(req(97, 2)) == EXCEEDS_SEQ_CAP       # frames
    assert eng.submit(req(4, 96)) == EXCEEDS_SEQ_CAP       # BOS + 96 new
    assert eng.submit(req(90, 2))


# ------------------------------------------------ the reference's faults
def test_reference_engine_cannot_merge_an_enc_dec_prefill(enc_dec):
    """The reference plans its slot cache without ``enc_len``, so the
    prefill's ``cross`` leaves have no slot to go to."""
    jcfg, _, jp, _ = enc_dec
    eng = JaxEngine(jcfg, params=jp, max_slots=2, seq_cap=64, page_size=8)
    assert eng.submit(JaxRequest(req_id=0, tenant="T1", prompt_len=9,
                                 max_new_tokens=2, arrival=0.0))
    with pytest.raises(ValueError, match="Dict key mismatch"):
        eng.step()


def test_reference_vlm_decode_position_leaves_out_the_prefix(vlm):
    """Decoding token S after a VLM prefill of S tokens at ``prompt_len``
    (the reference engine's position) is far from the prefill of S + 1
    tokens; at ``num_prefix + prompt_len`` it agrees to 1e-5."""
    jcfg, _, jp, _ = vlm
    rng = np.random.default_rng(37)
    fe = jcfg.frontend
    embeds = jnp.asarray(_np(rng, 1, fe.num_prefix, fe.embed_dim))
    toks = jnp.asarray(rng.integers(0, jcfg.vocab_size, (1, 12)), jnp.int32)
    full, _ = jax_model.prefill(jp, jcfg, {"tokens": toks, "embeds": embeds},
                                NO_POLICY)
    _, cache = jax_model.prefill(jp, jcfg, {"tokens": toks[:, :11],
                                            "embeds": embeds},
                                 NO_POLICY, seq_cap=32)

    def decode_at(pos):
        logits, _ = jax_model.decode_step(jp, jcfg, cache, toks[:, 11],
                                          jnp.asarray([pos], jnp.int32),
                                          NO_POLICY)
        return logits
    wrong = decode_at(11)
    assert float(jnp.abs(wrong - full).max()) > 1.0
    _close(torch.from_numpy(np.array(decode_at(fe.num_prefix + 11))),
           full)


# ---------------------------------------------------------- entry points
@pytest.mark.parametrize("arch,reason", [
    (VLM, "multimodal frontends"), (ENC_DEC, "encoder-decoder models")])
def test_serve_cli_serves_and_paged_refuses(capsys, arch, reason):
    serve_mod.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                    "--max-new", "3", "--qps", "50"])
    out = capsys.readouterr().out
    assert "completed 2/2" in out and "logits_finite=True" in out
    with pytest.raises(ValueError, match=f"paged backend does not support "
                                         f"{reason}"):
        serve_mod.serve(arch=arch, backend="paged", requests=1,
                        device="cpu", verbose=False)
