"""The five GQA configs the port serves with no model code of their own:
OLMo 2 7B, Granite 3 8B, StarCoder2 7B, Gemma 2 27B and Mixtral 8x7B,
reduced, in float32, against the JAX package's engines on the same bridged
weights.

Their sliding windows are cut to 16 tokens (``reduced`` keeps 4096, which
these traces never reach), so every request's ring cache wraps over its
20 or more new tokens.  The port's dense engine must be token-identical
to the JAX dense engine for each config (Gemma 2 carries its attention
softcap of 50, the final logit softcap of 30 and alternating window and
global layers; StarCoder2 one kv head for four query heads at this width;
Granite tied embeddings; Mixtral a windowed layer with 4 experts of top-2
and their capacity drops); OLMo 2, the one of them that the paged runtime
takes (MHA, no window), must also be token-identical to the JAX paged
engine."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.base import get_config, reduced
from repro.models.model import Model as JaxModel
from repro.serving.engine import ServingEngine as JaxEngine
from repro.serving.request import Request as JaxRequest
from repro_torch.configs.base import get_config as t_get_config
from repro_torch.configs.base import reduced as t_reduced
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request

WINDOW = 16
# (prompt_len, max_new): every request decodes past the cut window
TRACE = [(40, 24), (7, 22), (21, 20), (3, 26)]
ARCHS = ("olmo2_7b", "granite_3_8b", "starcoder2_7b", "gemma2_27b",
         "mixtral_8x7b")


def _cut_windows(cfg):
    def cut(layer):
        return dataclasses.replace(layer, window=WINDOW) if layer.window \
            else layer
    return cfg.replace(prefix=tuple(cut(layer) for layer in cfg.prefix),
                       period=tuple(cut(layer) for layer in cfg.period))


def _cfgs(arch):
    return (_cut_windows(reduced(get_config(arch)).replace(dtype="float32")),
            _cut_windows(t_reduced(t_get_config(arch)).replace(
                dtype="float32")))


def _serve(eng, cls, specs):
    reqs = [cls(req_id=i, tenant="T1", prompt_len=len(p), max_new_tokens=mn,
                arrival=0.0, prompt_tokens=p.copy())
            for i, (p, mn) in enumerate(specs)]
    for r in reqs:
        assert eng.submit(r)
    steps = 0
    while eng.has_work():
        eng.finalize_step(eng.step(), float(steps))
        steps += 1
        assert steps < 800, "engine did not converge"
    assert all(r.done for r in reqs)
    return [r.output_tokens for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_serves_token_identical_to_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    windows = {layer.window for layer in tcfg.layer_specs()}
    assert windows <= {0, WINDOW}
    if arch in ("starcoder2_7b", "gemma2_27b", "mixtral_8x7b"):
        assert WINDOW in windows
    jparams = JaxModel(jcfg).init(jax.random.key(5))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(6)
    specs = [(rng.integers(0, jcfg.vocab_size, n), mn) for n, mn in TRACE]
    backends = ("dense", "paged") if arch == "olmo2_7b" else ("dense",)
    for backend in backends:
        kw = {"max_slots": 4, "seq_cap": 96, "page_size": 8, "seed": 0,
              "backend": backend}
        if backend == "paged":
            kw.update(chunk_tokens=16, attn_impl="ref")
        jout = _serve(JaxEngine(jcfg, params=jparams, **kw), JaxRequest,
                      specs)
        tout = _serve(ServingEngine(tcfg, params=tparams, device="cpu",
                                    **kw), Request, specs)
        assert tout == jout, backend
        assert all(len(o) == mn for o, (_, mn) in zip(tout, specs))
