"""The port's multi-tenant ``serve()`` against the reference's, on the CPU.

Both run with ``det_timing`` (the reference's per-token step-cost model,
so the virtual schedule does not depend on measured time) and
``exact_tokens`` (float32, the plain attention path), and every tenant's
engines in the port get the weights the JAX engines draw from the same
seed, bridged through numpy.  Per-request output tokens, TTFTs by request,
the door verdicts and reject reasons, the controller's actions and
arbiter peak, the routing, directory and response-cache stats, the
admission verdicts and the Prometheus export must be identical."""
import jax
import numpy as np
import pytest

from repro.configs.base import get_config, reduced
from repro.launch.serve import serve as jax_serve
from repro.models.model import Model as JaxModel
from repro_torch.launch.serve import serve
from repro_torch.models.bridge import params_from_numpy

TENANT_KEYS = ("completed", "offered", "shed", "rejected", "expired",
               "reject_reasons", "redriven", "preempted", "outputs",
               "ttft_by_id", "ttft_p50_ms", "ttft_p99_ms", "itl_p99_ms")
FLEET_KEYS = ("routing", "directory", "response_cache", "admission",
              "actions", "arbiter_max_units", "gateway", "prometheus")

RUNS = {
    # (i) the paper's experiment: 2 tenants x 2 replicas, dense,
    # interference on, the controller on
    "dense-2x2-interfere": dict(requests=6, qps=30.0, max_new=4,
                                num_tenants=2, replicas=2, interfere=True),
    # (ii) cache-aware routing over a shared response cache, with
    # speculative lanes (the cache primes their draft hints)
    "paged-1x2-route-cache": dict(requests=8, qps=40.0, max_new=4,
                                  replicas=2, backend="paged", route="cache",
                                  spec_k=2),
    # (iii) backpressure: a one-deep door queue and a 1 ms deadline
    # (queue_full, pool_exhausted and expired verdicts) and a late tenant
    # admitted mid-run, served with its own bridged weights
    "listen-admit": dict(requests=24, qps=100.0, max_new=8, prompt_len=96,
                         slots=1, listen=True, door_queue=1,
                         door_deadline_ms=1.0, admit=1),
    # ... and past the Kingman rate limit: rate_limit rejections, and the
    # late tenant queued by admission instead
    "listen-rate-limit": dict(requests=24, qps=300.0, max_new=8, slots=1,
                              listen=True, door_queue=2,
                              door_deadline_ms=5.0, admit=1),
}


def bridged_params(arch="stablelm_3b"):
    """``(tenant, engine_seed) -> params``: the weights the JAX engine
    draws from ``engine_seed``, as port tensors on the CPU."""
    cfg = reduced(get_config(arch)).replace(dtype="float32")
    cache = {}

    def get(tenant, seed):
        if seed not in cache:
            jparams = JaxModel(cfg).init(jax.random.key(seed))
            cache[seed] = params_from_numpy(
                jax.tree.map(np.asarray, jparams), device="cpu")
        return cache[seed]
    return get


@pytest.mark.parametrize("run", [
    pytest.param("dense-2x2-interfere", marks=pytest.mark.tier2),
    "paged-1x2-route-cache", "listen-admit", "listen-rate-limit"])
def test_serve_matches_the_reference(run):
    kw = dict(RUNS[run], det_timing=True, exact_tokens=True, seed=0,
              verbose=False)
    ref = jax_serve(**kw)
    out = serve(**kw, params=bridged_params(), device="cpu")
    tenants = [k for k in ref if k not in FLEET_KEYS]
    assert tenants and set(tenants) <= set(out)
    for name in tenants:
        for key in TENANT_KEYS:
            assert out[name][key] == ref[name][key], (name, key)
    for key in FLEET_KEYS:
        assert out.get(key) == ref.get(key), key
    # each run exercised what it is there for
    if run.startswith("dense"):
        assert tenants == ["L0", "L1"] and "actions" in out
        assert out["arbiter_max_units"] <= 7
    elif run.startswith("paged"):
        assert out["directory"]["hits"] > 0
        assert out["routing"]["T1"]["routed_cache"] > 0
        assert out["response_cache"]["T1"]["entries"] > 0
    else:
        reasons = out["T1"]["reject_reasons"]
        verdicts = out["admission"]["verdicts"]
        if run == "listen-admit":
            assert verdicts["admit"] == 1 and "A0" in out
            assert out["T1"]["expired"] > 0 and "queue_full" in reasons
        else:
            assert verdicts["queue"] == 1 and reasons["rate_limit"] > 0
    for name in tenants:
        assert out[name]["logits_finite"]
        assert out[name]["completed"] > 0
