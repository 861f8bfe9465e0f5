"""The port's serve entry point on the CPU: the virtual-time loop completes
every request with the reference's metrics, the warm-up stays out of them,
and the reference harness's flags that are not ported yet are refused."""
import pytest

from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import serve


def test_serve_completes_every_request_on_cpu():
    out = serve(requests=5, qps=20.0, prompt_len=24, prompt_len_max=40,
                max_new=4, device="cpu", verbose=False)
    assert out["completed"] == out["offered"] == 5
    assert out["rejected"] == 0
    assert all(len(t) == 4 for t in out["outputs"].values())
    assert out["logits_finite"]
    assert out["ttft_p99_ms"] >= out["ttft_p50_ms"] > 0
    assert out["itl_p99_ms"] >= out["itl_p50_ms"] > 0
    assert out["tokens_per_s"] > 0
    # the warm-up drain ran forward passes that the step count leaves out
    assert out["forward_passes"] > out["steps"] > 0
    assert out["peak_mem_bytes"] is None        # not a device number


def test_serve_is_deterministic_and_serves_spec_lanes():
    a = serve(requests=3, qps=50.0, max_new=3, device="cpu", verbose=False)
    b = serve(requests=3, qps=50.0, max_new=3, device="cpu", verbose=False)
    assert a["outputs"] == b["outputs"]
    c = serve(requests=3, qps=50.0, max_new=3, device="cpu", verbose=False,
              spec_k=2, kv_dtype="int8", backend="paged")
    assert c["completed"] == 3


@pytest.mark.parametrize("flags,match", [
    (["--tenants", "2"], "A5"), (["--replicas", "2"], "A5"),
    (["--interfere"], "A5"), (["--listen"], "A5"), (["--admit", "1"], "A5"),
    (["--route", "cache"], "A5"), (["--chaos"], "A5"),
    (["--migrate"], "A5"), (["--trace"], "A5"),
    (["--trace-out=t.json"], "A5"),
])
def test_cli_refuses_unported_flags(flags, match):
    with pytest.raises(SystemExit, match=match):
        serve_mod.main(["--device", "cpu", *flags])


@pytest.mark.parametrize("flags,tag", [
    ([], "stablelm-3b-reduced (1 layers, d_model 256, bfloat16, dense"),
    (["--backend", "dense", "--arch", "rwkv6_1_6b"],
     "rwkv6-1.6b-reduced (1 layers, d_model 256, bfloat16, dense"),
    (["--backend", "paged", "--kv-dtype", "int8"], "bfloat16, paged, kv "
     "int8"),
])
def test_cli_serves_each_backend_and_arch(capsys, flags, tag):
    serve_mod.main(["--device", "cpu", "--requests", "2", "--max-new", "3",
                    "--qps", "50", *flags])
    out = capsys.readouterr().out
    assert tag in out and "completed 2/2" in out


def test_serve_keeps_a_deep_random_rwkv_stack_finite(monkeypatch):
    """serve() with random weights (no ``params``) gives finite logits
    through 8 RWKV-6 layers, where the plan's raw init diverges."""
    from repro_torch.configs import base
    shallow = base.reduced
    monkeypatch.setattr(base, "reduced",
                        lambda cfg: shallow(cfg).replace(repeats=8))
    out = serve(arch="rwkv6_1_6b", requests=3, qps=50.0, prompt_len=24,
                prompt_len_max=64, max_new=4, device="cpu", verbose=False)
    assert out["completed"] == 3
    assert out["logits_finite"]
    assert out["forward_passes"] > 0


def test_backend_refusals_match_the_reference():
    with pytest.raises(ValueError, match="paged backend does not support "
                                         "mixer 'rwkv6'"):
        serve(arch="rwkv6_1_6b", backend="paged", requests=1, device="cpu",
              verbose=False)
    with pytest.raises(ValueError, match="spec_k"):
        serve(requests=1, spec_k=2, device="cpu", verbose=False)
    with pytest.raises(ValueError, match="kv_dtype"):
        serve(requests=1, kv_dtype="int8", device="cpu", verbose=False)


def test_repeats_cut_the_depth_of_a_config(capsys):
    """``repeats`` replaces the period's repeat count after ``reduce``:
    the published Jamba cut to two repeats keeps every width and is the
    plan the JAX package counts (26.1 B parameters, 48.5 GiB in bf16);
    serve and its CLI build the cut config."""
    import jax
    import numpy as np
    from repro.configs.base import get_config as jax_get_config
    from repro.models.model import model_plan as jax_model_plan
    from repro.models.params import param_bytes
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import model_plan
    from repro_torch.models.params import count_params
    full = get_config("jamba_v0_1_52b")
    cut = serve_mod.with_repeats(full, 2)
    assert (cut.num_layers, full.num_layers) == (16, 32)
    assert (cut.d_model, cut.attn, cut.moe, cut.mamba, cut.period) == \
        (full.d_model, full.attn, full.moe, full.mamba, full.period)
    jcut = jax_get_config("jamba_v0_1_52b").replace(repeats=2)
    jplan = jax_model_plan(jcut)
    assert count_params(model_plan(cut)) == sum(
        int(np.prod(p.shape)) for p in jax.tree.leaves(
            jplan, is_leaf=lambda x: hasattr(x, "pspec")))
    assert round(param_bytes(jplan) / 2**30, 1) == 48.5
    out = serve(arch="jamba_v0_1_52b", repeats=3, requests=2, qps=50.0,
                max_new=2, device="cpu", verbose=False)
    assert out["layers"] == 6 and out["completed"] == 2
    assert out["logits_finite"]
    serve_mod.main(["--device", "cpu", "--arch", "jamba_v0_1_52b",
                    "--repeats", "2", "--requests", "2", "--max-new", "2",
                    "--qps", "50"])
    assert "jamba-v0.1-52b-reduced (4 layers" in capsys.readouterr().out
    with pytest.raises(ValueError, match="repeats must be >= 1"):
        serve_mod.with_repeats(full, 0)


def test_paged_backend_refuses_mamba_layers():
    with pytest.raises(ValueError, match="paged backend does not support "
                                         "mixer 'mamba'"):
        serve(arch="jamba_v0_1_52b", backend="paged", requests=1,
              device="cpu", verbose=False)


def test_cli_serves_and_rejects_unknown_flags(capsys):
    serve_mod.main(["--device", "cpu", "--requests", "2", "--max-new", "2",
                    "--qps", "50", "--no-controller"])
    assert "completed 2/2" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve_mod.main(["--device", "cpu", "--bogus"])


def test_warm_engine_leaves_no_trace_in_metrics():
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(reduced(get_config("stablelm_3b")), device="cpu",
                        max_slots=2, seq_cap=64)
    assert eng.has_work() is False
    serve_mod.warm_engine(eng, "T1", 20)
    assert not eng.has_work()
    assert eng.metrics.prefill_tokens_total == 0
    assert eng.metrics.latency.total == 0
    assert eng.metrics.itl.total == 0
