"""The port's serve entry point on the CPU: the virtual-time loop completes
every request with the reference's metrics, the warm-up stays out of them,
and the CLI hands every flag of the reference's to serve() as the
reference's CLI does."""
import re
import sys

import pytest

from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import serve


def test_serve_completes_every_request_on_cpu():
    run = serve(requests=5, qps=20.0, prompt_len=24, prompt_len_max=40,
                max_new=4, device="cpu", verbose=False)
    out = run["T1"]
    assert out["completed"] == out["offered"] == 5
    assert out["rejected"] == 0
    assert all(len(t) == 4 for t in out["outputs"].values())
    assert out["logits_finite"]
    assert out["ttft_p99_ms"] >= out["ttft_p50_ms"] > 0
    assert out["itl_p99_ms"] >= out["itl_p50_ms"] > 0
    assert out["tokens_per_s"] > 0
    # the warm-up drain ran forward passes that the step count leaves out
    assert out["forward_passes"] > out["steps"] > 0
    assert run["device"]["peak_mem_bytes"] is None   # not a device number


def test_serve_is_deterministic_and_serves_spec_lanes():
    a = serve(requests=3, qps=50.0, max_new=3, device="cpu", verbose=False)
    b = serve(requests=3, qps=50.0, max_new=3, device="cpu", verbose=False)
    assert a["T1"]["outputs"] == b["T1"]["outputs"]
    c = serve(requests=3, qps=50.0, max_new=3, device="cpu", verbose=False,
              spec_k=2, kv_dtype="int8", backend="paged")
    assert c["T1"]["completed"] == 3


@pytest.mark.parametrize("flags", [
    ["--chaos"], ["--migrate"], ["--trace"], ["--trace-out=t.json"],
    ["--no-recover"], ["--drain-at", "0.02:T1:1"], ["--chaos-seed", "5"],
    ["--chaos", "--chaos-seed", "3", "--migrate", "--drain-at", "0.4:T1:1",
     "--drain-at", "0.6:T1:0", "--trace", "--trace-out=t.json",
     "--replicas", "3"],
    ["--drain-at", "soon"],
])
def test_cli_refuses_unported_flags(monkeypatch, tmp_path, capsys, flags):
    """(The name predates the port of these flags.)  No flag of the
    reference's CLI is refused any more: each of the chaos, migration,
    drain and trace flags, alone and together, reaches serve() with the
    value the reference's CLI gives it, and the port's CLI serves it on
    the CPU (paged replicas, so a drain has a survivor); a malformed
    ``--drain-at`` is refused by both CLIs."""
    import repro.launch.serve as ref_mod
    run = ["--replicas", "2", "--backend", "paged", *flags]
    if "soon" in flags:
        monkeypatch.setattr(sys, "argv", ["serve", *run])
        with pytest.raises(SystemExit, match="T:TENANT:REPLICA"):
            ref_mod.main()
        with pytest.raises(SystemExit, match="T:TENANT:REPLICA"):
            serve_mod.main(["--device", "cpu", *run])
        return
    calls = {}
    monkeypatch.setattr(ref_mod, "serve",
                        lambda **kw: calls.setdefault("ref", kw))
    monkeypatch.setattr(sys, "argv", ["serve", *run])
    ref_mod.main()
    monkeypatch.setattr(serve_mod, "serve",
                        lambda **kw: calls.setdefault("port", kw))
    serve_mod.main(["--device", "cpu", *run])
    assert {k: calls["port"][k] for k in calls["ref"]} == calls["ref"]
    monkeypatch.undo()
    monkeypatch.chdir(tmp_path)
    serve_mod.main(["--device", "cpu", "--requests", "3", "--max-new", "2",
                    "--qps", "50", *run])
    assert "completed 3/3" in capsys.readouterr().out
    if "--trace-out=t.json" in flags:
        assert (tmp_path / "t.json").is_file()


# serve() arguments that only the port's CLI has
_PORT_ONLY = {"prompt_len_max", "seq_cap", "reduce", "repeats", "device"}


@pytest.mark.parametrize("flags", [
    ["--tenants", "2"], ["--replicas", "2"], ["--interfere"],
    ["--listen", "--door-queue", "3", "--door-deadline-ms", "50"],
    ["--admit", "1"],
    ["--route", "load", "--route-imbalance", "2", "--backend", "paged"],
])
def test_cli_serves_the_ported_flags_as_the_reference(monkeypatch, capsys,
                                                      flags):
    """The flags the port now serves reach serve() with the values the
    reference's CLI gives them, and the port's CLI serves them."""
    import repro.launch.serve as ref_mod
    calls = {}
    monkeypatch.setattr(ref_mod, "serve",
                        lambda **kw: calls.setdefault("ref", kw))
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    ref_mod.main()
    monkeypatch.setattr(serve_mod, "serve",
                        lambda **kw: calls.setdefault("port", kw))
    serve_mod.main(["--device", "cpu", *flags])
    ref, port = calls["ref"], calls["port"]
    assert set(ref) == set(port) - _PORT_ONLY
    assert {k: port[k] for k in ref} == ref
    monkeypatch.undo()
    serve_mod.main(["--device", "cpu", "--requests", "3", "--max-new", "2",
                    "--qps", "50", *flags])
    lines = re.findall(r"completed (\d+)/(\d+)", capsys.readouterr().out)
    assert len(lines) >= port["num_tenants"]
    assert all(done == offered == "3" for done, offered in lines)


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
    assert out["T1"]["completed"] == 3
    assert out["T1"]["logits_finite"]
    assert out["T1"]["forward_passes"] > 0


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
    assert out["T1"]["layers"] == 6 and out["T1"]["completed"] == 2
    assert out["T1"]["logits_finite"]
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
