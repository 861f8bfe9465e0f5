"""The port's failure domains against the reference's, on the CPU: the
seeded chaos schedule (replica crashes redriven onto survivors, actuator
failures through the bounded-retry actuator, a stuck lane requeued by the
watchdog, a fabric window), recovery turned off, and live migration for
crashes, planned drains and gray failures.

Each run is ``serve()`` under ``det_timing`` + ``exact_tokens`` with the
JAX engines' weights bridged into the port, on 2 or 3 paged replicas.
Everything both return must be equal: per-request outputs and TTFTs, the
door verdicts, the redriven request ids and TTFTs, the fault log and
``watchdog_fired``, the retrying actuator's stats, the migration
summaries (lanes, pages, bytes, transfer time, verify failures), the
gateway counters, the Prometheus text and, with tracing on, the flight
recorder's breakdown and its Chrome trace.  Each run also shows the path
it is there for."""
import json

import pytest

from repro.launch.serve import serve as jax_serve
from repro_torch.launch.serve import serve
from test_torch_harness import bridged_params

BASE = dict(requests=24, qps=40.0, backend="paged", chaos=True,
            det_timing=True, exact_tokens=True, seed=0, verbose=False)
RUNS = {
    # plain chaos: a crash redriven onto the survivor, a stuck lane the
    # watchdog requeues, two actuator failures, a fabric window
    "chaos-redrive": dict(replicas=2, max_new=16, chaos_seed=8),
    # the same schedule with recovery off: the crash sheds instead
    "chaos-no-recover": dict(replicas=2, max_new=16, chaos_seed=8,
                             recover=False),
    # migration: the crash and a planned drain both ship warm lanes
    "migrate-crash-drain": dict(replicas=3, max_new=8, chaos_seed=3,
                                migrate=True, drains=[(0.4, "T1", 1)]),
    # migration: a gray replica is evacuated warm and quarantined (and
    # crashes there), and a drain ships two warm lanes
    "migrate-gray-drain": dict(replicas=3, max_new=16, chaos_seed=8,
                               migrate=True, drains=[(0.45, "T1", 1)]),
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_failure_domains_match_the_reference(tmp_path, run):
    kw = dict(BASE, **RUNS[run])
    traced = run.startswith("migrate")
    if traced:
        kw["trace_out"] = str(tmp_path / "ref.json")
    ref = jax_serve(**kw)
    if traced:
        kw["trace_out"] = str(tmp_path / "port.json")
    out = serve(**kw, params=bridged_params(), device="cpu")
    assert set(ref) <= set(out)
    for key, want in ref.items():
        if key == "T1":
            for k, v in want.items():
                assert out["T1"][k] == v, (k, v, out["T1"][k])
        else:
            assert out[key] == want, key
    if traced:
        assert json.loads((tmp_path / "port.json").read_text()) == \
            json.loads((tmp_path / "ref.json").read_text())

    t1, faults = out["T1"], out["faults"]
    log = [kind for _, kind, _ in faults["log"]]
    assert t1["completed"] + t1["shed"] == t1["offered"] == 24
    assert faults["actuator"]["calls"] >= 1 or "actuator_fail" in log
    if run == "chaos-redrive":
        assert t1["redriven"] == 1 and t1["shed"] == 0
        assert faults["watchdog_fired"] == 1
        assert "watchdog_requeue" in log
        assert t1["redriven_ids"] and "migrations" not in out
    elif run == "chaos-no-recover":
        assert t1["shed"] == 1 and t1["redriven"] == 0
        assert not faults["recover"]
    else:
        migs = {m["reason"]: m for m in out["migrations"]}
        assert migs["drain"]["warm"] >= 1
        assert migs["crash" if "crash" in run else "gray"]["warm"] >= 1
        assert all(m["verify_failures"] == 0 for m in out["migrations"])
        assert sum(m["bytes"] for m in out["migrations"]) > 0
        assert t1["shed"] == 0 and t1["completed"] == 24
        assert set(t1["redriven_ids"]) <= set(t1["outputs"])
        assert len(t1["redriven_ttft_ms"]) == len(t1["redriven_ids"])
        if "gray" in run:
            assert "gray_evacuate" in log
        assert out["trace"]["T1"]["completed"] == 24



def test_a_migrated_lane_resumes_after_its_last_step():
    """On 4 replicas (chaos seed 7, a drain at 0.45 s) the gray replica is
    evacuated while its step is still in flight.  The reference resumes
    the lane on its destination after the modelled transfer alone, before
    that step has ended, so with tracing on its flight recorder rejects
    the run (a span ending before the lane's cursor).  The port resumes
    the lane no earlier than the step's end, and otherwise serves the
    reference's run: the same tokens, faults and migrations."""
    kw = dict(BASE, replicas=4, max_new=16, chaos_seed=7, migrate=True,
              drains=[(0.45, "T1", 3)])
    with pytest.raises(AssertionError, match="before cursor"):
        jax_serve(**kw, trace=True)
    ref = jax_serve(**kw)
    out = serve(**kw, trace=True, params=bridged_params(), device="cpu")
    assert out["T1"]["outputs"] == ref["T1"]["outputs"]
    assert out["faults"] == ref["faults"]
    assert out["migrations"] == ref["migrations"]
    assert [m["reason"] for m in out["migrations"]] == ["drain", "crash",
                                                       "gray"]
    assert out["T1"]["completed"] == out["trace"]["T1"]["completed"] == 24
