"""Whole runs of tiny cells on the CPU (the card's look skipped): the
result line's keys, the check passing on a sound program, its control
failing, and the check failing when the timed path is broken
underneath."""
from __future__ import annotations

import json

import pytest
import torch

from perfbench import harness

# limits for the tiny cells' reduced widths: their sound runs read
# served_gap <= ~0.03 and logit_err <= ~0.06, the float8 control >= ~0.14
# and >= ~0.2 (CPU runs at these widths, not the cells' limits)
TINY = {"served_gap": 0.09, "logit_err": 0.12}


def _bench():
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", ("olmo2_7b.chat", "granite_3_8b.batch"))
def test_tiny_run_is_correct_and_well_formed(run_tiny, cell):
    result, readings = run_tiny(cell, limits=TINY, control=True)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"], readings
    want = {m["name"] for m in _bench()["end_to_end"]
            if harness._reports(m, cell)}
    # a loaded CPU may step too slowly for a tail in a tiny window: the
    # values are the card's to judge, the names are the cell's
    assert "setup_s" in result["metrics"]
    assert set(result["metrics"]) <= want
    assert all(v["value"] >= 0 for v in result["metrics"].values())
    assert result["failed"] == 0
    assert readings["compared_tokens"] >= 10
    # the control, the reference in float8 in the program's place, held
    # to the same limits, is not correct where the program is
    assert readings["control_correct"] is False, readings


def test_tiny_traced_run_reads_the_per_layer_metrics(run_tiny):
    lines = []
    result, _ = run_tiny("granite_3_8b.shared_prefix", trace=True,
                         limits=TINY, log=lines.append)
    assert result["correct"]
    # no card: the device's readers find nothing to read
    assert set(result["metrics"]) <= {"engine_host_pct", "prefix_hit_pct"}
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes", "busy_s",
                                     "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the trace's census goes to the log, not to the result line
    (census,) = [json.loads(x)["trace_census"] for x in lines
                 if "trace_census" in x]
    assert census["traced_steps"] == 4
    assert census["whole_steps"] == 0         # no launch on the CPU
    assert set(census) == {"traced_steps", "host_forwards", "whole_steps",
                           "host_launches", "device_records", "lost_records",
                           "unpaired_records", "graph_launches"}


def _alter_tokens(engine):
    """A served token altered where it is produced: every other step's
    logits send each lane to token 3."""
    rt = engine.runtime
    impl, calls = rt._mixed_impl, [0]

    def broken(*args):
        logits = impl(*args)
        calls[0] += 1
        if calls[0] % 2 == 0:
            logits = logits.clone()
            logits[:, 3] = logits.max() + 1.0
        return logits
    rt._mixed_impl = broken


def _drop_kv_writes(engine):
    """The step's K/V never reach the pages: attention reads stale pages."""
    engine.runtime._scatter = lambda *args: None


def _reuse_stale_prefix(engine):
    """Prefix pages matched without their contents: every page handed out
    by the prefix cache is zeroed first."""
    rt = engine.runtime
    match = rt.kv.match_prefix

    def zeroing(seq_id, tokens):
        n = match(seq_id, tokens)
        for page in (rt.kv.tables[seq_id].pages[:n // rt.page] if n else ()):
            for _, _, pool in rt._layers:
                pool["k"][page].zero_()
                pool["v"][page].zero_()
        return n
    rt.kv.match_prefix = zeroing


@pytest.mark.parametrize("cell,fault", [
    ("olmo2_7b.chat", _alter_tokens),
    ("olmo2_7b.chat", _drop_kv_writes),
    ("granite_3_8b.shared_prefix", _reuse_stale_prefix)])
def test_broken_timed_path_is_not_correct(run_tiny, cell, fault):
    result, readings = run_tiny(cell, limits=TINY, hook=fault)
    assert not result["correct"], readings
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = harness.load_cell("olmo2_7b.chat")
    with pytest.raises(harness.NoCard):
        harness.run_cell(cell, 1, 1.0, False, t_start=0.0)
