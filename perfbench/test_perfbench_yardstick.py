"""The yardstick's counts against small cases worked by hand, the tail
arithmetic over every request (a missing first token censored at the
window's close), and the trace arithmetic."""
from __future__ import annotations

import json
import statistics

import numpy as np
import pytest

from perfbench import harness, stats, traffic, yardstick
from perfbench.harness import Context, ReqRec, StepRec
from perfbench.references import dense_gqa

M = {"hidden_size": 8, "num_attention_heads": 4, "num_key_value_heads": 2,
     "head_dim": 2, "intermediate_size": 16, "num_hidden_layers": 3,
     "vocab_size": 100}


def test_percentile_and_spread():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    for q in (0, 25, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / 3.0)


def test_step_flops_by_hand():
    # a decode lane at position 9 (10 keys) and a chunk of 3 rows at
    # positions 4, 5, 6 (5 + 6 + 7 keys); 2 logit rows
    positions = np.array([9, 4, 5, 6, 0, 0])
    row_of = [(0, 1), (1, 3)]
    per_row = 2 * (8 * 4 * 2 + 2 * 8 * 2 * 2 + 4 * 2 * 8 + 3 * 8 * 16) * 3
    attn = 4 * 4 * 2 * (10 + 5 + 6 + 7) * 3
    assert yardstick.step_flops(dense_gqa, M, positions, row_of, 2) == \
        4 * per_row + attn + 2 * 2 * 8 * 100


def test_paged_attention_counts_a_shared_page_once():
    positions = np.array([20, 17])            # two decode lanes
    row_of = [(0, 1), (1, 1)]
    tables = np.array([[7, 3, 0], [7, 5, 0]])  # page 7 shared
    flops, nbytes = yardstick.paged_attention_call(M, positions, row_of,
                                                   tables, page_size=16)
    page = 2 * 16 * 2 * 2 * 2                  # K and V, 2 heads of 2, bf16
    assert flops == 4 * 4 * 2 * (21 + 18)
    assert nbytes == 3 * page + 2 * 2 * 4 * 2 * 2
    pk = {"bf16_flops": 1e3, "hbm_bytes_s": 1e3}
    assert yardstick.roofline_s(flops, nbytes, pk) == max(flops, nbytes) / 1e3


def test_union_gaps_and_families():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 10)]
    assert yardstick.busy_union(iv) == 6
    assert yardstick.idle_gaps(iv) == [(3, 5), (7, 9)]
    assert yardstick.family("void paged_attention_tc_kernel<...>") == \
        "paged_attention"
    assert yardstick.family("nvjet_tst_128x192") == "matmul"
    assert yardstick.family("vectorized_elementwise_kernel") == \
        "elementwise/other"


def _req(rid, due, emits, finished=None, refused=False, warm=False):
    src = traffic.BenchRequest(rid, due, np.zeros(32, np.int32), 8, warm)
    return ReqRec(src, refused=refused, emits=list(emits), finished=finished)


def _ctx(reqs, steps=()):
    return Context(kind=dense_gqa, model=M, page_size=16, w0=10.0, w1=20.0,
                   steps=list(steps), traced=[],
                   reqs={r.src.rid: r for r in reqs}, setup_s=3.0,
                   slo={"ttft_ms": 200, "mean_gap_ms": 100}, peak=None,
                   trace=None)


def test_tails_over_every_request_with_censoring():
    reqs = [_req(0, 10.5, [10.6, 10.65, 10.7], finished=10.7),
            _req(1, 19.0, []),                       # censored at the close
            _req(2, 12.0, [], refused=True),         # censored too
            _req(3, 5.0, [5.1, 10.2, 10.3]),         # due before the window
            _req(4, 11.0, [0.0], warm=True)]
    ctx = _ctx(reqs)
    ttft = [0.1, 1.0, 8.0]
    assert harness.load_metric("ttft_p50_ms")(ctx) == pytest.approx(
        1e3 * np.percentile(ttft, 50))
    gaps = [0.05, 0.05, 10.2 - 5.1, 0.1]            # ends inside the window
    assert harness.load_metric("itl_p95_ms")(ctx) == pytest.approx(
        1e3 * np.percentile(gaps, 95))
    assert harness.load_metric("output_tok_s")(ctx) == pytest.approx(5 / 10)
    # due up to 19.8: request 0 meets both limits, 1 and 2 miss
    assert harness.load_metric("slo_attain_pct")(ctx) == pytest.approx(
        100 / 3)


def test_slo_counts_the_open_gap_of_an_unfinished_request():
    slow = _req(0, 19.0, [19.1, 19.15])      # open gap to 20.0: mean 0.45
    fast = _req(1, 19.0, [19.1, 19.15, 19.2, 19.3], finished=19.3)
    assert harness.load_metric("slo_attain_pct")(_ctx([slow, fast])) == 50.0


def test_host_share_and_prefix_hits():
    pos = np.array([5])
    steps = [StepRec(10.0, 10.1, 0.08, 16, pos, [(0, 1)], np.zeros((1, 1)),
                     [0], [0]),
             StepRec(10.1, 10.2, 0.09, 0, pos, [(0, 1)], np.zeros((1, 1)),
                     [1], [1])]
    reqs = [_req(0, 10.0, []), _req(1, 10.0, [])]
    ctx = _ctx(reqs, steps)
    assert harness.load_metric("engine_host_pct")(ctx) == pytest.approx(15.0)
    assert harness.load_metric("prefix_hit_pct")(ctx) == pytest.approx(
        100 * 16 / 64)
    assert harness.load_metric("mfu_pct")(ctx) is None      # no card
    assert harness.load_metric("device_idle_pct")(ctx) is None
    peak = {"bf16_flops": 1e9, "hbm_bytes_s": 1e9}
    with_card = Context(**dict(vars(ctx), peak=peak))
    flops = 2 * dense_gqa.flops(M, 1, 6, 1)
    assert harness.load_metric("mfu_pct")(with_card) == pytest.approx(
        100 * flops / (0.2 * 1e9))


def test_a_variant_metric_is_read_by_its_base_reader():
    base = harness.load_metric("mfu_pct")
    variant = harness.load_metric("mfu_pct.prefill")
    assert variant.__code__.co_code == base.__code__.co_code
    assert not (harness.BENCH / "metrics" / "mfu_pct.prefill.py").exists()
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.load_metric(m["name"])), m["name"]


def test_pages_read_counts_each_page_once():
    pos = np.array([20, 17])
    tables = np.array([[7, 3, 9], [7, 5, 9]])  # page 9 beyond both lanes
    steps = [StepRec(0.0, 0.1, 0.0, 0, pos, [(0, 1), (1, 1)], tables,
                     [0, 1], []),
             StepRec(0.1, 0.2, 0.0, 0, np.array([3]), [(0, 1)],
                     np.array([[4, 0, 0]]), [0], [])]
    assert harness.pages_read(steps, 16) == 4       # 7, 3, 5 and 4


def test_idle_counts_each_traced_step_at_its_kinds_unprofiled_wall():
    pos = np.zeros(8, np.int64)
    decode = dict(positions=pos, row_of=[(0, 1), (1, 1)],
                  block_tables=np.zeros((2, 1)), lanes=[0, 1], admitted=[])
    chunk = dict(decode, row_of=[(0, 1), (1, 6)])
    window = [StepRec(0.0, 0.05, 0.0, 0, **decode),
              StepRec(0.0, 0.07, 0.0, 0, **decode),
              StepRec(0.0, 0.20, 0.0, 0, **chunk)]
    traced = [StepRec(0.0, 0.5, 0.0, 0, **chunk),
              StepRec(0.0, 0.5, 0.0, 0, **decode)]
    # 0.15 s busy of a 0.20 s chunk step, 0.03 s of a 0.06 s decode step
    got = yardstick.idle_pct([0.15, 0.03], traced, window)
    assert got == pytest.approx(100 * (1 - 0.18 / 0.26))
    assert yardstick.idle_pct([0.1], traced[:1], window[:2]) is None
