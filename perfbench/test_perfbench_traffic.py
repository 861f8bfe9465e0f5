"""The traffic generators: deterministic per seed, the same shapes for
every seed, and within their parameters."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench import traffic

MIXES = ("chat", "batch", "shared_prefix", "long_prompt")


def _all(src, horizon):
    reqs = list(src.warm()) + src.pop_due(horizon)
    for r in list(src.warm())[:3]:
        src.done(r, 1.0)
    return reqs + src.pop_due(horizon)


@pytest.mark.parametrize("mix_name", MIXES)
def test_same_seed_same_inputs(mix_name):
    mix = traffic.load(mix_name)
    a = _all(traffic.source(mix, 1000, 2**31 + 17, 12.0), 12.0)
    b = _all(traffic.source(mix, 1000, 2**31 + 17, 12.0), 12.0)
    assert [(r.rid, r.due, r.max_new) for r in a] == \
        [(r.rid, r.due, r.max_new) for r in b]
    assert all(np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))


@pytest.mark.parametrize("mix_name", ("chat", "shared_prefix", "long_prompt"))
def test_seeds_share_shapes_in_another_order(mix_name):
    mix = traffic.load(mix_name)
    a = traffic.source(mix, 1000, 1, 20.0)
    b = traffic.source(mix, 1000, 2, 20.0)
    shape = lambda s: sorted((r.tokens.size, r.max_new) for r in s.pending)
    assert shape(a) == shape(b)
    assert [r.tokens.size for r in a.pending] != \
        [r.tokens.size for r in b.pending]
    gaps = lambda s: sorted(np.diff([0.0] + [r.due for r in s.pending]))
    assert np.allclose(gaps(a), gaps(b))


@pytest.mark.parametrize("mix_name", MIXES)
def test_within_parameters(mix_name):
    mix = traffic.load(mix_name)
    src = traffic.source(mix, 49155, 99, 30.0)
    reqs = _all(src, 30.0)
    pre = mix.get("prefix")
    extra = pre["tokens"] if pre else 0
    for r in reqs:
        assert r.tokens.dtype == np.int32
        assert 0 <= r.tokens.min() and r.tokens.max() < 49155
        if r.warm:      # met part-way: a longer prompt, fewer to come
            assert 1 <= r.max_new <= mix["output"]["max"]
            assert r.tokens.size + r.max_new <= (
                extra + mix["prompt"]["max"] + mix["output"]["max"])
            continue
        assert mix["output"]["min"] <= r.max_new <= mix["output"]["max"]
        assert (extra + mix["prompt"]["min"] <= r.tokens.size
                <= extra + mix["prompt"]["max"])
    assert all(r.tokens.size + r.max_new <= 4096 for r in reqs)
    if "rate_per_s" in mix:
        rate, pre = mix["rate_per_s"], mix["preamble_s"]
        assert len(src.pending) == (int(np.ceil(rate * pre))
                                    + int(np.ceil(rate * (30.0 - pre))))
        # the preamble's requests, then the window's, each due at the rate
        assert sum(r.due < pre + 1.0 / rate for r in src.pending) >= \
            int(np.ceil(rate * pre))
        assert max(r.due for r in src.pending) <= 30.0 + 2.0 / rate
        assert len(src.warm()) == round(mix["rate_per_s"]
                                        * mix["warm_lifetime_s"])


def test_shared_prefixes_are_zipf_over_whole_pages():
    mix = traffic.load("shared_prefix")
    src = traffic.source(mix, 49155, 5, 60.0)
    pre = mix["prefix"]
    heads = [bytes(r.tokens[:pre["tokens"]]) for r in src.pending]
    counts = sorted((heads.count(h) for h in set(heads)), reverse=True)
    assert len(counts) == pre["count"]
    assert counts[0] > 2 * counts[-1]       # s = 1: the first ~8x the last
    assert pre["tokens"] % 16 == 0


def test_closed_loop_sends_next_on_completion():
    mix = traffic.load("batch")
    src = traffic.source(mix, 1000, 3, 10.0)
    assert len(src.warm()) == mix["clients"]
    assert src.pop_due(5.0) == [] and src.next_due() is None
    src.done(src.warm()[0], 2.5)
    (nxt,) = src.pop_due(2.5)
    assert nxt.due == 2.5 and nxt.rid == mix["clients"]
    with pytest.raises(ValueError):
        traffic.source(mix, 1000, 3, 10.0, rate=2.0)


def test_warm_requests_are_length_biased():
    out = np.array([10, 1000])
    idx = traffic.length_biased(out, np.random.default_rng(0), 2000)
    assert 0.97 < np.mean(idx == 1) < 1.0
