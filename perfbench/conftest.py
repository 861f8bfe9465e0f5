"""Fixtures of the benchmark's CPU tests: a cell of the benchmark cut to a
size the CPU runs in a second or two (the port's ``reduced`` widths, a
small pool and short requests), run through the harness with the card's
look skipped."""
from __future__ import annotations

import copy
import time

import pytest


def tiny(cell_name: str, dtype: str = "bfloat16"):
    """(cell, port config) of ``cell_name`` at reduced widths."""
    from repro_torch.configs.base import get_config, reduced

    from perfbench import harness
    cell = harness.load_cell(cell_name)
    cell = copy.deepcopy(cell)
    pc = reduced(get_config(cell.config["arch"])).replace(dtype=dtype)
    cell.config["dtype"] = dtype
    cell.config["model"].update(
        hidden_size=pc.d_model, intermediate_size=pc.ffn.d_ff,
        num_hidden_layers=pc.num_layers, num_attention_heads=pc.attn.num_heads,
        num_key_value_heads=pc.attn.num_kv_heads, head_dim=pc.attn.head_dim,
        vocab_size=pc.vocab_size)
    cell.config["engine"]["pool_pages"] = 512
    mix = cell.mix
    # short outputs, so requests finish however slowly a loaded CPU steps
    mix["prompt"].update(min=8, max=48)
    mix["output"].update(min=3, max=8)
    for key in ("prompt", "output"):
        if "median" in mix[key]:
            mix[key]["median"] = mix[key]["min"] * 2
    if "prefix" in mix:
        mix["prefix"]["tokens"] = 48
    if "rate_per_s" in mix:
        mix.update(rate_per_s=6.0, warm_lifetime_s=1.0)
    else:
        mix.update(clients=6, pool=64)
    mix.update(preamble_s=0.3, trace_steps=4,
               engine={"max_slots": 6, "chunk_tokens": 32})
    return cell, pc


@pytest.fixture
def run_tiny(monkeypatch):
    """Run a tiny cell on the CPU; returns (result, readings).  The test
    process shares ``sys.modules`` with test files that load JAX, so the
    run's own look for forbidden modules is left to
    ``test_perfbench_imports.py``'s fresh process."""
    import torch

    from perfbench import harness
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: [])

    def run(cell_name, seed=20260, seconds=1.5, trace=False, limits=None,
            hook=None, control=False, log=lambda _: None):
        cell, pc = tiny(cell_name)
        if limits is not None:
            cell.limits = limits
        # one thread: the test workers share the CPU, and many threads
        # each would slow the tiny steps far more than one does
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return harness.run_cell(cell, seed, seconds, trace,
                                    t_start=time.perf_counter(),
                                    device="cpu", port_cfg=pc, hook=hook,
                                    control=control, log=log)
        finally:
            torch.set_num_threads(threads)
    return run
