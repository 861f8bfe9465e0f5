"""The benchmark's plain reference against the port's plain path, at
reduced widths, float32, on the CPU; and its float8 control."""
from __future__ import annotations

import pytest
import torch

from perfbench import weights
from perfbench.conftest import tiny
from perfbench.references import dense_gqa


@pytest.mark.parametrize("cell", ("olmo2_7b.chat", "granite_3_8b.batch"))
def test_reference_matches_the_ports_plain_prefill(cell):
    from repro_torch.models.model import prefill

    c, pc = tiny(cell, dtype="float32")
    m = dict(c.config["model"], dtype="float32")
    tree = weights.make(dense_gqa.layout(m), 123, torch.device("cpu"))
    tokens = torch.randint(0, m["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(1))
    want = torch.tensor([0, 17, 39])
    ref = dense_gqa.logits(tree, m, tokens, want)
    for j, p in enumerate(want.tolist()):
        port, _ = prefill(tree, pc, tokens[None, :p + 1], impl="ref")
        assert torch.allclose(ref[j], port[0], atol=2e-4, rtol=1e-4), (
            cell, p, (ref[j] - port[0]).abs().max())


def test_control_is_float8_and_departs():
    c, _ = tiny("olmo2_7b.chat", dtype="float32")
    m = dict(c.config["model"], dtype="float32")
    tree = weights.make(dense_gqa.layout(m), 7, torch.device("cpu"))
    tokens = torch.randint(0, m["vocab_size"], (24,))
    want = torch.arange(24)
    exact = dense_gqa.logits(tree, m, tokens, want)
    low = dense_gqa.logits(tree, m, tokens, want, lowp="fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-2 < err < 0.5
    x = torch.randn(64, 32)
    q = dense_gqa._fp8(x, -1)
    assert torch.equal(q, dense_gqa._fp8(q, -1))       # already on the grid
    assert (q - x).abs().max() <= x.abs().max() * 2 ** -4
