"""One module per kind of model; a configuration names its own in its
``reference`` key.  Each gives ``check_port_config(cfg, m)``,
``layout(m)`` (the weight leaves the benchmark draws), ``flops(m, rows,
context_sum, logit_rows)`` and the plain PyTorch reference ``logits(...)``,
and imports nothing of the program."""
from __future__ import annotations

import importlib


def load(kind: str):
    return importlib.import_module(f"perfbench.references.{kind}")
