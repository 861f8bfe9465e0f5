"""Traffic: a mix is a data file ``perfbench/traffic/<mix>.json`` of
parameters, read by the generator module its ``generator`` key names
(``perfbench/generators/<kind>.py``).

Every seed of a mix gets the same multiset of request shapes (prompt and
output lengths, shared-prefix choices, inter-arrival gaps): they are drawn
once from the mix's own ``shape_seed``.  The run's ``--seed`` orders them
and draws every token id, over the whole vocabulary, so two seeds do the
same work in another order and on other tokens.
"""
from __future__ import annotations

import importlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


@dataclass
class BenchRequest:
    """One request as the benchmark offers it."""
    rid: int
    due: float                # seconds after the schedule's origin
    tokens: np.ndarray        # prompt token ids, int32
    max_new: int
    warm: bool = False        # submitted at the start of set-up


def load(name: str) -> Dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def lengths(spec: Dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` lengths from ``spec``: ``lognormal`` (``median``, ``sigma``)
    or ``uniform``, both clipped to ``min``..``max`` inclusive."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = np.exp(np.log(spec["median"]) + spec["sigma"]
                   * rng.standard_normal(n))
        return np.clip(np.rint(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


@dataclass
class Shapes:
    """A fixed multiset of request shapes: prompt length (the unique part
    when prompts share prefixes), output length, prefix index (-1: none)."""
    prompt: np.ndarray
    output: np.ndarray
    prefix: np.ndarray


def draw_shapes(mix: Dict, n: int, rng: np.random.Generator) -> Shapes:
    prompt = lengths(mix["prompt"], rng, n)
    output = lengths(mix["output"], rng, n)
    pre = mix.get("prefix")
    if pre:
        w = 1.0 / np.arange(1, pre["count"] + 1) ** pre["zipf_s"]
        prefix = rng.choice(pre["count"], size=n, p=w / w.sum())
    else:
        prefix = np.full(n, -1)
    return Shapes(prompt, output, prefix)


class Tokens:
    """Token ids of one run, drawn from its seed: the shared prefixes once,
    every unique part as it is asked for."""

    def __init__(self, mix: Dict, vocab: int, rng: np.random.Generator):
        self.vocab, self.rng = vocab, rng
        pre = mix.get("prefix")
        self.prefixes = ([self.draw(pre["tokens"]) for _ in range(pre["count"])]
                         if pre else [])

    def draw(self, n: int) -> np.ndarray:
        return self.rng.integers(0, self.vocab, n).astype(np.int32)

    def prompt(self, prefix: int, n: int) -> np.ndarray:
        own = self.draw(n)
        if prefix < 0:
            return own
        return np.concatenate([self.prefixes[prefix], own])


def length_biased(output: np.ndarray, rng: np.random.Generator,
                  n: int) -> np.ndarray:
    """Indices of ``n`` shapes drawn with probability proportional to their
    output length: the requests a steady state holds in flight."""
    p = output / output.sum()
    return rng.choice(output.size, size=n, p=p)


def source(mix: Dict, vocab: int, seed: int, horizon_s: float,
           rate: Optional[float] = None):
    """The mix's request source over ``horizon_s`` seconds of schedule
    (``rate`` overrides the mix's own, for a sweep)."""
    kind = importlib.import_module(f"perfbench.generators.{mix['generator']}")
    return kind.Source(mix, vocab, seed, horizon_s, rate)

