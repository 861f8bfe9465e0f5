"""Synthetic data pipeline with a host-side byte-rate throttle.

The throttle is the framework's analogue of the paper's cgroup ``io.max``
guardrail: a bandwidth-heavy data-loading tenant (the T2 "ETL" class) can
be capped to N bytes/s, which the controller applies for bounded windows
(paper §2.4: "I/O throttles use cgroup io.max with bounded windows").
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class PipelineStats:
    batches: int = 0
    bytes_read: int = 0
    throttle_sleeps: float = 0.0


class SyntheticTokenPipeline:
    """Deterministic synthetic LM batches (tokens + next-token labels)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, bytes_per_s_cap: Optional[float] = None,
                 frontend: Optional[dict] = None):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        self.bytes_per_s_cap = bytes_per_s_cap
        self.frontend = frontend or {}
        self.stats = PipelineStats()
        self._window_start = time.perf_counter()
        self._window_bytes = 0.0

    def set_throttle(self, bytes_per_s: Optional[float]) -> None:
        """Controller guardrail hook (cgroup io.max analogue)."""
        self.bytes_per_s_cap = bytes_per_s

    def _account(self, nbytes: int) -> None:
        self.stats.bytes_read += nbytes
        if self.bytes_per_s_cap is None:
            return
        self._window_bytes += nbytes
        elapsed = time.perf_counter() - self._window_start
        required = self._window_bytes / self.bytes_per_s_cap
        if required > elapsed:
            sleep = required - elapsed
            self.stats.throttle_sleeps += sleep
            time.sleep(min(sleep, 0.25))
        if elapsed > 1.0:
            self._window_start = time.perf_counter()
            self._window_bytes = 0.0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        toks = self.rng.integers(0, self.vocab_size,
                                 (self.batch, self.seq_len + 1),
                                 dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        nbytes = toks.nbytes
        kind = self.frontend.get("kind")
        if kind == "vision":
            p, e = self.frontend["num_prefix"], self.frontend["embed_dim"]
            emb = self.rng.standard_normal((self.batch, p, e)).astype(np.float32)
            # text region shrinks so total positions == seq_len
            batch["tokens"] = batch["tokens"][:, : self.seq_len - p]
            batch["labels"] = batch["labels"][:, : self.seq_len - p]
            batch["embeds"] = emb
            nbytes += emb.nbytes
        elif kind == "audio":
            e = self.frontend["embed_dim"]
            frames = self.rng.standard_normal(
                (self.batch, self.seq_len, e)).astype(np.float32)
            batch["frames"] = frames
            nbytes += frames.nbytes
        self._account(nbytes)
        self.stats.batches += 1
        return batch
