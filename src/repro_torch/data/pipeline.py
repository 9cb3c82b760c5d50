"""Token data pipeline: deterministic, checkpointable, host-sharded.

A copy of ``repro.data.pipeline`` (numpy only): the same batches for the
same seed, cursor and corpus.

``TokenPipeline`` yields fixed-shape (tokens, labels) batches.  State is a
single integer cursor → trivially checkpointable and restorable (exactly
what restart-after-failure needs).  Sources:

  - ``synthetic``   — seeded LCG token stream (tests, dry-runs, benches).
  - ``walk``        — C-SAW random-walk corpus (data/walk_corpus.py): the
    paper's engine is the data plane (DESIGN.md §4).

On a real fleet each host loads ``host_shard`` of every batch; here
host_count=1 and the full batch is produced locally.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class PipelineState:
    cursor: int = 0
    epoch: int = 0


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        corpus: Optional[np.ndarray] = None,  # (N, seq_len+1) pre-tokenized
        host_index: int = 0,
        host_count: int = 1,
    ):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.corpus = corpus
        self.host_index = host_index
        self.host_count = host_count
        self.state = PipelineState()
        assert batch % host_count == 0

    # -- checkpoint integration --------------------------------------------
    def state_dict(self) -> dict:
        return {"cursor": self.state.cursor, "epoch": self.state.epoch}

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState(int(d["cursor"]), int(d["epoch"]))

    # -- batches -------------------------------------------------------------
    def _synthetic_batch(self, cursor: int) -> np.ndarray:
        # counter-based: batch i is a pure function of (seed, cursor)
        rng = np.random.default_rng((self.seed, cursor))
        return rng.integers(
            0, self.vocab_size, (self.batch, self.seq_len + 1), dtype=np.int32
        )

    def next(self) -> dict:
        per_host = self.batch // self.host_count
        if self.corpus is not None:
            n = self.corpus.shape[0]
            idx = (self.state.cursor * self.batch + np.arange(self.batch)) % n
            seqs = self.corpus[idx]
            if self.state.cursor * self.batch // max(n, 1) > self.state.epoch:
                self.state.epoch += 1
        else:
            seqs = self._synthetic_batch(self.state.cursor)
        self.state.cursor += 1
        lo = self.host_index * per_host
        seqs = seqs[lo : lo + per_host]
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:].astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()
