"""Deterministic, resumable data pipeline, the port of
``repro.data.pipeline`` (NumPy only: batches are bitwise the reference's).

SyntheticLMData produces a reproducible token stream (batch i is a pure
function of (seed, i): a NumPy ``RandomState`` seeded from both) so that
(a) restarts resume exactly via the step cursor stored in the checkpoint
and (b) every DP shard can generate its own slice without a central
reader, the same property a real sharded webdataset reader provides,
minus the disk.  A mixed power-law unigram + repeated-ngram structure
gives the loss something learnable.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    ngram: int = 8          # repeated-block period (learnable structure)


class SyntheticLMData:
    """Stateless batch generator with an explicit cursor (checkpointable)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @staticmethod
    def restore(cfg: DataConfig, state: dict) -> "SyntheticLMData":
        assert state["seed"] == cfg.seed, "data seed mismatch on restore"
        return SyntheticLMData(cfg, start_step=int(state["step"]))

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % 2**31)
        # power-law unigram distribution (zipf-ish), stable across steps
        ranks = np.arange(1, cfg.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        base = rng.choice(cfg.vocab, size=(cfg.global_batch, cfg.seq_len + 1),
                          p=probs)
        # inject repeated n-grams: second half of each period repeats first
        g = cfg.ngram
        for r in range(0, cfg.seq_len + 1 - 2 * g, 4 * g):
            base[:, r + g: r + 2 * g] = base[:, r: r + g]
        tokens = base[:, :-1].astype(np.int32)
        labels = base[:, 1:].astype(np.int32)
        return tokens, labels

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        out = self.batch_at(self.step)
        self.step += 1
        return out

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self


def tsp_batch_stream(n: int, batch: int, seed: int = 0
                     ) -> Iterator[np.ndarray]:
    """Stream of random TSP coordinate batches (ACO serving workload)."""
    i = 0
    while True:
        rng = np.random.RandomState(seed * 7919 + i)
        yield rng.uniform(0, 1000.0, size=(batch, n, 2))
        i += 1
