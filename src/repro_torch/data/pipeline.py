"""Deterministic, splittable synthetic data pipeline (the JAX package's
``data/pipeline.py``, numpy only, copied as it is: a batch here is the
JAX package's batch bit for bit).

Every batch is a pure function of (seed, step, host) — the property that
makes restart/straggler handling coordination-free: a replacement host
resumes mid-epoch by recomputing exactly the shards it owns, and skipping a
straggler's shard reassigns it deterministically.  A real deployment swaps
``synthetic_batch`` for a tokenized-shard reader keyed the same way.

Over a world of ``D x M`` ranks a batch's rows go to the data axis only
(``repro_torch.train.steps.batch_rows``): rank ``r`` of the data axis
takes rows ``[r B/D, (r+1) B/D)``, and the ``M`` model ranks of a data
group take the same rows.

The generator is a tiny LCG-mixed ngram sampler rather than uniform noise so
train loss actually decreases in the end-to-end example (quickstart trains a
~100M model a few hundred steps on it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def synthetic_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Run-length token stream (copy-structure): tokens repeat in runs of
    ~2-16, 5% noise.  A small LM drops loss quickly by learning to copy,
    so the end-to-end example demonstrably trains.  Deterministic in
    (seed, step, host)."""
    per_host = cfg.global_batch // cfg.n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    B, S, V = per_host, cfg.seq_len, cfg.vocab
    n_runs = S // 2 + 2
    run_tok = rng.integers(0, V, size=(B, n_runs))
    run_len = rng.integers(2, 17, size=(B, n_runs))
    seq = np.zeros((B, S + 1), dtype=np.int32)
    for b in range(B):
        reps = np.repeat(run_tok[b], run_len[b])
        seq[b] = reps[: S + 1]
    noise = rng.random((B, S + 1)) < 0.05
    seq = np.where(noise, rng.integers(0, V, size=(B, S + 1)), seq)
    seq = seq.astype(np.int32)
    return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


def make_batches(cfg: DataConfig, start_step: int = 0) -> Iterator:
    step = start_step
    while True:
        yield step, synthetic_batch(cfg, step)
        step += 1
