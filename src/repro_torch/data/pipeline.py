"""Deterministic synthetic token pipeline — port of
``repro.data.pipeline`` (numpy only; batches byte-identical to the
reference's).

Documents are generated statelessly — token ``i`` of document ``d`` is a
hash of ``(seed, d, i)`` mixed with a per-document n-gram table so the
stream has learnable local structure (a pure-uniform stream gives a flat
loss; the smoke train tests assert the loss *decreases*).  The pipeline
shards deterministically across data-parallel ranks and yields
``{"tokens", "targets"}`` batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_docs: int = 1 << 20
    ngram_vocab: int = 512          # structure: docs draw from small LMs


class SyntheticCorpus:
    """Deterministic, indexable corpus of 'documents'."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        # a tiny global bigram model over a reduced alphabet, embedded into
        # the full vocab via per-document offset — cheap learnable structure
        V = cfg.ngram_vocab
        self._trans = rng.dirichlet(np.ones(V) * 0.1, size=V).astype(
            np.float64)
        self._trans_cdf = np.cumsum(self._trans, axis=1)

    def doc_tokens(self, doc: int, n: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + doc)
                                    % (2 ** 31 - 1))
        V = cfg.ngram_vocab
        offset = (doc * 7919) % max(cfg.vocab_size - V, 1)
        out = np.empty(n, np.int32)
        s = rng.randint(V)
        us = rng.random_sample(n)
        for i in range(n):
            s = int(np.searchsorted(self._trans_cdf[s], us[i]))
            s = min(s, V - 1)
            out[i] = offset + s
        return out


class DataIterator:
    """Sharded batch iterator: rank r of R sees rows r, r+R, ..."""

    def __init__(self, cfg: DataConfig, rank: int = 0, world: int = 1):
        assert cfg.global_batch % world == 0
        self.cfg = cfg
        self.rank = rank
        self.world = world
        self.local_batch = cfg.global_batch // world
        self.corpus = SyntheticCorpus(cfg)
        self._step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        for b in range(self.local_batch):
            gid = self._step * cfg.global_batch + self.rank \
                + b * self.world
            doc = gid % cfg.n_docs
            rows.append(self.corpus.doc_tokens(doc, cfg.seq_len + 1))
        self._step += 1
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].astype(np.int32),
                "targets": arr[:, 1:].astype(np.int32)}

    def state(self):
        return {"step": self._step}

    def restore(self, state):
        self._step = int(state["step"])
