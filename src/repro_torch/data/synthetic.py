"""Deterministic synthetic corpus with learnable structure.

The port needs no dataset files on disk, so calibration, preprocessing and PPL evaluation run on a mixture of Zipfian
bigram processes: each "document" samples a latent topic which selects a
bigram transition table over a Zipf-distributed vocabulary.  The process
has real mutual information between adjacent tokens, so cross-entropy
deltas between FP and quantized models are meaningful (a collapsed model
regresses to the unigram entropy, a good model approaches the bigram
entropy).

Everything is a pure function of (seed, split) — reproducible across
hosts, shardable by slicing the document index space (host i of H reads
documents ≡ i mod H), no files.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class CorpusConfig:
    vocab: int = 2048
    n_topics: int = 8
    branch: int = 24          # out-degree of each bigram row
    zipf_a: float = 1.2
    seed: int = 1234


class SyntheticCorpus:
    """Topic-mixture Zipfian bigram language."""

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, t, b = cfg.vocab, cfg.n_topics, cfg.branch
        # per-topic bigram tables: for each token, `branch` successors with
        # Zipf weights (sparse representation -> cheap sampling)
        self.succ = rng.integers(0, v, size=(t, v, b), dtype=np.int32)
        w = 1.0 / np.arange(1, b + 1) ** cfg.zipf_a
        self.succ_p = (w / w.sum()).astype(np.float64)
        # Zipfian unigram start distribution
        uw = 1.0 / np.arange(1, v + 1) ** cfg.zipf_a
        self.start_p = uw / uw.sum()

    def document(self, doc_id: int, length: int) -> np.ndarray:
        rng = np.random.default_rng((self.cfg.seed, doc_id))
        topic = rng.integers(0, self.cfg.n_topics)
        toks = np.empty(length, np.int32)
        toks[0] = rng.choice(self.cfg.vocab, p=self.start_p)
        branches = rng.choice(self.cfg.branch, size=length - 1, p=self.succ_p)
        tbl = self.succ[topic]
        for i in range(1, length):
            toks[i] = tbl[toks[i - 1], branches[i - 1]]
        return toks

    def batches(self, batch: int, seq: int, n_batches: int, *,
                split: str = "train", host: int = 0, n_hosts: int = 1
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield (tokens, targets) (B,S) int32.  Deterministic per (split,
        batch index); hosts read disjoint document ids (data sharding)."""
        base = {"train": 0, "valid": 10_000_000, "calib": 20_000_000}[split]
        for i in range(n_batches):
            docs = []
            for j in range(batch):
                doc_id = base + (i * batch + j) * n_hosts + host
                docs.append(self.document(doc_id, seq + 1))
            arr = np.stack(docs)
            yield arr[:, :-1].copy(), arr[:, 1:].copy()

    def bigram_ceiling_ppl(self, n: int = 20000) -> float:
        """Entropy of the generating bigram process ≈ best achievable PPL."""
        h = -np.sum(self.succ_p * np.log(self.succ_p))
        return float(np.exp(h))


def calibration_set(corpus: SyntheticCorpus, n_segments: int = 128,
                    seq: int = 2048, batch: int = 1):
    """The paper's calibration protocol: 128 random 2048-token segments
    (WikiText2 there, synthetic here), batch size 1."""
    return list(corpus.batches(batch, seq, n_segments // batch, split="calib"))
