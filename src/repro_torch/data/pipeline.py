"""Synthetic corpora and batching (the port's copy of
``repro/data/pipeline.py``; numpy only).

No external datasets are used: :class:`SyntheticMTTask` is a deterministic
"translation" whose target is the reversed source passed through an affine
token permutation, with variable sentence lengths, so a seq2seq model must
learn alignment (reversal) and a token mapping.  :class:`MTBatchIterator`
length-buckets sentences, pads them to the bucket ceiling and emits
fixed-shape batches, as OpenNMT does.  :class:`SyntheticLMTask` is a random
sparse Markov chain over the vocabulary (each token has ``branching``
successors with Zipf weights), so an LM's loss falls toward the chain's
entropy floor; :class:`LMBatchIterator` cuts it into fixed-shape next-token
batches.  The same seed gives the same arrays as the JAX package's
iterators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

PAD, BOS, EOS = 0, 1, 2
N_SPECIAL = 3


def pad_to(arr: np.ndarray, length: int, value: int = PAD) -> np.ndarray:
    out = np.full((len(arr), length), value, dtype=np.int32)
    for i, row in enumerate(arr):
        out[i, : len(row)] = row
    return out


# ---------------------------------------------------------------------------
# synthetic MT
# ---------------------------------------------------------------------------


@dataclass
class SyntheticMTTask:
    vocab_size: int
    min_len: int = 4
    max_len: int = 24
    seed: int = 0

    def _map_token(self, t: np.ndarray) -> np.ndarray:
        v = self.vocab_size - N_SPECIAL
        return (t - N_SPECIAL) * 7 % v + N_SPECIAL  # affine permutation (gcd(7, v) == 1 for our vocabs)

    def sample(self, rng: np.random.Generator, n: int):
        """Returns (src list, tgt list) of int32 arrays (no special tokens in
        src; tgt carries EOS)."""
        srcs, tgts = [], []
        for _ in range(n):
            L = int(rng.integers(self.min_len, self.max_len + 1))
            s = rng.integers(N_SPECIAL, self.vocab_size, size=L).astype(np.int32)
            t = self._map_token(s[::-1]).astype(np.int32)
            srcs.append(s)
            tgts.append(np.concatenate([t, [EOS]]).astype(np.int32))
        return srcs, tgts


@dataclass
class SyntheticLMTask:
    vocab_size: int
    branching: int = 32  # successors per state; smaller -> lower entropy floor
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        self._succ = rng.integers(0, v, size=(v, self.branching)).astype(np.int32)
        w = 1.0 / np.arange(1, self.branching + 1)  # Zipf-like successor weights
        self._probs = w / w.sum()

    def sample_tokens(self, rng: np.random.Generator, batch: int, seq_len: int) -> np.ndarray:
        """[batch, seq_len + 1] int32 walks of the chain."""
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch)
        for i in range(seq_len):
            choice = rng.choice(self.branching, size=batch, p=self._probs)
            toks[:, i + 1] = self._succ[toks[:, i], choice]
        return toks

    @property
    def entropy_floor(self) -> float:
        p = self._probs
        return float(-(p * np.log(p)).sum())


# ---------------------------------------------------------------------------
# batch iterators
# ---------------------------------------------------------------------------


class MTBatchIterator:
    """Length-bucketed MT batches: dict(src, tgt_in, tgt_out, src_mask, tgt_mask)."""

    def __init__(self, task: SyntheticMTTask, batch_size: int, seed: int = 0, buckets=(8, 16, 32)):
        self.task = task
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.buckets = buckets

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        srcs, tgts = self.task.sample(self.rng, self.batch_size)
        m = max(len(s) for s in srcs)
        n = max(len(t) for t in tgts)
        m = next((b for b in self.buckets if b >= m), m)
        n = next((b for b in self.buckets if b >= n), n)
        src = pad_to(srcs, m)
        tgt = pad_to(tgts, n)
        tgt_in = np.concatenate([np.full((len(tgt), 1), BOS, np.int32), tgt[:, :-1]], axis=1)
        return dict(
            src=src,
            tgt_in=tgt_in,
            tgt_out=tgt,
            src_mask=(src != PAD),
            tgt_mask=(tgt != PAD),
        )


class LMBatchIterator:
    """Fixed-shape LM batches: dict(tokens, labels, mask), labels the tokens
    shifted by one."""

    def __init__(self, task: SyntheticLMTask, batch_size: int, seq_len: int, seed: int = 0):
        self.task = task
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        toks = self.task.sample_tokens(self.rng, self.batch_size, self.seq_len)
        return dict(
            tokens=toks[:, :-1],
            labels=toks[:, 1:],
            mask=np.ones((self.batch_size, self.seq_len), bool),
        )
