"""Synthetic translation corpus and batching (the port's copy of the MT half
of ``repro/data/pipeline.py``; numpy only).

No external datasets are used: :class:`SyntheticMTTask` is a deterministic
"translation" whose target is the reversed source passed through an affine
token permutation, with variable sentence lengths, so a seq2seq model must
learn alignment (reversal) and a token mapping.  :class:`MTBatchIterator`
length-buckets sentences, pads them to the bucket ceiling and emits
fixed-shape batches, as OpenNMT does.  The same seed gives the same arrays as
the JAX package's iterator.
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
