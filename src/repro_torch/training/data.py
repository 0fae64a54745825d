"""Token data pipeline: deterministic synthetic corpus + optional text files.

The synthetic corpus is a mixture of Zipf-distributed unigrams with Markov
bigram structure, so small models show a real, monotonically-decreasing loss
(pure-uniform tokens would bottom out at ln(V) immediately).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    path: Optional[str] = None    # optional utf-8 text file (byte-level)


class TokenStream:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        if cfg.path:
            raw = open(cfg.path, "rb").read()
            self._corpus = np.frombuffer(raw, np.uint8).astype(np.int32)
            self._corpus = self._corpus % cfg.vocab_size
        else:
            self._corpus = None
            # Markov chain over a Zipfian vocabulary
            v = cfg.vocab_size
            self._zipf = (1.0 / np.arange(1, v + 1)) ** 1.1
            self._zipf /= self._zipf.sum()
            # each token deterministically prefers a few successors
            self._succ = self.rng.integers(0, v, size=(v, 4))

    def _synthetic_batch(self) -> np.ndarray:
        b, t, v = self.cfg.batch_size, self.cfg.seq_len, self.cfg.vocab_size
        out = np.empty((b, t), np.int32)
        cur = self.rng.choice(v, size=b, p=self._zipf)
        out[:, 0] = cur
        for i in range(1, t):
            # 70%: follow the Markov successor table; 30%: resample Zipf
            follow = self.rng.random(b) < 0.7
            pick = self._succ[cur, self.rng.integers(0, 4, size=b)]
            fresh = self.rng.choice(v, size=b, p=self._zipf)
            cur = np.where(follow, pick, fresh).astype(np.int32)
            out[:, i] = cur
        return out

    def _file_batch(self) -> np.ndarray:
        b, t = self.cfg.batch_size, self.cfg.seq_len
        n = len(self._corpus) - t - 1
        starts = self.rng.integers(0, n, size=b)
        return np.stack([self._corpus[s:s + t] for s in starts])

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield (self._file_batch() if self._corpus is not None
                   else self._synthetic_batch())
