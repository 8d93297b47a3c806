"""The one traffic generator: reads a mix's parameters from its data file.

A mix (``bench/traffic/<mix>.json``) says which entry it drives
(``"path"``: ``"engine"``, one closed-loop client calling
``ReservoirEngine.submit`` at batch 1), the request lengths
(``"lengths"``) and the input signal (``"signal"``).

Every seed gets the same lengths in another order: they are drawn in
blocks, each block a seeded permutation of the listed ``"values"``.
Any whole number of blocks then holds exactly the same work whatever the
seed, so the seed changes the order and the inputs, never the amount of
work.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PATHS", "Traffic", "block_lengths", "seed_words"]

PATHS = ("engine",)
SIGNAL_STEPS = 1 << 21       # one shared host signal per run; requests
#                              take seeded windows of it
_TAG = {"lengths": 1, "offsets": 3, "signal": 4, "sample": 5, "warm": 6}


def seed_words(seed: int, tag: str) -> list:
    """numpy seed words for one stream of a run: any whole number
    (negative or above 64 bits too) and a named stream."""
    s = int(seed)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, int(s < 0), _TAG[tag]]


def block_lengths(spec: dict) -> np.ndarray:
    """The lengths of one block, ascending: the mix's ``"values"``, which
    may list a length as often as its share asks."""
    if spec["dist"] != "values":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.sort(np.asarray(spec["values"], np.int64))


class _Blocks:
    """An endless sequence drawn block by block: each block a seeded
    permutation of ``values``."""

    def __init__(self, values: np.ndarray, words: list):
        self.values = values
        self.rng = np.random.default_rng(words)
        self.buf = np.empty(0, values.dtype)

    def __getitem__(self, k: int):
        while k >= len(self.buf):
            new = np.tile(self.values, (64, 1))
            self.buf = np.concatenate([self.buf,
                                       self.rng.permuted(new, axis=1).ravel()])
        return self.buf[k]


class Traffic:
    """Request ``k``'s length and inputs for one mix and seed."""

    def __init__(self, mix: dict, seed: int, in_dim: int):
        self.mix = mix
        self.seed = seed
        self.in_dim = in_dim
        self.path = mix["path"]
        if self.path not in PATHS:
            raise ValueError(f"unknown path {self.path!r}")
        self.block = block_lengths(mix["lengths"])
        self.max_len = int(self.block.max())
        self._lengths = _Blocks(self.block, seed_words(seed, "lengths"))
        sig = mix["signal"]
        if sig["dist"] != "uniform":
            raise ValueError(f"unknown signal {sig['dist']!r}")
        rng = np.random.default_rng(seed_words(seed, "signal"))
        self.signal = rng.uniform(float(sig["low"]), float(sig["high"]),
                                  (SIGNAL_STEPS + self.max_len, in_dim)
                                  ).astype(np.float32)
        self._offsets = np.random.default_rng(seed_words(seed, "offsets"))
        self._offset_buf: list = []

    def length(self, k: int) -> int:
        return int(self._lengths[k])

    def _offset(self, k: int) -> int:
        while k >= len(self._offset_buf):
            self._offset_buf.extend(
                self._offsets.integers(0, SIGNAL_STEPS, 4096).tolist())
        return self._offset_buf[k]

    def inputs(self, k: int) -> np.ndarray:
        """Request ``k``'s (T, I) inputs: a view of the run's signal."""
        o = self._offset(k)
        return self.signal[o:o + self.length(k)]

    def warm_requests(self, n: int) -> list:
        """``n`` set-up requests (inputs), the shortest and the longest
        length among them, drawn from a stream of their own."""
        vals = self.block
        rng = np.random.default_rng(seed_words(self.seed, "warm"))
        lens = [int(vals[0]), int(vals[-1])] + [
            int(v) for v in rng.choice(vals, max(0, n - 2))]
        offs = rng.integers(0, SIGNAL_STEPS, len(lens))
        return [self.signal[o:o + t] for o, t in zip(offs, lens)]
