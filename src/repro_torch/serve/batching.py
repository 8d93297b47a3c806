"""Request batching with padding buckets.

Variable-length rollout requests are grouped into jit-friendly shapes:
sequence lengths are padded up to a small set of bucket lengths and batches
are padded up to bucket sizes, so the engine compiles one program per
(bucket_len, bucket_batch) pair instead of one per request shape.  Padding
is always at the *end* of the time axis — the reservoir recurrence is
causal, so a request's first T real states are unaffected by padded steps.

The bucketer is deliberately generic over "a sequence of per-step inputs":
the reservoir engine batches (T, input_dim) float sequences, and the LM
serving example reuses the same bucketer for token prompts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

DEFAULT_LEN_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


@dataclasses.dataclass
class RolloutRequest:
    """One serving request: roll ``inputs`` (T, input_dim) through the ESN.

    ``x0`` optionally seeds the reservoir state for this request (shape
    (reservoir_dim,)); ``None`` means the zero state.  The continuous
    scheduler uses the same field to resume a sequence from its carried
    state mid-stream.
    """

    uid: Any
    inputs: np.ndarray
    x0: np.ndarray | None = None

    @property
    def length(self) -> int:
        return int(self.inputs.shape[0])


@dataclasses.dataclass
class MicroBatch:
    """A padded group of requests sharing one compiled shape."""

    requests: list
    inputs: np.ndarray            # (batch_padded, len_padded, input_dim)
    lengths: list
    pad_value: float = 0.0
    x0: np.ndarray | None = None  # (batch_padded, reservoir_dim) or None

    @property
    def real_steps(self) -> int:
        return int(sum(self.lengths))

    @property
    def padded_steps(self) -> int:
        return int(self.inputs.shape[0] * self.inputs.shape[1])


class PaddingBucketer:
    """Groups requests into padded microbatches over static bucket shapes."""

    def __init__(self,
                 len_buckets: Sequence[int] = DEFAULT_LEN_BUCKETS,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS):
        assert len_buckets and batch_buckets
        self.len_buckets = tuple(sorted(len_buckets))
        self.batch_buckets = tuple(sorted(batch_buckets))

    def pad_len(self, t: int) -> int:
        for b in self.len_buckets:
            if t <= b:
                return b
        top = self.len_buckets[-1]
        return ((t + top - 1) // top) * top

    def pad_batch(self, b: int) -> int:
        for bb in self.batch_buckets:
            if b <= bb:
                return bb
        # beyond the top bucket: round *up* to a multiple of it (mirrors
        # pad_len) — padding down would hand a direct caller a buffer
        # smaller than the batch.
        top = self.batch_buckets[-1]
        return ((b + top - 1) // top) * top

    @property
    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def group(self, requests: Sequence[RolloutRequest]) -> list:
        """Sort by length, group by length bucket, chunk by max batch, pad."""
        by_bucket: dict = {}
        for req in sorted(requests, key=lambda r: r.length):
            by_bucket.setdefault(self.pad_len(req.length), []).append(req)
        batches = []
        for tpad, group in sorted(by_bucket.items()):
            for lo in range(0, len(group), self.max_batch):
                chunk = group[lo:lo + self.max_batch]
                bpad = self.pad_batch(len(chunk))
                feat = chunk[0].inputs.shape[1:]
                buf = np.zeros((bpad, tpad) + feat,
                               dtype=np.asarray(chunk[0].inputs).dtype)
                for j, req in enumerate(chunk):
                    buf[j, :req.length] = req.inputs
                x0 = None
                if any(r.x0 is not None for r in chunk):
                    dim = next(np.asarray(r.x0).shape[-1] for r in chunk
                               if r.x0 is not None)
                    x0 = np.zeros((bpad, dim), np.float32)
                    for j, req in enumerate(chunk):
                        if req.x0 is not None:
                            x0[j] = req.x0
                batches.append(MicroBatch(
                    requests=list(chunk), inputs=buf,
                    lengths=[r.length for r in chunk], x0=x0))
        return batches
