"""Canonical Signed Digit (CSD) recoding — Section V of the paper.

The paper (Listing 1) recodes an unsigned integer's bit string into digits in
{-1, 0, +1} such that the total number of nonzero digits never increases, and
strictly decreases for any run ("chain") of >= 3 consecutive ones.  Chains of
exactly two ones are recoded with probability 1/2 ("we flip a coin ... since a
transformation of a length 2 chain has no benefit and no detriment") to balance
the positive/negative decomposition.

Two implementations live here:

* :func:`convert_to_csd` — a faithful, element-at-a-time port of the paper's
  Listing 1 (MSb-first bit list in, one-digit-wider MSb-first digit list out).
* :func:`csd_transform` — a vectorized NumPy state machine that applies the
  identical recoding to every element of an integer array at once (the per-bit
  scan is a loop of length ``width + 1``; everything else is array-parallel).

Both share the randomized length-2-chain tie-break; the vectorized version
consumes a ``numpy.random.Generator`` so the transform is reproducible.
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np

__all__ = [
    "convert_to_csd",
    "int_to_bits",
    "bits_to_int",
    "digits_to_int",
    "csd_digits",
    "csd_transform",
    "pn_from_digits",
    "nonzero_digit_count",
]


# ---------------------------------------------------------------------------
# Faithful port of the paper's Listing 1.
# ---------------------------------------------------------------------------
def convert_to_csd(num_bin_list: Sequence[int], rng: random.Random | None = None) -> List[int]:
    """Recode an MSb-first bit list into CSD digits (paper Listing 1).

    Args:
        num_bin_list: bits of an unsigned integer, most significant bit first.
        rng: source of the length-2-chain coin flip.  Defaults to the module
            ``random`` generator, matching ``random.getrandbits(1)`` in the
            paper's listing.

    Returns:
        Digit list in {-1, 0, 1}, MSb first, exactly one digit wider than the
        input (the paper: "the bit-width of the decomposition is one wider").
    """
    coin = (lambda: bool(rng.getrandbits(1))) if rng is not None else (
        lambda: bool(random.getrandbits(1)))

    local_list = list(num_bin_list)
    target = [0] * (len(local_list) + 1)
    local_list.reverse()  # process LSb -> MSb
    chain_start = -1  # are we in a chain?
    for i in range(len(target)):
        bit = local_list[i] if i < len(local_list) else 0
        if bit == 0:
            if chain_start == -1:  # no chain; nothing to be done here
                target[i] = 0
            else:
                # We terminate a chain; how long is it?
                chain_length = i - chain_start
                if chain_length == 1:  # leave it alone
                    target[chain_start] = 1
                elif chain_length == 2:  # a chain of two: coin flip
                    if coin():
                        target[chain_start] = -1  # do the substitution
                        target[i] = 1
                    else:
                        target[chain_start] = 1
                        target[i - 1] = 1
                else:  # length >= 3: will get benefit
                    target[chain_start] = -1
                    target[i] = 1
                chain_start = -1  # not in a chain anymore
        else:  # bit == 1
            if chain_start == -1:
                chain_start = i
    target.reverse()
    return target


# ---------------------------------------------------------------------------
# Bit/digit helpers.
# ---------------------------------------------------------------------------
def int_to_bits(value: int, width: int) -> List[int]:
    """Unsigned ``value`` as an MSb-first bit list of length ``width``."""
    if value < 0:
        raise ValueError("int_to_bits takes unsigned values; PN-split first")
    if value >= (1 << width):
        raise ValueError(f"{value} does not fit in {width} bits")
    return [(value >> (width - 1 - i)) & 1 for i in range(width)]


def bits_to_int(bits: Sequence[int]) -> int:
    """MSb-first bit list back to an unsigned integer."""
    out = 0
    for b in bits:
        out = (out << 1) | int(b)
    return out


def digits_to_int(digits: Sequence[int]) -> int:
    """MSb-first {-1,0,1} digit list to its signed integer value."""
    out = 0
    for d in digits:
        out = (out << 1) + int(d)
    return out


def csd_digits(value: int, width: int, rng: random.Random | None = None) -> List[int]:
    """CSD digits (MSb first, ``width + 1`` long) of an unsigned integer."""
    return convert_to_csd(int_to_bits(value, width), rng)


# ---------------------------------------------------------------------------
# Vectorized CSD over integer arrays.
# ---------------------------------------------------------------------------
def csd_transform(
    values: np.ndarray,
    width: int,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Apply the paper's CSD recoding to every element of an unsigned array.

    Runs the identical state machine as :func:`convert_to_csd`, but with the
    per-element state (``chain_start``) held in arrays so the scan over bit
    positions is the only Python loop.

    Args:
        values: array of unsigned integers, each < 2**width.
        width: input bit width.
        rng: generator for the length-2 coin flips (one flip per terminated
            length-2 chain, like the reference).  Defaults to a fixed seed so
            the transform is deterministic unless the caller opts out.

    Returns:
        int8 array of shape ``values.shape + (width + 1,)`` holding digits in
        {-1, 0, 1}, **LSb first** (index d = weight 2**d).
    """
    if rng is None:
        rng = np.random.default_rng(0)
    vals = np.asarray(values)
    if vals.size and (vals.min() < 0 or vals.max() >= (1 << width)):
        raise ValueError("values must be unsigned and fit in `width` bits")

    flat = vals.reshape(-1).astype(np.int64)
    n = flat.shape[0]
    target = np.zeros((n, width + 1), dtype=np.int8)
    chain_start = np.full(n, -1, dtype=np.int64)

    for i in range(width + 1):
        bit = ((flat >> i) & 1).astype(bool) if i < width else np.zeros(n, dtype=bool)
        in_chain = chain_start >= 0

        ends = (~bit) & in_chain          # chains terminating at this position
        starts = bit & (~in_chain)        # chains starting at this position

        if ends.any():
            idx = np.nonzero(ends)[0]
            length = i - chain_start[idx]
            cs = chain_start[idx]

            len1 = length == 1
            target[idx[len1], cs[len1]] = 1

            len2 = length == 2
            if len2.any():
                heads = rng.integers(0, 2, size=int(len2.sum())).astype(bool)
                i2 = idx[len2]
                c2 = cs[len2]
                # heads: substitute (-1 at LSb of chain, +1 one past MSb)
                target[i2[heads], c2[heads]] = -1
                target[i2[heads], i] = 1
                # tails: leave the original two ones
                target[i2[~heads], c2[~heads]] = 1
                target[i2[~heads], i - 1] = 1

            len3 = length >= 3
            target[idx[len3], cs[len3]] = -1
            target[idx[len3], i] = 1

            chain_start[idx] = -1

        chain_start[starts] = i

    return target.reshape(vals.shape + (width + 1,))


def pn_from_digits(digits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split an LSb-first digit array into unsigned (P, N) integer arrays.

    ``value = P - N`` where P collects the +1 digits and N the -1 digits
    (paper Eq. 6: V = P - N  =>  o = aT.P - aT.N).
    """
    weights = (1 << np.arange(digits.shape[-1], dtype=np.int64))
    pos = (digits > 0).astype(np.int64)
    neg = (digits < 0).astype(np.int64)
    return pos @ weights, neg @ weights


def nonzero_digit_count(digits: np.ndarray) -> int:
    """Total nonzero digits — the paper's hardware cost metric ("ones")."""
    return int(np.count_nonzero(digits))
