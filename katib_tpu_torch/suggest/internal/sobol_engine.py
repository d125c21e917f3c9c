"""Scrambled Sobol' sequence in NumPy — the same stream, bit for bit, as
``scipy.stats.qmc.Sobol(d, scramble=True, seed=seed)`` (scipy's default 30
bits), which the JAX package's Sobol search draws from.

- Direction numbers: Bratley and Fox's recurrence (Algorithm 659, ACM TOMS
  14(1), 1988) from each dimension's primitive polynomial and initial
  numbers, then each column scaled by its power of two.
- Scrambling: a left linear matrix scramble plus a digital shift (LMS+shift,
  Matoušek 1998; Owen 1998), drawn from ``numpy.random.default_rng(seed)``
  in scipy's order: the shift's bits first, then lower-triangular binary
  matrices, one per dimension.
- Drawing: the Gray-code update, XOR of the direction number at the lowest
  zero bit of the point's index, scaled by 2^-30. Skipping ahead jumps to
  the point the updates would reach: the shift XOR the direction numbers
  at the set bits of the index's Gray code.

The direction table ``sobol_direction_numbers.npz`` (``poly`` [21201] and
``vinit`` [21201, 18]) holds S. Joe and F. Y. Kuo's ``new-joe-kuo-6.21201``
numbers (search criterion D(6); "Constructing Sobol sequences with better
two-dimensional projections", SIAM J. Sci. Comput. 30(5), 2008;
https://web.maths.unsw.edu.au/~fkuo/sobol/), copyright 2008 Frances Y. Kuo
and Stephen Joe under a BSD-style licence, in the form scipy ships them
(``scipy/stats/_sobol_direction_numbers.npz``, BSD-3-Clause). A missing or
unreadable table raises: there is no fallback sequence.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np

BITS = 30  # scipy's default: at most 2**30 points
MAXDIM = 21201
MAXDEG = 18
TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sobol_direction_numbers.npz")


@functools.lru_cache(maxsize=1)
def direction_table() -> Tuple[np.ndarray, np.ndarray]:
    """(poly [MAXDIM], vinit [MAXDIM, MAXDEG]) from the carried table."""
    with np.load(TABLE, allow_pickle=False) as table:
        poly, vinit = table["poly"], table["vinit"]
    if poly.shape != (MAXDIM,) or vinit.shape != (MAXDIM, MAXDEG):
        raise ValueError(f"{TABLE}: poly {poly.shape}, vinit {vinit.shape}; "
                         f"expected ({MAXDIM},) and ({MAXDIM}, {MAXDEG})")
    return poly, vinit


def direction_numbers(d: int) -> np.ndarray:
    """The unscrambled direction numbers [d, BITS] (uint32), column ``j``
    scaled by 2**(BITS - 1 - j)."""
    poly, vinit = direction_table()
    poly = poly[:d].astype(np.int64)
    v = np.zeros((d, BITS), dtype=np.uint64)
    v[:, :MAXDEG] = vinit[:d]
    v[0] = 1  # the first dimension's numbers are all 1
    degree = np.array([int(p).bit_length() - 1 for p in poly], dtype=np.int64)
    rows = np.arange(d)
    for j in range(BITS):
        grow = (j >= degree) & (rows > 0)  # below its degree a row keeps vinit
        if not grow.any():
            continue
        newv = v[rows, np.clip(j - degree, 0, None)]
        for k in range(min(j, MAXDEG)):  # a growing row has k < degree <= j
            coeff = (k < degree) & (((poly >> np.clip(degree - 1 - k, 0, None)) & 1) == 1)
            newv ^= np.where(coeff, v[:, j - k - 1] << np.uint64(k + 1), np.uint64(0))
        v[grow, j] = newv[grow]
    v <<= np.arange(BITS - 1, -1, -1, dtype=np.uint64)
    return v.astype(np.uint32)


def _scramble(sv: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """(shift [d], scrambled direction numbers [d, BITS]) by LMS+shift."""
    d = sv.shape[0]
    shift = np.dot(rng.integers(2, size=(d, BITS), dtype=np.uint32), 2 ** np.arange(BITS, dtype=np.uint32))
    ltm = np.tril(rng.integers(2, size=(d, BITS, BITS), dtype=np.uint32)).astype(np.int64)
    ltm[:, np.arange(BITS), np.arange(BITS)] = 1
    # bit p (from the top) of a scrambled number is the parity of row p of
    # the matrix, read as a number with its first column highest, AND the
    # number's bits
    lrev = ltm[:, :, ::-1]  # [d, p, k]: row p's bit k
    vbits = ((sv.astype(np.int64)[:, :, None] >> np.arange(BITS)) & 1)  # [d, j, k]
    parity = np.einsum("dpk,djk->djp", lrev, vbits) & 1
    scrambled = (parity << np.arange(BITS - 1, -1, -1)).sum(axis=-1)
    return shift.astype(np.uint32), scrambled.astype(np.uint32)


def _low_zero_bits(start: int, n: int) -> np.ndarray:
    """The 0-based position of the lowest zero bit of start, ..., start+n-1."""
    idx = np.arange(start, start + n, dtype=np.int64)
    lowest_zero = ~idx & (idx + 1)  # the lowest zero bit as a power of two
    return np.log2(lowest_zero).astype(np.int64)


class SobolEngine:
    """``scipy.stats.qmc.Sobol(d, scramble=True, seed=seed)``: ``random``
    and ``fast_forward`` give scipy's points for the same calls."""

    def __init__(self, d: int, seed=None):
        if not 0 <= d <= MAXDIM:
            raise ValueError(f"Maximum supported dimensionality is {MAXDIM}.")
        self.d = d
        self.maxn = 2 ** BITS
        self._scale = 1.0 / 2 ** BITS
        self._shift, self._sv = _scramble(direction_numbers(d), np.random.default_rng(seed))
        self._quasi = self._shift.copy()
        self.num_generated = 0

    def _draw(self, n: int, index: int, out: np.ndarray) -> None:
        """n Gray-code updates of the current point from ``index``, each
        point written to ``out``."""
        if n <= 0:
            return
        steps = self._sv[:, _low_zero_bits(index, n)].T  # [n, d]
        points = np.bitwise_xor.accumulate(steps, axis=0) ^ self._quasi
        self._quasi = points[-1].copy()
        out[:] = points * self._scale

    def random(self, n: int = 1) -> np.ndarray:
        """The next n points [n, d] in [0, 1)."""
        sample = np.empty((n, self.d), dtype=np.float64)
        if n == 0:
            return sample
        total = self.num_generated + n
        if total > self.maxn:
            raise ValueError(f"At most 2**{BITS}={self.maxn} distinct points can be generated. "
                             f"{self.num_generated} points have been previously generated, then: "
                             f"n={self.num_generated}+{n}={total}. Consider increasing `bits`.")
        if self.num_generated == 0:
            sample[0] = self._quasi * self._scale  # the first point is the shift
            self._draw(n - 1, 0, sample[1:])
        else:
            self._draw(n, self.num_generated - 1, sample)
        self.num_generated += n
        return sample

    def fast_forward(self, n: int) -> "SobolEngine":
        """Skip n points. Like scipy, when nothing has been drawn yet the
        current point is the first one, so n - 1 updates reach the last
        skipped point."""
        if n <= 0:
            return self
        last = self.num_generated + n - 1  # the index of the last skipped point
        gray = last ^ (last >> 1)
        self._quasi = self._shift ^ np.bitwise_xor.reduce(
            self._sv[:, [b for b in range(BITS) if gray >> b & 1]], axis=1, initial=np.uint32(0))
        self.num_generated += n
        return self
