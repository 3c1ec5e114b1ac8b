"""glibc-compatible pseudo-random generator.

The reference seeds libc with ``srand(0)`` and draws synthetic observations
via ``rand()`` (tests/gridder_common.cpp:88; app/common/init.cpp). This is
glibc's default ``rand()`` (the TYPE_3 additive-feedback generator with lags
3/31), so the port's synthetic observations are draw-for-draw identical with
the reference binaries and with ``idg_tpu.crand``.
"""

from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFFFFFF


class CRand:
    """glibc ``rand()``: TYPE_3 trinomial x^31 + x^3 + 1 additive generator."""

    def __init__(self, seed: int = 0):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed = seed & _MASK32
        if seed == 0:
            seed = 1
        if seed >= 0x80000000:
            # glibc stores the unsigned seed into an int32_t state word and
            # the LCG below reads it back SIGNED with C's truncating / and %.
            seed -= 0x100000000
        r = [0] * 34
        r[0] = seed
        # Park-Miller LCG seeding of the state table, computed without
        # overflow exactly as glibc does (C division truncates toward zero).
        for i in range(1, 31):
            word = r[i - 1]
            q = abs(word) // 127773
            hi = q if word >= 0 else -q
            lo = word - hi * 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        self._state = r
        # Warm-up: discard the first 310 outputs.
        for _ in range(310):
            self._next()

    def _next(self) -> int:
        r = self._state
        val = (r[-31] + r[-3]) & _MASK32
        r.append(val)
        del r[0]
        return val >> 1

    def rand(self) -> int:
        """One draw in [0, 2^31 - 1], identical to glibc ``rand()``."""
        return self._next()

    def uniform(self) -> float:
        """``(double)rand() / RAND_MAX`` as the reference computes it."""
        return self.rand() / 2147483647.0

    def rand_array(self, n: int) -> np.ndarray:
        """n consecutive draws as an int64 array."""
        nxt = self._next
        return np.fromiter((nxt() for _ in range(n)), dtype=np.int64, count=n)

    def uniform_array(self, n: int) -> np.ndarray:
        return self.rand_array(n).astype(np.float64) / 2147483647.0


def make_rng(seed: int = 0):
    """The fastest glibc-rand stream here: the native one
    (idg_tpu_torch.native, built with g++ at first use) where it builds, else
    the pure-Python CRand above. Both draw the identical sequence
    (tests/test_torch_native.py), as idg_tpu.crand.make_rng's do."""
    from . import native

    if native.available():
        return native.NativeRand(seed)
    return CRand(seed)
