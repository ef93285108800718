"""The reference's deterministic PRNG, bit for bit (copy of
``lightgbm_tpu/utils/ref_random.py``; reference ``LightGBM::Random``,
include/LightGBM/utils/random.h:95-113): the 214013/2531011 LCG that
DART's drop sets draw from (dart.hpp:97-130), so a DART run drops the
same trees as the JAX package and the reference CLI."""

from __future__ import annotations


class RefRandom:
    """uint32 LCG: x = 214013 * x + 2531011."""

    def __init__(self, seed: int = 123456789):
        self.x = int(seed) & 0xFFFFFFFF

    def rand_int16(self) -> int:
        self.x = (214013 * self.x + 2531011) & 0xFFFFFFFF
        return (self.x >> 16) & 0x7FFF

    def rand_int32(self) -> int:
        self.x = (214013 * self.x + 2531011) & 0xFFFFFFFF
        return self.x & 0x7FFFFFFF

    def next_float(self) -> float:
        """Random::NextFloat: a 15-bit draw scaled to [0, 1)."""
        return self.rand_int16() / 32768.0

    def next_short(self, lo: int, hi: int) -> int:
        return self.rand_int16() % (hi - lo) + lo

    def next_int(self, lo: int, hi: int) -> int:
        return self.rand_int32() % (hi - lo) + lo
