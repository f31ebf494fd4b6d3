"""Seeds of every stream of a run, derived from ``--seed`` alone."""

from __future__ import annotations

_MASK = (1 << 64) - 1


def derive(seed: int, *path: int) -> int:
    """A 63-bit seed for the stream `path` of `seed` (splitmix64 steps), so
    any whole number, however large, gives independent streams."""
    z = int(seed) & _MASK
    for p in path:
        z = (z + (int(p) + 1) * 0x9E3779B97F4A7C15) & _MASK
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        z ^= z >> 31
    return z & ((1 << 63) - 1)


# stream names: one integer each
WEIGHTS, DATA, NOISE, INDEX, CHECK = range(5)
