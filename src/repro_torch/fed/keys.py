"""Per-round aggregation key words, computed on the host.

The reference derives round t's key as ``fold_in(key(seed + 10_000), t)``
under JAX's default threefry2x32 PRNG (``repro/fed/engine.py::
_round_keys``) and hands its two uint32 words to the mask PRF.  This
module reproduces those words exactly, in numpy ``uint32`` (which wraps
mod 2^32), without JAX: every mask stream of the port is keyed on them.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds, as in JAX: key (k0, k1) scalars, x0/x1
    uint32 arrays of one shape.  Returns (y0, y1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(block + 1) % 3]
        x[1] = x[1] + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x[0], x[1]


def key_words(seed: int) -> np.ndarray:
    """The words of ``jax.random.key(seed)``: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed={seed} outside [0, 2^31)")
    return np.asarray([0, seed], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``key_data(fold_in(key, d))`` for every d in ``data``: (len, 2)
    uint32.  fold_in hashes the counter pair (0, d) under the key."""
    d = np.atleast_1d(np.asarray(data, np.uint32))
    y0, y1 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1)


def round_keys(seed: int, rounds: int) -> np.ndarray:
    """(rounds, 2) uint32: row t−1 holds the key words of round t,
    ``fold_in(key(seed + 10_000), t)``."""
    return fold_in(key_words(seed + 10_000),
                   np.arange(1, rounds + 1, dtype=np.uint32))


def phase2_key(words) -> np.ndarray:
    """(2,) uint32 words of ``fold_in(round_key, 0x5EED)``: the key of the
    sketch's phase-2 mask stream, derived from the round's key by domain
    separation, so the one pair-seed exchange of a round covers both
    masked uploads."""
    return fold_in(np.asarray(words, np.uint32), 0x5EED)[0]
