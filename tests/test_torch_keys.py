"""The port's host-side round keys equal JAX's ``fold_in`` words.

Every mask stream of the secure path is keyed on these words, so they
must match word for word (threefry2x32 is integer arithmetic).
"""
import jax
import numpy as np
import pytest

from repro_torch.fed import keys


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_round_keys_equal_jax_fold_in(seed):
    key = jax.random.key(seed + 10_000)
    want = np.stack([np.asarray(jax.random.key_data(jax.random.fold_in(key, t)))
                     for t in range(1, 51)])
    got = keys.round_keys(seed, 50)
    assert got.dtype == np.uint32 and got.shape == (50, 2)
    np.testing.assert_array_equal(got, want)


def test_key_words_equal_jax_key_data():
    for seed in (0, 1, 10_003, 2 ** 31 - 1):
        np.testing.assert_array_equal(
            keys.key_words(seed),
            np.asarray(jax.random.key_data(jax.random.key(seed))))


def test_fold_in_matches_jax_on_random_keys_and_data():
    rng = np.random.default_rng(0)
    for _ in range(8):
        kd = rng.integers(0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)
        data = rng.integers(0, 2 ** 32, size=16, dtype=np.uint64) \
            .astype(np.uint32)
        key = jax.random.wrap_key_data(kd)
        want = np.stack([np.asarray(jax.random.key_data(
            jax.random.fold_in(key, d))) for d in data])
        np.testing.assert_array_equal(keys.fold_in(kd, data), want)
