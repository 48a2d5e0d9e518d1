"""Synthetic MNIST stand-in (the container is offline; MNIST is unavailable).

Copies of ``repro/data/synthetic.py::classification_dataset`` and
``token_dataset`` (numpy only), so the port trains on exactly the
reference's data.  The classification set mirrors the paper's MNIST
setup in all shape respects (N=60000 train / 10000 test, K=784 features
in [0,1], L=10 classes) and is learnable: each class is a smooth random
prototype image plus structured low-rank variation plus pixel noise.
The token set feeds the LM tasks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Classification(NamedTuple):
    x_train: np.ndarray  # (N, K) float32 in [0, 1]
    y_train: np.ndarray  # (N, L) one-hot float32
    x_test: np.ndarray
    y_test: np.ndarray


def classification_dataset(n_train: int = 60000, n_test: int = 10000,
                           k: int = 784, l: int = 10, rank: int = 16,
                           noise: float = 0.9, sparsify: float = 0.6,
                           seed: int = 0):
    """``sparsify``: fraction of pixels clipped to exactly 0 (MNIST has
    ~80% background zeros and mean ≈ 0.13; matching that sparsity keeps the
    paper's τ = 0.1 / stepsize tunings in their stable regime)."""
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(k)) if int(np.sqrt(k)) ** 2 == k else None

    # Smooth class prototypes: low-frequency random fields.
    protos = rng.normal(size=(l, k)).astype(np.float32)
    if side:
        xs = np.linspace(0, 1, side)
        gx, gy = np.meshgrid(xs, xs)
        basis = np.stack([np.sin((i + 1) * np.pi * gx) *
                          np.cos((j + 1) * np.pi * gy)
                          for i in range(4) for j in range(4)], -1)
        coef = rng.normal(size=(l, basis.shape[-1])).astype(np.float32)
        protos = (coef @ basis.reshape(-1, basis.shape[-1]).T).astype(np.float32)
    protos /= np.abs(protos).max(axis=1, keepdims=True) + 1e-9

    # Per-class low-rank variation directions.
    var_dirs = rng.normal(size=(l, rank, k)).astype(np.float32) / np.sqrt(k)

    def make(n, rng):
        ys = rng.integers(0, l, size=n)
        coefs = rng.normal(size=(n, rank)).astype(np.float32)
        x = protos[ys] + np.einsum('nr,nrk->nk', coefs, var_dirs[ys])
        x = x + noise * rng.normal(size=(n, k)).astype(np.float32)
        x = (x - x.min()) / (x.max() - x.min() + 1e-9)   # into [0,1] like MNIST
        y = np.zeros((n, l), np.float32)
        y[np.arange(n), ys] = 1.0
        return x.astype(np.float32), y

    x_tr, y_tr = make(n_train, rng)
    x_te, y_te = make(n_test, rng)
    if sparsify:
        thr = np.quantile(x_tr, sparsify)
        scale = x_tr.max() - thr + 1e-9
        x_tr = np.clip((x_tr - thr) / scale, 0.0, 1.0).astype(np.float32)
        x_te = np.clip((x_te - thr) / scale, 0.0, 1.0).astype(np.float32)
    return Classification(x_tr, y_tr, x_te, y_te)


def token_dataset(n_docs: int, seq_len: int, vocab: int, seed: int = 0):
    """Zipf-distributed token ids, (n_docs, seq_len) int32 (a power-law
    unigram distribution, so embedding gradients are realistically
    skewed)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    return rng.choice(vocab, size=(n_docs, seq_len), p=probs).astype(np.int32)
