"""The port's data copies draw exactly the reference's arrays.

``repro_torch.data`` is a numpy copy of ``repro.data`` (the port may not
import the reference), so every draw must be ``np.array_equal``.
"""
import numpy as np
import pytest

from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn


@pytest.mark.parametrize("n_train,n_test,k,l,seed",
                         [(300, 50, 784, 10, 0), (200, 40, 37, 5, 7)])
def test_classification_dataset_equal(n_train, n_test, k, l, seed):
    ref = jsyn.classification_dataset(n_train, n_test, k=k, l=l, seed=seed)
    got = tsyn.classification_dataset(n_train, n_test, k=k, l=l, seed=seed)
    for a, b in zip(ref, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,clients,seed", [(2000, 10, 0), (101, 7, 5)])
def test_iid_equal(n, clients, seed):
    ref, got = jpart.iid(n, clients, seed), tpart.iid(n, clients, seed)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("clients,cohort,seed", [(10, 10, 0), (50, 7, 3)])
def test_sample_cohorts_equal(clients, cohort, seed):
    ids = np.arange(1, 9)
    np.testing.assert_array_equal(
        jpart.sample_cohorts(clients, cohort, ids, seed),
        tpart.sample_cohorts(clients, cohort, ids, seed))


@pytest.mark.parametrize("batch,with_cohorts", [(10, False), (30, True)])
def test_sample_schedule_equal(batch, with_cohorts):
    # 203 samples over 9 clients: uneven sizes, and with B=30 every client
    # (N_i = 22 or 23) takes the with-replacement branch
    part_ref, part_got = jpart.iid(203, 9, 1), tpart.iid(203, 9, 1)
    ids = np.arange(1, 6)
    cohorts = jpart.sample_cohorts(9, 4, ids, 2) if with_cohorts else None
    np.testing.assert_array_equal(
        jpart.sample_schedule(part_ref, batch, ids, 2, cohorts=cohorts),
        tpart.sample_schedule(part_got, batch, ids, 2, cohorts=cohorts))
