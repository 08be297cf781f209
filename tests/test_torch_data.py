"""The port's data pipeline (a numpy copy of the JAX package's
``data/pipeline.py``): the JAX package's batches bit for bit, for one host
and for each of two hosts, and its determinism and splitting."""
import numpy as np
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import make_batches as jax_make_batches
from repro.data import synthetic_batch as jax_synthetic_batch

from repro_torch.data import DataConfig, make_batches, synthetic_batch


@pytest.mark.parametrize("n_hosts", [1, 2])
@pytest.mark.parametrize("step", [0, 7, 123])
def test_synthetic_batch_matches_reference(n_hosts, step):
    for host in range(n_hosts):
        kw = dict(vocab=512, seq_len=33, global_batch=8, seed=3,
                  n_hosts=n_hosts, host_id=host)
        got = synthetic_batch(DataConfig(**kw), step)
        want = jax_synthetic_batch(JaxDataConfig(**kw), step)
        assert got.keys() == want.keys() == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            assert got[k].shape == (8 // n_hosts, 33)
            np.testing.assert_array_equal(got[k], want[k])


def test_data_pipeline_deterministic_and_splittable():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=8)
    b1, b2 = synthetic_batch(cfg, 7), synthetic_batch(cfg, 7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    h0 = synthetic_batch(DataConfig(vocab=100, seq_len=16, global_batch=8,
                                    n_hosts=2, host_id=0), 7)
    h1 = synthetic_batch(DataConfig(vocab=100, seq_len=16, global_batch=8,
                                    n_hosts=2, host_id=1), 7)
    assert h0["tokens"].shape == h1["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_make_batches_matches_reference():
    kw = dict(vocab=64, seq_len=8, global_batch=2)
    mine, theirs = make_batches(DataConfig(**kw), 5), \
        jax_make_batches(JaxDataConfig(**kw), 5)
    for _ in range(3):
        (s1, b1), (s2, b2) = next(mine), next(theirs)
        assert s1 == s2
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
