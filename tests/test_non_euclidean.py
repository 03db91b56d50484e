"""Non-Euclidean input spaces: arbitrary Python objects as points, host
Gram-matrix kernels feeding device linalg (ref tests/test_fvgp.py:5462-5566,
BASELINE config 3)."""

import warnings

import numpy as np
import pytest

from fvgp_tpu import GP, fvGP

warnings.simplefilter("ignore")


def _string_kernel(x1, x2, hps):
    """Gram matrix over strings: k = hps[0] * exp(-edit-ish distance)."""
    K = np.empty((len(x1), len(x2)))
    for i, a in enumerate(x1):
        for j, b in enumerate(x2):
            d = abs(len(a) - len(b)) + sum(
                c1 != c2 for c1, c2 in zip(a, b))
            K[i, j] = np.exp(-d / hps[1])
    return hps[0] * K


WORDS = ["gaussian", "process", "kernel", "matern", "wendland", "gpu",
         "pallas", "mesh", "shard", "jit"]
Y = np.array([float(len(w)) for w in WORDS])


def test_non_euclidean_gp():
    gp = GP(WORDS, Y, init_hyperparameters=np.array([1.0, 4.0]),
            kernel_function=_string_kernel)
    assert not gp.data.Euclidean
    assert gp.index_set_dim == 1
    lml = gp.log_likelihood()
    assert np.isfinite(lml)
    res = gp.posterior_mean(["gauss", "proc"])
    assert res["m(x)"].shape == (2,)
    cov = gp.posterior_covariance(["gauss", "proc"])
    assert cov["v(x)"].shape == (2,)


def test_non_euclidean_requires_kernel():
    with pytest.raises(Exception):
        GP(WORDS, Y, init_hyperparameters=np.array([1.0, 4.0]))


def test_non_euclidean_train_mcmc():
    gp = GP(WORDS, Y, init_hyperparameters=np.array([1.0, 4.0]),
            kernel_function=_string_kernel)
    before = gp.log_likelihood()
    bounds = np.array([[0.1, 20.0], [0.5, 20.0]])
    gp.train(method="mcmc", hyperparameter_bounds=bounds, max_iter=200)
    assert gp.log_likelihood() >= before - 1.0


def test_non_euclidean_update_data():
    gp = GP(WORDS[:7], Y[:7], init_hyperparameters=np.array([1.0, 4.0]),
            kernel_function=_string_kernel)
    gp.update_gp_data(WORDS[7:], Y[7:], append=True, rank_n_update=False)
    assert gp.data.point_number == 10
    gp_fresh = GP(WORDS, Y, init_hyperparameters=np.array([1.0, 4.0]),
                  kernel_function=_string_kernel)
    assert abs(gp.log_likelihood() - gp_fresh.log_likelihood()) < 1e-7


def test_non_euclidean_multitask():
    """fvGP over object points: index-set entries are [object, task] pairs
    (ref fvgp.py:609)."""
    y2 = np.stack([Y, Y * 0.5], axis=1)

    def pair_kernel(x1, x2, hps):
        K = np.empty((len(x1), len(x2)))
        for i, (a, ta) in enumerate(x1):
            for j, (b, tb) in enumerate(x2):
                d = abs(len(a) - len(b)) + sum(c1 != c2 for c1, c2 in zip(a, b))
                K[i, j] = np.exp(-d / hps[1]) * np.exp(-abs(ta - tb) / hps[2])
        return hps[0] * K

    f = fvGP(WORDS, y2, init_hyperparameters=np.array([1.0, 4.0, 1.0]),
             kernel_function=pair_kernel)
    assert f.data.point_number == 20
    assert np.isfinite(f.log_likelihood())
    res = f.posterior_mean(["gauss"], x_out=np.array([0.0, 1.0]))
    assert res["m(x)"].shape == (1, 2)


@pytest.mark.slow
def test_gp2Scale_with_non_euclidean_object_points():
    """Arbitrary (ragged) object points through the distributed sparse path:
    the block-sparse assembly must equal the direct dense evaluation, and
    posteriors/appends must work (parity with ref
    tests/test_fvgp.py:5538-5566)."""
    rng = np.random.default_rng(0)
    letters = "abcdefghij"
    x = [[letters[i % 10]] * (1 + i % 3) for i in range(30)]   # ragged
    y = rng.random(30)

    def compact_kernel(x1, x2, hps):
        d = np.zeros((len(x1), len(x2)))
        for i, a in enumerate(x1):
            for j, b in enumerate(x2):
                d[i, j] = 0.0 if a[0] == b[0] else 2.0
        d[d > 1.0] = 1.0
        return hps[0] * (1.0 - d) ** 8 * (32.0 * d ** 3 + 25.0 * d ** 2
                                          + 8.0 * d + 1.0)

    hps = np.array([1.0, 0.5])
    gp = GP(x, y, init_hyperparameters=hps, gp2Scale=True,
            gp2Scale_batch_size=10, kernel_function=compact_kernel,
            args={"gp2Scale_block_size": 8})
    from fvgp_tpu.parallel.block_sparse import is_block_sparse
    assert is_block_sparse(gp.prior.K)
    # the distributed assembly equals the direct evaluation
    np.testing.assert_allclose(np.asarray(gp.prior.K.to_dense()),
                               compact_kernel(x, x, hps), atol=1e-12)

    assert np.isfinite(gp.log_likelihood())
    pm = gp.posterior_mean([["a"], ["b", "b"]])["m(x)"]
    assert np.all(np.isfinite(pm))
    pv = gp.posterior_covariance([["a"], ["b", "b"]])["v(x)"]
    assert np.all(np.asarray(pv) >= 0.0)

    gp.update_gp_data([["z", "z", "z"]], np.array([0.5]), append=True)
    assert len(gp.x_data) == 31 and gp.prior.K.shape == (31, 31)
    assert np.isfinite(gp.log_likelihood())
