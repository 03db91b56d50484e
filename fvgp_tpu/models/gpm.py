"""GPm — multi-output GP regression on a (learned) smooth manifold
(parity target: the reference's unreleased /root/reference/dev/gpm.py:20,
whose coherent core is the multi-output trace-form marginal likelihood
``-(0.5·tr(KV⁻¹YYᵀ)) - (d/2)·log|KV| - (nd/2)·log 2π``; the rest of that
file is a commented-out sketch).

Accelerator-first formulation: the manifold is a trainable linear embedding
``z = x @ W`` (D → L) — the GP lives on the L-dimensional manifold
coordinates, all outputs share one kernel there, and the whole objective
(embedding, kernel assembly, Cholesky, trace-form LML) is ONE jitted
``jax.value_and_grad`` program over (W, hyperparameters, noise), optimized
with Adam.  With ``manifold_dim == D`` and ``W = I`` fixed this reduces to
a plain multi-output GP; with ``x_data=None`` the latent-variable case is
:class:`fvgp_tpu.models.gplvm.GPLVM`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .. import config
from ..kernels import default_matern_ard

__all__ = ["GPm"]


class GPm:
    """Multi-output GP on a learned linear manifold of the input space.

    Parameters
    ----------
    x_data : (N, D) inputs.
    y_data : (N, Q) outputs — all share the kernel on the manifold.
    manifold_dim : L, dimensionality of the manifold (default min(D, 2)).
    kernel_function : jnp kernel k(z1, z2, hps) on manifold coordinates;
        default anisotropic Matérn-3/2 ARD (hps = [var, l_1..l_L]).
    init_hyperparameters : default ones(L+1).
    noise : initial observation noise variance (learned in log space).
    train_embedding : if False, W stays at its (PCA-seeded) initial value.
    """

    def __init__(self, x_data, y_data, manifold_dim=None,
                 kernel_function=None, init_hyperparameters=None,
                 noise=1e-2, train_embedding=True):
        x = np.asarray(x_data, dtype=np.float64)
        y = np.asarray(y_data, dtype=np.float64)
        if x.ndim != 2:
            raise AssertionError("x_data must be (N, D)")
        if y.ndim == 1:
            y = y[:, None]
        if y.ndim != 2 or len(y) != len(x):
            raise AssertionError("y_data must be (N, Q) matching x_data")
        self.n, self.input_dim = x.shape
        self.q = y.shape[1]
        self.manifold_dim = int(manifold_dim or min(self.input_dim, 2))
        self.kernel = kernel_function or default_matern_ard
        self.train_embedding = bool(train_embedding)
        dtype = config.linalg_dtype(None)
        self._x = jnp.asarray(x, dtype=dtype)
        self._y_mean = y.mean(axis=0)
        self._y = jnp.asarray(y - self._y_mean, dtype=dtype)

        # PCA seed for the embedding: the leading input directions
        xc = x - x.mean(axis=0)
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        W0 = vt[: self.manifold_dim].T          # (D, L)
        if init_hyperparameters is None:
            init_hyperparameters = np.ones(self.manifold_dim + 1)
        self.W = jnp.asarray(W0, dtype=dtype)
        self.hyperparameters = np.asarray(init_hyperparameters,
                                          dtype=np.float64)
        self.log_noise = float(np.log(noise))
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        kernel, x, y = self.kernel, self._x, self._y
        n, q = self.n, self.q

        def neg_lml(params):
            W, log_hps, log_noise = params
            z = x @ W
            hps = jnp.exp(log_hps)
            K = kernel(z, z, hps)
            KV = K + jnp.exp(log_noise) * jnp.eye(n, dtype=K.dtype)
            L = jnp.linalg.cholesky(KV)
            alpha = jax.scipy.linalg.cho_solve((L, True), y)
            logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            trace_term = jnp.sum(y * alpha)     # tr(KV⁻¹ Y Yᵀ)
            return 0.5 * (q * logdet + trace_term
                          + n * q * jnp.log(2.0 * jnp.pi))

        self._neg_lml = jax.jit(neg_lml)
        self._neg_lml_vg = jax.jit(jax.value_and_grad(neg_lml))

    def _params(self):
        dtype = config.linalg_dtype(None)
        return (self.W,
                jnp.log(jnp.asarray(self.hyperparameters, dtype=dtype)),
                jnp.asarray(self.log_noise, dtype=dtype))

    def embed(self, x):
        """Manifold coordinates z = x @ W."""
        dtype = config.linalg_dtype(None)
        return np.asarray(jnp.asarray(np.asarray(x, dtype=np.float64),
                                      dtype=dtype) @ self.W)

    def log_likelihood(self):
        """Multi-output marginal log-likelihood at the current state
        (ref dev/gpm.py:313-321 trace form)."""
        return -float(self._neg_lml(self._params()))

    # ------------------------------------------------------------------
    def train(self, max_iter=500, learning_rate=1e-2, info=False):
        """Adam on the jitted value_and_grad over (W, hps, noise)."""
        params = self._params()
        optimizer = optax.adam(learning_rate)
        opt_state = optimizer.init(params)
        frozen_W = params[0]

        @jax.jit
        def step(params, opt_state):
            loss, grads = self._neg_lml_vg(params)
            updates, opt_state = optimizer.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        for it in range(int(max_iter)):
            params, opt_state, loss = step(params, opt_state)
            if not self.train_embedding:
                params = (frozen_W, params[1], params[2])
            if info and it % 50 == 0:
                print(f"GPm iter {it}: loss {float(loss):.4f}")
        W, log_hps, log_noise = params
        self.W = W
        self.hyperparameters = np.exp(np.asarray(log_hps))
        self.log_noise = float(log_noise)
        return self.hyperparameters

    # ------------------------------------------------------------------
    def _factor(self):
        dtype = config.linalg_dtype(None)
        hps = jnp.asarray(self.hyperparameters, dtype=dtype)
        z = self._x @ self.W
        K = self.kernel(z, z, hps)
        KV = K + np.exp(self.log_noise) * jnp.eye(self.n, dtype=dtype)
        return z, hps, jnp.linalg.cholesky(KV)

    def posterior_mean(self, x_pred):
        """(n_pred, Q) posterior mean — one shared multi-RHS solve."""
        z, hps, L = self._factor()
        zq = jnp.asarray(np.asarray(x_pred, dtype=np.float64),
                         dtype=z.dtype) @ self.W
        ks = self.kernel(z, zq, hps)
        alpha = jax.scipy.linalg.cho_solve((L, True), self._y)
        return np.asarray(ks.T @ alpha) + self._y_mean

    def __getstate__(self):
        """Checkpoint contract (ref pickling discipline, SURVEY.md §5):
        jitted closures are dropped and rebuilt on load; the custom kernel
        callable must itself be picklable (same contract as GPprior)."""
        state = dict(self.__dict__)
        state.pop("_neg_lml", None)
        state.pop("_neg_lml_vg", None)
        state["W"] = np.asarray(self.W)
        state["_x"] = np.asarray(self._x)
        state["_y"] = np.asarray(self._y)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        dtype = config.linalg_dtype(None)
        self.W = jnp.asarray(self.W, dtype=dtype)
        self._x = jnp.asarray(self._x, dtype=dtype)
        self._y = jnp.asarray(self._y, dtype=dtype)
        self._build()

    def posterior_variance(self, x_pred):
        """(n_pred,) posterior variance, shared across outputs."""
        z, hps, L = self._factor()
        zq = jnp.asarray(np.asarray(x_pred, dtype=np.float64),
                         dtype=z.dtype) @ self.W
        ks = self.kernel(z, zq, hps)
        kss = jnp.diagonal(self.kernel(zq, zq, hps))
        sol = jax.scipy.linalg.cho_solve((L, True), ks)
        v = kss - jnp.sum(ks * sol, axis=0)
        return np.asarray(jnp.clip(v, 0.0, None))
