"""GPLVM — Gaussian-process latent-variable model
(parity target: the reference's unreleased /root/reference/dev/gplvm.py — a
1394-line fork of the GP class where the latent coordinates live inside the
hyperparameter vector; not packaged in the reference wheel either).

GPU-first formulation: the latent coordinates ARE parameters.  The whole
objective — kernel assembly over the latent X, Cholesky, the multi-output
marginal likelihood — is one jitted ``jax.value_and_grad`` program over
(X, hyperparameters, noise).  The reference's dev version threads
hand-written gradients through its GP object graph; here latent learning
needs no gradient machinery because autodiff differentiates through the
factorization.

Surface parity with the reference fork (dev/gplvm.py:419 ``train`` dispatch,
``:674`` ``log_likelihood(hyperparameters)``, ``:735-1100`` posterior suite
at latent coordinates):

* ``train(method=...)`` dispatches ``adam`` (joint latents+hps, the
  accelerator-first default), ``local`` (joint L-BFGS-B on the same jitted
  value_and_grad), ``mcmc`` (adaptive-Metropolis over the hyperparameter
  vector via :class:`~fvgp_tpu.models.gp_mcmc.gpMCMC`, updating
  ``mcmc_info``), or a user callable.
* ``hyperparameter_bounds`` boxes the vector ``[kernel hps..., noise]``;
  defaults mirror the reference's data-derived bounds.
* The posterior suite — mean/covariance (+grads), joint prior, entropy,
  KL divergence, mutual information — evaluates at NEW latent coordinates.

Documented deviation from the reference fork: the latent coordinates are
point-estimated (they are parameters of the jitted objective), so the
``hyperparameters`` vector here is ``[kernel hps..., noise variance]``
rather than the reference's latents-inside-hyperparameters encoding.
``train(method='mcmc', sample_latent=True)`` recovers the reference
behavior (the flattened latents are appended to the sampled vector).

Model: Y (N, Q) observed; X (N, L) latent;  KV = k(X, X) + noise·I;
LML = -0.5 [ Q·log|KV| + tr(KV⁻¹ Y Yᵀ) + N·Q·log 2π ] - 0.5‖X‖²
(the last term is the standard-normal latent prior fixing the scale gauge).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .. import config
from ..kernels import default_matern_ard

__all__ = ["GPLVM"]


class GPLVM:
    """Latent-variable GP: learns an (N, latent_dim) embedding of
    high-dimensional observations by maximizing the multi-output marginal
    likelihood.

    Parameters
    ----------
    y_data : (N, Q) observations.
    latent_dim : dimensionality L of the latent space.
    kernel_function : jnp kernel k(x1, x2, hps); default anisotropic
        Matérn-3/2 ARD over the latent space (hps = [var, l_1..l_L]).
    init_latent : (N, L) initial embedding; default PCA of y_data
        (the reference's ``initalizer`` seed, dev/gplvm.py:153).
    init_hyperparameters : default ones(L+1).
    noise : observation noise variance (learned in log space).
    args : optional dict, carried for parity (unused by the default path).
    """

    def __init__(self, y_data, latent_dim=2, kernel_function=None,
                 init_latent=None, init_hyperparameters=None, noise=1e-2,
                 args=None):
        y = np.asarray(y_data, dtype=np.float64)
        if y.ndim != 2:
            raise AssertionError("y_data must be (N, Q)")
        self.n, self.q = y.shape
        self.latent_dim = int(latent_dim)
        self.kernel = kernel_function or default_matern_ard
        self.args = dict(args) if args else {}
        dtype = config.linalg_dtype(None)
        self._y_mean = y.mean(axis=0)
        self._y = jnp.asarray(y - self._y_mean, dtype=dtype)

        if init_latent is None:
            # PCA initialization (the standard GPLVM seed)
            yc = y - self._y_mean
            _, _, vt = np.linalg.svd(yc, full_matrices=False)
            init_latent = yc @ vt[: self.latent_dim].T
            init_latent /= max(init_latent.std(), 1e-12)
        if init_hyperparameters is None:
            init_hyperparameters = np.ones(self.latent_dim + 1)
        self.X = jnp.asarray(init_latent, dtype=dtype)
        self.hyperparameters = np.asarray(init_hyperparameters,
                                          dtype=np.float64)
        self.log_noise = float(np.log(noise))
        self._mcmc_info = None
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        kernel = self.kernel
        y = self._y
        n, q = self.n, self.q

        def neg_lml(params):
            X, log_hps, log_noise = params
            hps = jnp.exp(log_hps)
            K = kernel(X, X, hps)
            KV = K + jnp.exp(log_noise) * jnp.eye(n, dtype=K.dtype)
            L = jnp.linalg.cholesky(KV)
            alpha = jax.scipy.linalg.cho_solve((L, True), y)
            logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            quad = jnp.sum(y * alpha)
            # a standard-normal prior on X regularizes the embedding scale
            prior = 0.5 * jnp.sum(X * X)
            return 0.5 * (q * logdet + quad
                          + n * q * jnp.log(2 * jnp.pi)) + prior

        self._neg_lml_vg = jax.jit(jax.value_and_grad(neg_lml))
        self._neg_lml = jax.jit(neg_lml)

    def _params(self):
        dtype = config.linalg_dtype(None)
        return (self.X,
                jnp.log(jnp.asarray(self.hyperparameters, dtype=dtype)),
                jnp.asarray(self.log_noise, dtype=dtype))

    # -- hyperparameter-vector convention: [kernel hps..., noise variance] --
    def get_hyperparameters(self):
        """The committed vector ``[kernel hps..., noise variance]``
        (ref dev/gplvm.py:639)."""
        return np.append(self.hyperparameters, np.exp(self.log_noise))

    def set_hyperparameters(self, hps):
        """Commit a ``[kernel hps..., noise variance]`` vector
        (ref dev/gplvm.py:313)."""
        hps = np.asarray(hps, dtype=np.float64)
        if len(hps) != len(self.hyperparameters) + 1:
            raise AssertionError(
                f"expected {len(self.hyperparameters) + 1} entries "
                "([kernel hps..., noise variance])")
        if np.any(hps <= 0.0):
            raise AssertionError("hyperparameters must be positive")
        self.hyperparameters = hps[:-1]
        self.log_noise = float(np.log(hps[-1]))

    def _params_from_theta(self, theta, X=None):
        dtype = config.linalg_dtype(None)
        theta = np.asarray(theta, dtype=np.float64)
        X = self.X if X is None else jnp.asarray(X, dtype=dtype)
        return (X, jnp.log(jnp.asarray(theta[:-1], dtype=dtype)),
                jnp.asarray(np.log(theta[-1]), dtype=dtype))

    def log_likelihood(self, hyperparameters=None):
        """Multi-output marginal log-likelihood; optional
        ``[kernel hps..., noise]`` override (ref dev/gplvm.py:674)."""
        params = (self._params() if hyperparameters is None
                  else self._params_from_theta(hyperparameters))
        return -float(self._neg_lml(params))

    def neg_log_likelihood_gradient(self, hyperparameters=None):
        """Gradient of the negative LML w.r.t. ``[kernel hps..., noise]``
        at fixed latents (ref dev/gplvm.py:695) — exact autodiff, chained
        through the log-space parameterization."""
        theta = (self.get_hyperparameters() if hyperparameters is None
                 else np.asarray(hyperparameters, dtype=np.float64))
        params = self._params_from_theta(theta)
        _, (_, g_lh, g_ln) = self._neg_lml_vg(params)
        # d/dtheta = d/dlog(theta) / theta
        return np.append(np.asarray(g_lh), float(g_ln)) / theta

    def test_log_likelihood_gradient(self, hyperparameters=None,
                                     epsilon=1e-6):
        """FD-vs-analytic self-test (ref dev/gplvm.py:713)."""
        theta = (self.get_hyperparameters() if hyperparameters is None
                 else np.asarray(hyperparameters, dtype=np.float64))
        analytic = self.neg_log_likelihood_gradient(theta)
        fd = np.zeros_like(theta)
        for i in range(len(theta)):
            up, dn = theta.copy(), theta.copy()
            up[i] += epsilon
            dn[i] -= epsilon
            fd[i] = (-self.log_likelihood(up)
                     + self.log_likelihood(dn)) / (2.0 * epsilon)
        return analytic, fd

    @property
    def mcmc_info(self):
        """Convergence/distribution record of the last ``method='mcmc'``
        training (ref dev/gplvm.py:273)."""
        return self._mcmc_info

    def _get_default_hyperparameter_bounds(self):
        """Data-derived box for ``[kernel hps..., noise]``
        (ref dev/gplvm.py:391): signal variance from the output variance,
        length scales around the unit-scaled latent embedding, noise
        between 1e-6 and the output variance."""
        y_var = max(float(np.var(np.asarray(self._y))), 1e-8)
        n_hps = len(self.hyperparameters)
        bounds = np.empty((n_hps + 1, 2))
        bounds[0] = [y_var * 1e-2, y_var * 1e2]
        bounds[1:n_hps] = [1e-2, 1e2]
        bounds[-1] = [1e-6, y_var]
        return bounds

    # ------------------------------------------------------------------
    def train(self, method="adam", hyperparameter_bounds=None, max_iter=None,
              tolerance=1e-4, learning_rate=1e-2, info=False,
              sample_latent=False, n_chains=1):
        """Train the latent embedding and/or hyperparameters
        (ref dev/gplvm.py:419 dispatch).

        Parameters
        ----------
        method : 'adam' | 'local' | 'mcmc' | callable
            * ``adam`` (default): joint Adam over (latents, kernel hps,
              noise) — one jitted value_and_grad program per step.
            * ``local``: joint L-BFGS-B over the same flattened parameter
              vector (scipy minimize driving the jitted program); the
              hyperparameter box applies in log space, latents unbounded.
            * ``mcmc``: adaptive Metropolis over ``[kernel hps..., noise]``
              at fixed latents; ``sample_latent=True`` appends the
              flattened latents (the reference-fork encoding).  Updates
              ``mcmc_info``; commits the MAP sample.
            * callable: receives this GPLVM, returns a
              ``[kernel hps..., noise]`` vector to commit.
        hyperparameter_bounds : (H+1, 2) box for ``[kernel hps..., noise]``
            (``local``/``mcmc`` only); default derived from the data.
        max_iter : iteration budget (default 500 adam / 200 local /
            2000 mcmc).
        tolerance : local-optimizer termination tolerance.
        learning_rate : adam step size.
        sample_latent : mcmc only — include the latents in the sampled
            vector (N·L extra dimensions; reference-fork behavior).
        n_chains : mcmc only — independent chains (best MAP wins).

        Returns the learned (N, L) latent coordinates for ``adam``/
        ``local`` (the quantity of interest), the committed
        ``[kernel hps..., noise]`` vector for ``mcmc``/callables.
        """
        if isinstance(method, (int, float)) and not isinstance(method, bool):
            # legacy positional call train(max_iter[, learning_rate]) from
            # the pre-dispatch signature: keep it working as adam
            if max_iter is None:
                max_iter = int(method)
            if isinstance(hyperparameter_bounds, float):
                learning_rate = hyperparameter_bounds
                hyperparameter_bounds = None
            method = "adam"
        if callable(method):
            result = method(self)
            if result is not None:
                self.set_hyperparameters(np.asarray(result))
            return self.get_hyperparameters()
        if method == "adam":
            return self._train_adam(
                max_iter=500 if max_iter is None else int(max_iter),
                learning_rate=learning_rate, info=info)
        if method == "local":
            return self._train_local(
                hyperparameter_bounds,
                max_iter=200 if max_iter is None else int(max_iter),
                tolerance=tolerance, info=info)
        if method == "mcmc":
            return self._train_mcmc(
                hyperparameter_bounds,
                max_iter=2000 if max_iter is None else int(max_iter),
                sample_latent=sample_latent, n_chains=n_chains, info=info)
        raise ValueError(f"unknown training method '{method}' "
                         "(adam | local | mcmc | callable)")

    def _train_adam(self, max_iter, learning_rate, info):
        params = self._params()
        optimizer = optax.adam(learning_rate)
        opt_state = optimizer.init(params)

        @jax.jit
        def step(params, opt_state):
            loss, grads = self._neg_lml_vg(params)
            updates, opt_state = optimizer.update(grads, opt_state)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        loss = None
        for it in range(int(max_iter)):
            params, opt_state, loss = step(params, opt_state)
            if info and (it % 50 == 0):
                print(f"GPLVM iter {it}: loss {float(loss):.4f}")
        X, log_hps, log_noise = params
        self.X = X
        self.hyperparameters = np.exp(np.asarray(log_hps))
        self.log_noise = float(log_noise)
        return np.asarray(self.X)

    def _train_local(self, hyperparameter_bounds, max_iter, tolerance, info):
        """Joint L-BFGS-B on the flattened (X, log hps, log noise) vector;
        the jitted value_and_grad is the oracle (ref dev/gplvm.py:419
        method='local' → scipy minimize)."""
        from scipy.optimize import minimize

        if hyperparameter_bounds is None:
            hyperparameter_bounds = self._get_default_hyperparameter_bounds()
        hyperparameter_bounds = np.asarray(hyperparameter_bounds,
                                           dtype=np.float64)
        n_lat = self.n * self.latent_dim
        n_hps = len(self.hyperparameters)
        if hyperparameter_bounds.shape != (n_hps + 1, 2):
            raise AssertionError(
                f"hyperparameter_bounds must be ({n_hps + 1}, 2) "
                "([kernel hps..., noise])")

        x0 = np.concatenate([np.asarray(self.X).ravel(),
                             np.log(self.hyperparameters),
                             [self.log_noise]])
        bounds = ([(None, None)] * n_lat
                  + list(np.log(hyperparameter_bounds)))
        dtype = config.linalg_dtype(None)

        def split(v):
            X = jnp.asarray(v[:n_lat].reshape(self.n, self.latent_dim),
                            dtype=dtype)
            return (X, jnp.asarray(v[n_lat:-1], dtype=dtype),
                    jnp.asarray(v[-1], dtype=dtype))

        def fun(v):
            val, (gX, gh, gn) = self._neg_lml_vg(split(v))
            grad = np.concatenate([np.asarray(gX).ravel(),
                                   np.asarray(gh), [float(gn)]])
            return float(val), grad

        res = minimize(fun, x0, jac=True, method="L-BFGS-B", bounds=bounds,
                       tol=tolerance, options={"maxiter": int(max_iter)})
        if info:
            print(f"GPLVM local training: {res.message}, "
                  f"loss {res.fun:.4f}, nit {res.nit}")
        X, log_hps, log_noise = split(res.x)
        self.X = X
        self.hyperparameters = np.exp(np.asarray(log_hps))
        self.log_noise = float(log_noise)
        return np.asarray(self.X)

    def _train_mcmc(self, hyperparameter_bounds, max_iter, sample_latent,
                    n_chains, info):
        """Adaptive Metropolis over the hyperparameter vector via gpMCMC
        (ref dev/gplvm.py:419 method='mcmc'); commits the MAP sample."""
        from .gp_mcmc import gpMCMC

        if hyperparameter_bounds is None:
            hyperparameter_bounds = self._get_default_hyperparameter_bounds()
        bounds = np.asarray(hyperparameter_bounds, dtype=np.float64)
        n_hps = len(self.hyperparameters)
        if bounds.shape != (n_hps + 1, 2):
            raise AssertionError(
                f"hyperparameter_bounds must be ({n_hps + 1}, 2) "
                "([kernel hps..., noise])")
        theta0 = np.clip(self.get_hyperparameters(),
                         bounds[:, 0], bounds[:, 1])
        n_lat = self.n * self.latent_dim
        if sample_latent:
            # reference-fork encoding: latents inside the sampled vector;
            # the standard-normal latent prior bounds them at ±5 sigma
            bounds = np.vstack([np.tile([-5.0, 5.0], (n_lat, 1)), bounds])
            theta0 = np.concatenate([np.asarray(self.X).ravel(), theta0])

        def loglik(theta, args=None):
            if sample_latent:
                X = theta[:n_lat].reshape(self.n, self.latent_dim)
                params = self._params_from_theta(theta[n_lat:], X=X)
            else:
                params = self._params_from_theta(theta)
            return -float(self._neg_lml(params))

        best_theta, best_f, last_info = None, -np.inf, None
        for chain in range(max(1, int(n_chains))):
            sampler = gpMCMC(loglik, bounds=bounds)
            x0 = theta0 if chain == 0 else np.random.uniform(
                bounds[:, 0], bounds[:, 1])
            out = sampler.run_mcmc(x0=np.asarray(x0, dtype=np.float64),
                                   n_updates=int(max_iter), info=info)
            last_info = out
            if float(out["MAP"]) > best_f:
                best_f = float(out["MAP"])
                best_theta = np.asarray(out["max x"], dtype=np.float64)
        self._mcmc_info = last_info
        if sample_latent:
            dtype = config.linalg_dtype(None)
            self.X = jnp.asarray(
                best_theta[:n_lat].reshape(self.n, self.latent_dim),
                dtype=dtype)
            best_theta = best_theta[n_lat:]
        self.set_hyperparameters(best_theta)
        return self.get_hyperparameters()

    # ------------------------------------------------------------------
    def __getstate__(self):
        """Checkpoint contract: jitted closures drop and rebuild on load."""
        state = dict(self.__dict__)
        state.pop("_neg_lml", None)
        state.pop("_neg_lml_vg", None)
        state["X"] = np.asarray(self.X)
        state["_y"] = np.asarray(self._y)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        dtype = config.linalg_dtype(None)
        self.X = jnp.asarray(self.X, dtype=dtype)
        self._y = jnp.asarray(self._y, dtype=dtype)
        self._build()

    # ------------------------------------------------------------------
    @property
    def latent_coordinates(self):
        return np.asarray(self.X)

    def _committed(self, x_latent=None):
        """(Xq, k(X, Xq), KV Cholesky, alpha) at the committed state."""
        dtype = config.linalg_dtype(None)
        Xq = (self.X if x_latent is None
              else jnp.asarray(np.asarray(x_latent, dtype=np.float64),
                               dtype=dtype))
        if Xq.ndim != 2 or Xq.shape[1] != self.latent_dim:
            raise AssertionError(
                f"x_latent must be (n, {self.latent_dim})")
        hps = jnp.asarray(self.hyperparameters, dtype=dtype)
        K = self.kernel(self.X, self.X, hps) \
            + np.exp(self.log_noise) * jnp.eye(self.n, dtype=dtype)
        ks = self.kernel(self.X, Xq, hps)
        L = jnp.linalg.cholesky(K)
        alpha = jax.scipy.linalg.cho_solve((L, True), self._y)
        return Xq, ks, L, alpha

    # -- posterior suite at latent coordinates (ref dev/gplvm.py:735-1100) --
    def posterior_mean(self, x_pred=None):
        """Posterior mean of all Q outputs at latent positions
        (ref dev/gplvm.py:735); default = the training embedding."""
        Xq, ks, _, alpha = self._committed(x_pred)
        m = np.asarray(ks.T @ alpha) + self._y_mean
        return {"x": np.asarray(Xq), "m(x)": m}

    def posterior_mean_grad(self, x_pred, direction=None):
        """d posterior-mean / d latent coordinate — exact autodiff
        (ref dev/gplvm.py:760 uses FD)."""
        dtype = config.linalg_dtype(None)
        Xq, _, _, alpha = self._committed(x_pred)
        hps = jnp.asarray(self.hyperparameters, dtype=dtype)
        X = self.X

        def mean_at(xq):
            return self.kernel(X, xq[None, :], hps)[:, 0] @ alpha

        jac = jax.vmap(jax.jacobian(mean_at))(Xq)    # (n, Q, L)
        if direction is not None:
            return {"x": np.asarray(Xq), "direction": direction,
                    "dm/dx": np.asarray(jac[:, :, int(direction)])}
        return {"x": np.asarray(Xq), "direction": "ALL",
                "dm/dx": np.asarray(jac)}

    def posterior_covariance(self, x_pred, variance_only=False,
                             add_noise=False):
        """Posterior covariance at latent positions, shared across the Q
        outputs (ref dev/gplvm.py:792)."""
        dtype = config.linalg_dtype(None)
        Xq, ks, L, _ = self._committed(x_pred)
        hps = jnp.asarray(self.hyperparameters, dtype=dtype)
        sol = jax.scipy.linalg.cho_solve((L, True), ks)
        if variance_only:
            kss_diag = jax.vmap(
                lambda xq: self.kernel(xq[None, :], xq[None, :], hps)[0, 0])(Xq)
            v = np.asarray(kss_diag - jnp.sum(ks * sol, axis=0))
            S = None
        else:
            kss = self.kernel(Xq, Xq, hps)
            S = np.asarray(kss - ks.T @ sol)
            v = np.diag(S).copy()
        if np.any(v < -1e-6):
            warnings.warn("Negative posterior variances encountered and "
                          "clipped; the latent model may be misspecified.")
        v = np.clip(v, 0.0, None)
        if add_noise:
            v = v + np.exp(self.log_noise)
            if S is not None:
                S = S + np.exp(self.log_noise) * np.eye(len(S))
        return {"x": np.asarray(Xq), "v(x)": v, "S": S}

    def posterior_covariance_grad(self, x_pred, direction=None):
        """d posterior-variance / d latent coordinate — exact autodiff
        (ref dev/gplvm.py:819)."""
        dtype = config.linalg_dtype(None)
        Xq, _, L, _ = self._committed(x_pred)
        hps = jnp.asarray(self.hyperparameters, dtype=dtype)
        X = self.X

        def var_at(xq):
            k = self.kernel(X, xq[None, :], hps)[:, 0]
            kk = self.kernel(xq[None, :], xq[None, :], hps)[0, 0]
            sol = jax.scipy.linalg.cho_solve((L, True), k)
            return kk - k @ sol

        grad = np.asarray(jax.vmap(jax.grad(var_at))(Xq))   # (n, L)
        if direction is not None:
            return {"x": np.asarray(Xq), "direction": direction,
                    "dv/dx": grad[:, int(direction)]}
        return {"x": np.asarray(Xq), "dv/dx": grad}

    def joint_gp_prior(self, x_pred):
        """Joint prior over (training latents, new latents)
        (ref dev/gplvm.py:842)."""
        dtype = config.linalg_dtype(None)
        Xq, ks, _, _ = self._committed(x_pred)
        hps = jnp.asarray(self.hyperparameters, dtype=dtype)
        K = np.asarray(self.kernel(self.X, self.X, hps))
        kk = np.asarray(self.kernel(Xq, Xq, hps))
        k = np.asarray(ks)
        S = np.block([[K, k], [k.T, kk]])
        return {"x": np.asarray(Xq), "K": K, "k": k, "kappa": kk,
                "S": S + np.identity(len(S)) * 1e-9}

    def gp_entropy(self, x_pred):
        """Differential entropy of the joint prior at latent positions
        (ref dev/gplvm.py:887)."""
        S = self.joint_gp_prior(x_pred)["S"]
        sign, ldet = np.linalg.slogdet(S)
        dim = len(S)
        return dim / 2.0 + (dim / 2.0) * np.log(2.0 * np.pi) + 0.5 * ldet

    def gp_kl_div(self, x_pred, comp_mean, comp_cov):
        """KL(posterior-at-latents || given Gaussian), output-averaged
        mean (ref dev/gplvm.py:934)."""
        from .gp_posterior import GPposterior
        mean = self.posterior_mean(x_pred)["m(x)"].mean(axis=1)
        cov = self.posterior_covariance(x_pred)["S"]
        cov = cov + np.identity(len(cov)) * 1e-9
        comp_cov = np.asarray(comp_cov) + np.identity(len(comp_cov)) * 1e-9
        return {"x": np.asarray(x_pred),
                "gp posterior mean": mean,
                "gp posterior covariance": cov,
                "given mean": comp_mean,
                "given covariance": comp_cov,
                "kl-div": GPposterior.kl_div(mean, comp_mean, cov, comp_cov)}

    def gp_mutual_information(self, x_pred):
        """MI between the training set and new latent positions
        (ref dev/gplvm.py:960)."""
        joint = self.joint_gp_prior(x_pred)
        K = joint["K"] + np.identity(len(joint["K"])) * 1e-9
        kk = joint["kappa"] + np.identity(len(joint["kappa"])) * 1e-9

        def _ent(S):
            _, ldet = np.linalg.slogdet(S)
            d = len(S)
            return d / 2.0 + (d / 2.0) * np.log(2.0 * np.pi) + 0.5 * ldet

        return {"x": np.asarray(x_pred),
                "mutual information": _ent(K) + _ent(kk) - _ent(joint["S"])}

    # -- legacy/decoder aliases ----------------------------------------
    def reconstruct(self, x_latent=None):
        """Posterior mean of Y at latent positions (default: the training
        embedding) — the decoder direction."""
        return self.posterior_mean(x_latent)["m(x)"]

    def predict_variance(self, x_latent):
        """Posterior variance at latent positions (shared across outputs)."""
        return self.posterior_covariance(x_latent, variance_only=True)["v(x)"]
