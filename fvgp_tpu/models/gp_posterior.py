"""Posterior suite (parity target: /root/reference/fvgp/gp_posterior.py).

All heavy math runs on device (solves against the committed factorization,
einsum variance fast path on the device); returned dicts carry host numpy
arrays with the reference's exact keys and multi-task task-major layouts
(k = point + V*task, ref gp_posterior.py:263-275).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..ops import dense as dops
from ..parallel.block_sparse import is_block_sparse


class GPposterior:
    def __init__(self, data, prior, trainer, kv, likelihood):
        self.data = data
        self.prior = prior
        self.trainer = trainer
        self.kv = kv
        self.likelihood = likelihood
        self.noise_function_available = likelihood._mode == "callable"
        self._cross_cov_memo = None

    @staticmethod
    def _cross_cov_key(data, x_pred, hyperparameters):
        hps = np.asarray(hyperparameters)
        return (data.point_number, getattr(data, "generation", 0),
                hps.tobytes(), x_pred.shape, x_pred.tobytes())

    def _cross_cov(self, x_pred, hyperparameters):
        """k(x_data, x_pred), memoizing the LAST (data, hps, x_pred) triple:
        the standard posterior_mean-then-posterior_covariance flow assembles
        the same k twice — at gp2Scale scale that is a full distributed
        rectangular assembly per call.  Non-ndarray (non-Euclidean list)
        inputs skip the memo."""
        if not isinstance(x_pred, np.ndarray):
            return self.prior.compute_data_cross_covariance(
                x_pred, hyperparameters)
        key = self._cross_cov_key(self.data, x_pred, hyperparameters)
        memo = self._cross_cov_memo
        if memo is not None and memo[0] == key:
            return memo[1]
        k = self.prior.compute_data_cross_covariance(x_pred, hyperparameters)
        self._cross_cov_memo = (key, k)
        return k

    def _mean_product(self, x_pred, hyperparameters, KVinvY):
        """kᵀ·KVinvY for the posterior mean.  Under gp2Scale at scale the
        product is FUSED into the chunked kernel sweep
        (prior.cross_covariance_product_or_none) so the (N, n_pred) cross
        covariance never materializes — unless the memo already holds k
        for this exact query (a preceding posterior_covariance call), in
        which case the cheap matmul against it wins."""
        if (self.gp2Scale and isinstance(x_pred, np.ndarray)
                and len(self.x_data) > self.prior.batch_size):
            memo = self._cross_cov_memo
            hit = (memo is not None and memo[0] ==
                   self._cross_cov_key(self.data, x_pred, hyperparameters))
            if not hit:
                prod = self.prior.cross_covariance_product_or_none(
                    x_pred, hyperparameters, KVinvY)
                if prod is not None:
                    return np.asarray(prod)
        k = self._cross_cov(x_pred, hyperparameters)
        if is_block_sparse(k):
            return np.asarray(k.rmatmat(KVinvY))
        return np.asarray(k.T @ KVinvY)

    # -- plumbing ----------------------------------------------------------
    @property
    def args(self):
        return self.data.args

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    @property
    def x_data(self):
        return self.data.x_data

    @property
    def y_data(self):
        return self.data.y_data

    @property
    def x_out(self):
        return self.data.x_out

    @property
    def KVinvY(self):
        return self.kv.KVinvY

    @property
    def KVinv(self):
        return self.kv.KVinv

    @property
    def input_set_dim(self):
        return self.data.input_set_dim

    @property
    def K(self):
        return self.prior.K

    @property
    def m(self):
        return self.prior.m

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    # ------------------------------------------------------------------
    @staticmethod
    def _dense(matrix):
        return matrix.to_dense() if is_block_sparse(matrix) else matrix

    def _dense_K(self):
        """Dense K for joint-covariance methods (ref gp_posterior.py:105-118)."""
        if not is_block_sparse(self.K):
            return self.K
        warnings.warn(
            "This method assembles a joint covariance over data and prediction "
            "points, which is dense in the number of data points. Under the "
            "scale path that discards the sparse representation; it is only "
            "usable on small problems. Consider posterior_covariance instead.")
        return self.K.to_dense()

    def _cross_solve_product(self, k, chunk_size=None, diag=False):
        """kᵀ (K+V)⁻¹ k in column chunks (ref gp_posterior.py:120-136);
        ``diag=True`` returns only its diagonal (the variance path).

        Under gp2Scale the chunk is additionally bounded by MEMORY, not
        just the batch size: every Krylov matvec with c right-hand sides
        materializes a (T, B, c) per-tile product, so c is capped at
        ~2 GB of intermediate (at N=1M that is a handful of columns —
        the solve loops more, but never OOMs)."""
        n_pred = k.shape[1]
        if chunk_size is None:
            fast_cb = (self.kv.fast_solve_col_budget()
                       if self.gp2Scale else None)
            if fast_cb is not None:
                # committed-state fast solver: the memory bound is its CG
                # state, and the stored KV must NOT be touched (accessing
                # the property materializes ~10 GB of tiles at N=1M)
                chunk_size = fast_cb
            else:
                chunk_size = (n_pred if not self.gp2Scale
                              else self.prior.batch_size)
                KV = getattr(self.kv, "KV", None)
                if self.gp2Scale and is_block_sparse(KV):
                    itemsize = np.dtype(
                        config.linalg_dtype(self.data.args)).itemsize
                    chunk_size = min(int(chunk_size),
                                     KV._col_chunk(n_pred, itemsize))
        chunk_size = max(1, min(int(chunk_size), n_pred))
        parts = []
        kd = None if is_block_sparse(k) else jnp.asarray(k)
        for start in range(0, n_pred, chunk_size):
            end = min(start + chunk_size, n_pred)
            if kd is None:
                # only the chunk is densified: the (N x n_pred) dense array
                # never exists (the reference's memory contract)
                cols = k.dense_columns(start, end)
            else:
                cols = kd[:, start:end]
            solved = self.kv.solve(cols)
            if diag:
                # variance path: only kᵀ(K+V)⁻¹k's DIAGONAL is consumed —
                # the per-chunk elementwise dot replaces the (n_pred, c)
                # full-row product, cutting O(N·n_pred²) matmul FLOPs to
                # O(N·n_pred) and never forming the (n_pred, n_pred) S
                parts.append(jnp.sum(jnp.asarray(cols) * solved, axis=0))
            elif is_block_sparse(k):
                parts.append(k.rmatmat(solved))
            else:
                # full f32 precision: the variance is kk minus this product,
                # and both are O(prior variance), so a TF32 product's ~5e-4
                # relative error lands undamped in the difference
                parts.append(jnp.matmul(kd.T, solved,
                                        precision=jax.lax.Precision.HIGHEST))
        if diag:
            return jnp.concatenate(parts)
        return jnp.concatenate(parts, axis=1)

    # ------------------------------------------------------------------
    def posterior_mean(self, x_pred, hyperparameters=None, x_out=None):
        """m(x*) + k*ᵀ(K+V)⁻¹(y-m) (ref gp_posterior.py:139-182)."""
        x_data = self.x_data
        if hyperparameters is not None:
            K = self.prior.compute_prior_covariance_matrix(x_data, hyperparameters)
            V = self.likelihood.calculate_V(x_data, hyperparameters)
            m = self.prior.compute_mean(x_data, hyperparameters)
            KVinvY = self.kv.compute_new_KVinvY(self.kv.addKV(K, V), m)
        else:
            hyperparameters = self.hyperparameters
            KVinvY = self.KVinvY

        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy() if isinstance(x_pred, np.ndarray) else list(x_pred)
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)

        A = self._mean_product(x_pred, hyperparameters, KVinvY)
        prior_mean = np.asarray(self.prior.compute_mean(x_pred, hyperparameters))
        posterior_mean = prior_mean[:, None] + A
        if isinstance(x_out, np.ndarray):
            pm_re = posterior_mean.reshape(len(x_orig), len(x_out), order='F')
        else:
            pm_re = posterior_mean

        if KVinvY.shape[1] == 1 and not isinstance(x_out, np.ndarray):
            return {"x": x_orig, "m(x)": np.squeeze(pm_re),
                    "m(x)_flat": np.squeeze(posterior_mean), "x_pred": x_pred}
        elif KVinvY.shape[1] == 1 and isinstance(x_out, np.ndarray):
            return {"x": x_orig, "m(x)": pm_re,
                    "m(x)_flat": np.squeeze(posterior_mean), "x_pred": x_pred}
        else:
            # (multi-column y_data with an ndarray x_out is rejected by
            # _perform_input_checks before KVinvY is touched)
            return {"x": x_orig, "m(x)": pm_re,
                    "m(x)_flat": posterior_mean, "x_pred": x_pred}

    def posterior_mean_grad(self, x_pred, hyperparameters=None, x_out=None,
                            direction=None, component=0):
        """(ref gp_posterior.py:184-226)."""
        x_data = self.x_data
        if hyperparameters is not None:
            K = self.prior.compute_prior_covariance_matrix(x_data, hyperparameters)
            V = self.likelihood.calculate_V(x_data, hyperparameters)
            m = self.prior.compute_mean(x_data, hyperparameters)
            KVinvY = self.kv.compute_new_KVinvY(self.kv.addKV(K, V), m)[:, component]
        else:
            hyperparameters = self.hyperparameters
            KVinvY = self.KVinvY[:, component]

        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy()
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)

        # mean derivative: exact (autodiff / analytic zero) on the traced
        # path, finite differences only for host-callable means (prior.dm_dx)
        if direction is not None:
            mean_der = np.asarray(self.prior.dm_dx(x_pred, hyperparameters,
                                                   direction))
            k_g = self.prior.d_kernel_dx(x_pred, x_data, direction, hyperparameters)
            grad = mean_der + np.asarray(k_g @ KVinvY)
            if isinstance(x_out, np.ndarray):
                grad = grad.reshape(len(x_orig), len(x_out), order='F')
            return {"x": x_orig, "direction": direction, "dm/dx": grad}
        grad = np.zeros((len(x_pred), x_orig.shape[1]))
        for d in range(len(x_orig[0])):
            mean_der = np.asarray(self.prior.dm_dx(x_pred, hyperparameters, d))
            k_g = self.prior.d_kernel_dx(x_pred, x_data, d, hyperparameters)
            grad[:, d] = mean_der + np.asarray(k_g @ KVinvY)
        if isinstance(x_out, np.ndarray):
            grad = grad.reshape(len(x_orig), len(x_orig[0]), len(x_out), order='F')
        return {"x": x_orig, "direction": "ALL", "dm/dx": grad}

    # ------------------------------------------------------------------
    def posterior_covariance(self, x_pred, x_out=None, variance_only=False,
                             add_noise=False):
        """(ref gp_posterior.py:229-288), with the einsum variance fast path
        when the explicit inverse is stored (:238-244)."""
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy() if isinstance(x_pred, np.ndarray) else list(x_pred)
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)

        k = self._cross_cov(x_pred, self.hyperparameters)
        kk = self.prior.compute_covariances(x_pred, x_pred, self.hyperparameters)

        if self.KVinv is not None and variance_only and self.y_data.shape[1] == 1:
            kd = self._dense(k)
            S = None
            v = jnp.diagonal(kk) - jnp.einsum(
                "ji,jk,ki->i", kd, self.KVinv, kd,
                precision=jax.lax.Precision.HIGHEST)  # see _cross_solve_product
            # np.asarray of a device array is a READ-ONLY view; the negative-
            # variance clip below mutates in place
            v = np.array(v)
        elif variance_only and self.gp2Scale and self.y_data.shape[1] == 1:
            # at-scale variance path: only the DIAGONAL of kᵀ(K+V)⁻¹k is
            # consumed — skip the (n_pred, n_pred) S and its O(N·n_pred²)
            # product FLOPs entirely (S is None, exactly like the
            # explicit-inverse fast path above)
            S = None
            v = np.array(jnp.diagonal(kk)
                         - self._cross_solve_product(k, diag=True))
        else:
            S = np.array(kk - self._cross_solve_product(k))
            v = np.array(np.diag(S))
        if np.any(v < -0.0001):
            warnings.warn(
                "Negative variances encountered. That normally means the model "
                "is unstable. Rethink the kernel definition, add more noise, or "
                "double check the hyperparameter optimization bounds.")
        if np.any(v < 0.0):
            v[v < 0.0] = 0.0
            if not variance_only and S is not None:
                np.fill_diagonal(S, v)

        if add_noise:
            v, S = self.add_noise(x_pred, v, S)

        if isinstance(x_out, np.ndarray):
            v_re = v.reshape(len(x_orig), len(x_out), order='F')
            if S is not None:
                S_re = S.reshape(len(x_orig), len(x_out), len(x_orig),
                                 len(x_out), order='F').transpose(0, 2, 1, 3)
            else:
                S_re = None
        else:
            v_re = v
            S_re = S
            if self.y_data.shape[1] > 1:
                v = np.tile(v[:, None], (1, self.y_data.shape[1]))
                v_re = np.tile(v_re[:, None], (1, self.y_data.shape[1]))

        return {"x": x_orig, "x_pred": x_pred, "v(x)": v_re, "S": S_re,
                "S_flat": S, "v_flat": v}

    def posterior_covariance_grad(self, x_pred, x_out=None, direction=None):
        """(ref gp_posterior.py:290-331)."""
        x_data = self.x_data
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy()
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)

        k = self.prior.compute_covariances(x_data, x_pred, self.hyperparameters)
        k_covariance_prod = self.kv.solve(k)
        eps = 1e-6

        def _kk_g(d):
            x1 = np.array(x_pred)
            x1[:, d] += eps
            return (np.asarray(self.prior.compute_covariances(x1, x1, self.hyperparameters))
                    - np.asarray(self.prior.compute_covariances(x_pred, x_pred,
                                                                self.hyperparameters))) / eps

        if direction is not None:
            k_g = np.asarray(self.prior.d_kernel_dx(x_pred, x_data, direction,
                                                    self.hyperparameters)).T
            dSdx = _kk_g(direction) - 2.0 * np.asarray(k_g.T @ k_covariance_prod)
            a = np.diag(dSdx)
            if isinstance(x_out, np.ndarray):
                a = a.reshape(len(x_orig), len(x_out), order='F')
                dSdx = dSdx.reshape(len(x_orig), len(x_orig), len(x_out),
                                    len(x_out), order='F')
            return {"x": x_orig, "dv/dx": a, "dS/dx": dSdx}
        grad_v = np.zeros((len(x_pred), len(x_orig[0])))
        for d in range(len(x_orig[0])):
            k_g = np.asarray(self.prior.d_kernel_dx(x_pred, x_data, d,
                                                    self.hyperparameters)).T
            grad_v[:, d] = np.diag(_kk_g(d) - 2.0 * np.asarray(k_g.T @ k_covariance_prod))
        if isinstance(x_out, np.ndarray):
            grad_v = grad_v.reshape(len(x_orig), len(x_orig[0]), len(x_out), order='F')
        return {"x": x_orig, "dv/dx": grad_v}

    # ------------------------------------------------------------------
    def joint_gp_prior(self, x_pred, x_out=None):
        """(ref gp_posterior.py:334-353)."""
        x_data = self.x_data
        K = np.asarray(self._dense_K()) + np.identity(len(x_data)) * 1e-9
        prior_mean_vec = np.asarray(self.m)
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)
        k = np.asarray(self.prior.compute_covariances(x_data, x_pred, self.hyperparameters))
        kk = np.asarray(self.prior.compute_covariances(x_pred, x_pred, self.hyperparameters))
        post_mean = np.asarray(self.prior.compute_mean(x_pred, self.hyperparameters))
        joint_mean = np.append(prior_mean_vec, post_mean)
        joint_cov = np.block([[K, k], [k.T, kk]])
        return {"x": x_pred, "K": K, "k": k, "kappa": kk,
                "prior mean": joint_mean,
                "S": joint_cov + np.identity(len(joint_cov)) * 1e-9}

    def joint_gp_prior_grad(self, x_pred, direction, x_out=None):
        """(ref gp_posterior.py:356-383)."""
        x_data = self.x_data
        K = np.asarray(self._dense_K()) + np.identity(len(x_data)) * 1e-9
        prior_mean_vec = np.asarray(self.m)
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)
        k_g = np.asarray(self.prior.d_kernel_dx(x_pred, x_data, direction,
                                                self.hyperparameters)).T
        eps = 1e-6
        x1 = np.array(x_pred)
        x2 = np.array(x_pred)
        x1[:, direction] += eps
        x2[:, direction] -= eps
        kk_g = (np.asarray(self.prior.compute_covariances(x1, x1, self.hyperparameters))
                - np.asarray(self.prior.compute_covariances(x2, x2, self.hyperparameters))
                ) / (2.0 * eps)
        mean_der = (np.asarray(self.prior.compute_mean(x1, self.hyperparameters))
                    - np.asarray(self.prior.compute_mean(x2, self.hyperparameters))
                    ) / (2.0 * eps)
        full_mean_grad = np.append(np.zeros(prior_mean_vec.shape), mean_der)
        prior_cov_grad = np.zeros(K.shape)
        return {"x": x_pred, "K": K, "dk/dx": k_g, "d kappa/dx": kk_g,
                "d prior mean/x": full_mean_grad,
                "dS/dx": np.block([[prior_cov_grad, k_g], [k_g.T, kk_g]])}

    # ------------------------------------------------------------------
    @staticmethod
    def entropy(S):
        """Gaussian differential entropy (ref gp_posterior.py:387)."""
        dim = len(S[0])
        ldet = float(dops.calculate_logdet(jnp.asarray(S)))
        return (dim / 2.0) + ((dim / 2.0) * np.log(2.0 * np.pi)) + 0.5 * ldet

    def gp_entropy(self, x_pred, x_out=None):
        """(ref gp_posterior.py:393-415)."""
        priors = self.joint_gp_prior(x_pred, x_out=x_out)
        return self.entropy(priors["S"])

    def gp_entropy_grad(self, x_pred, direction, x_out=None):
        """(ref gp_posterior.py:418-423)."""
        priors1 = self.joint_gp_prior(x_pred, x_out=x_out)
        priors2 = self.joint_gp_prior_grad(x_pred, direction, x_out=x_out)
        S1 = jnp.asarray(priors1["S"])
        S2 = jnp.asarray(priors2["dS/dx"])
        return 0.5 * float(jnp.trace(jnp.asarray(dops.calculate_inv(S1)) @ S2))

    @staticmethod
    def kl_div(mu1, mu2, S1, S2):
        """KL(N1 || N2) (ref gp_posterior.py:427-441)."""
        S1 = jnp.asarray(S1)
        S2 = jnp.asarray(S2)
        logdet1 = float(dops.calculate_logdet(S1))
        logdet2 = float(dops.calculate_logdet(S2))
        x1 = jnp.linalg.solve(S2, S1)
        mu = jnp.asarray(mu2) - jnp.asarray(mu1)
        x2 = jnp.linalg.solve(S2, mu)
        dim = len(mu)
        kld = 0.5 * (float(jnp.trace(x1)) + float(x2.T @ mu) - dim
                     + (logdet2 - logdet1))
        if kld < -1e-4:
            warnings.warn("Negative KL divergence encountered; returning abs(KLD).")
        return abs(kld)

    def gp_kl_div(self, x_pred, comp_mean, comp_cov, x_out=None):
        """(ref gp_posterior.py:444-457)."""
        if x_out is None:
            x_out = self.x_out
        res = self.posterior_mean(x_pred, x_out=x_out)
        gp_mean = res["m(x)_flat"]
        gp_cov = self.posterior_covariance(x_pred, x_out=x_out)["S_flat"]
        gp_cov = gp_cov + np.identity(len(gp_cov)) * 1e-9
        comp_cov = comp_cov + np.identity(len(comp_cov)) * 1e-9
        return {"x": x_pred,
                "gp posterior mean": gp_mean,
                "gp posterior covariance": gp_cov,
                "given mean": comp_mean,
                "given covariance": comp_cov,
                "kl-div": self.kl_div(gp_mean, comp_mean, gp_cov, comp_cov)}

    def mutual_information(self, joint, m1, m2):
        return self.entropy(m1) + self.entropy(m2) - self.entropy(joint)

    def gp_mutual_information(self, x_pred, x_out=None, add_noise=False):
        """(ref gp_posterior.py:464-477)."""
        x_data = self.x_data
        K = np.asarray(self._dense_K()) + np.identity(len(x_data)) * 1e-9
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy()
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)
        k = np.asarray(self.prior.compute_covariances(x_data, x_pred, self.hyperparameters))
        kk = np.asarray(self.prior.compute_covariances(x_pred, x_pred, self.hyperparameters)) \
            + np.identity(len(x_pred)) * 1e-9
        if add_noise:
            _, kk = self.add_noise(x_pred, np.diag(kk).copy(), kk)
        joint_covariance = np.block([[K, k], [k.T, kk]])
        return {"x": x_orig,
                "mutual information": self.mutual_information(joint_covariance, kk, K)}

    def gp_total_correlation(self, x_pred, x_out=None, add_noise=False):
        """(ref gp_posterior.py:480-496)."""
        x_data = self.x_data
        K = np.asarray(self._dense_K()) + np.identity(len(x_data)) * 1e-9
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy()
        if isinstance(x_out, np.ndarray):
            x_pred = self.cartesian_product(x_pred, x_out)
        k = np.asarray(self.prior.compute_covariances(x_data, x_pred, self.hyperparameters))
        kk = np.asarray(self.prior.compute_covariances(x_pred, x_pred, self.hyperparameters)) \
            + np.identity(len(x_pred)) * 1e-9
        if add_noise:
            _, kk = self.add_noise(x_pred, np.diag(kk).copy(), kk)
        joint_covariance = np.block([[K, k], [k.T, kk]])
        prod_covariance = np.block([[K, k * 0.], [k.T * 0., kk * np.identity(len(kk))]])
        return {"x": x_orig,
                "total correlation": self.kl_div(
                    np.zeros(len(joint_covariance)), np.zeros(len(joint_covariance)),
                    joint_covariance, prod_covariance)}

    def gp_relative_information_entropy(self, x_pred, x_out=None, add_noise=False):
        """(ref gp_posterior.py:499-512)."""
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        x_orig = x_pred.copy()
        if isinstance(x_out, np.ndarray):
            x_pred_aux = self.cartesian_product(x_pred, x_out)
        else:
            x_pred_aux = x_pred
        kk = np.asarray(self.prior.compute_covariances(x_pred_aux, x_pred_aux,
                                                       self.hyperparameters)) \
            + np.identity(len(x_pred_aux)) * 1e-9
        post_cov = self.posterior_covariance(x_pred, x_out=x_out,
                                             add_noise=add_noise)["S_flat"]
        post_cov = post_cov + np.identity(len(post_cov)) * 1e-9
        post_mean = self.posterior_mean(x_pred, x_out=x_out)["m(x)_flat"]
        prio_mean = np.asarray(self.prior.compute_mean(x_pred_aux, self.hyperparameters))
        return {"x": x_orig, "RIE": self.kl_div(prio_mean, post_mean, kk, post_cov)}

    def gp_relative_information_entropy_set(self, x_pred, x_out=None, add_noise=False):
        """(ref gp_posterior.py:515-526)."""
        if x_out is None:
            x_out = self.x_out
        x_orig = x_pred.copy()
        RIE = np.zeros(len(x_pred))
        for i in range(len(x_pred)):
            RIE[i] = self.gp_relative_information_entropy(
                x_pred[i].reshape(1, len(x_pred[i])), x_out=x_out,
                add_noise=add_noise)["RIE"]
        return {"x": x_orig, "RIE": RIE}

    def posterior_probability(self, x_pred, comp_mean, comp_cov, x_out=None):
        """Probability that the GP posterior and a candidate Gaussian
        describe the same function values (ref gp_posterior.py:529-552).

        The product of two Gaussian densities is an (unnormalized)
        Gaussian; everything follows from ONE Cholesky factor of the sum
        covariance ``T = S_gp + S_c`` — no explicit inverses:

            fused covariance   S  = S_gp T⁻¹ S_c
            fused mean         mu = S_c T⁻¹ m_gp + S_gp T⁻¹ m_c
            probability        p  = N(m_gp − m_c | 0, T)
        """
        if x_out is None:
            x_out = self.x_out
        self._perform_input_checks(x_pred, x_out)
        m_gp = jnp.asarray(self.posterior_mean(x_pred, x_out=x_out)["m(x)_flat"])
        S_gp = jnp.asarray(self.posterior_covariance(
            x_pred, x_out=x_out, add_noise=True)["S_flat"])
        m_c = jnp.asarray(comp_mean)
        S_c = jnp.asarray(comp_cov)
        L_T = dops.cholesky_factor(S_gp + S_c)
        fused_cov = S_gp @ dops.cholesky_solve(L_T, S_c)
        fused_mean = (S_c @ dops.cholesky_solve(L_T, m_gp)
                      + S_gp @ dops.cholesky_solve(L_T, m_c))
        diff = m_gp - m_c
        maha = jnp.dot(diff, dops.cholesky_solve(L_T, diff))
        dim = diff.shape[0]
        log_p = -0.5 * (maha + dops.cholesky_logdet(L_T)
                        + dim * jnp.log(2.0 * jnp.pi))
        return {"mu": np.asarray(fused_mean),
                "covariance": np.asarray(fused_cov),
                "probability": float(jnp.exp(log_p))}

    # ------------------------------------------------------------------
    def add_noise(self, x_pred, v, S):
        """(ref gp_posterior.py:554-569)."""
        if self.noise_function_available:
            noise = self.likelihood.calculate_V(x_pred, self.hyperparameters)
            # structured (scipy.sparse / BlockSparseMatrix) noise densifies
            # at prediction size — n_pred is small by contract here
            from scipy.sparse import issparse
            if issparse(noise):
                noise = noise.toarray()
            elif is_block_sparse(noise):
                noise = noise.to_dense()
            noise = np.asarray(noise)
            if noise.ndim == 1:
                v = v + noise
                if S is not None:
                    S = S + np.diag(noise)
            elif noise.ndim == 2:
                v = v + np.diag(noise)
                if S is not None:
                    S = S + noise
            else:
                warnings.warn("Noise could not be added: wrong noise format.")
        return v, S

    def _perform_input_checks(self, x_pred, x_out):
        if not isinstance(x_pred, (np.ndarray, list)):
            raise AssertionError("wrong format in x_pred")
        if isinstance(x_pred, np.ndarray):
            if x_pred.ndim != 2:
                raise AssertionError("wrong dim in x_pred, has to be 2-d")
            if x_pred.shape[1] != self.input_set_dim:
                raise AssertionError("wrong number of columns in x_pred")
        if not (isinstance(x_out, np.ndarray) or x_out is None or isinstance(x_out, list)):
            raise AssertionError("wrong format in x_out")
        if isinstance(x_out, np.ndarray) and x_out.ndim != 1:
            raise AssertionError("wrong dim in x_out, has to be 1-d")
        # reject before any product-space kernel evaluation — otherwise the
        # mismatch surfaces as an opaque broadcasting error mid-solve
        if isinstance(x_out, np.ndarray) and self.y_data.ndim == 2 \
                and self.y_data.shape[1] > 1:
            raise Exception("multi-column y_data cannot be combined with x_out")

    @staticmethod
    def cartesian_product(x, y):
        """Task-major product-space points (ref gp_posterior.py:586-606)."""
        if not (isinstance(y, np.ndarray) and y.ndim == 1):
            raise AssertionError("x_out must be a 1-d np.ndarray")
        if isinstance(x, list):
            return [[xi, yj] for yj in y for xi in x]
        if isinstance(x, np.ndarray):
            n, d = x.shape
            out = np.empty((len(y) * n, d + 1))
            out[:, :d] = np.tile(x, (len(y), 1))
            out[:, d] = np.repeat(y, n)
            return out
        raise Exception("Cartesian product out of options")

    def __getstate__(self):
        return dict(prior=self.prior, likelihood=self.likelihood, data=self.data,
                    trainer=self.trainer,
                    noise_function_available=self.noise_function_available,
                    kv=self.kv)

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cross_cov_memo = None    # device arrays never enter pickles
