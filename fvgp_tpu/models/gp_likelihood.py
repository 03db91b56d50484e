"""Noise model V (parity target: /root/reference/fvgp/gp_likelihood.py).

V may be a per-point variance vector, a dense covariance matrix, or — under
gp2Scale — a diagonal vector added to the block-sparse K.  User noise
callables may be jnp (traced, autodiff supplies dV/dh) or host numpy
(finite-difference fallback, same contract as the reference).
"""

import inspect
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .. import config


def _is_traceable(fn, *example_args):
    try:
        jax.eval_shape(fn, *example_args)
        return True
    except Exception:
        return False


def _is_structured(obj):
    """scipy.sparse or BlockSparseMatrix noise (structured, host-side)."""
    from scipy.sparse import issparse

    from ..parallel.block_sparse import is_block_sparse
    return issparse(obj) or is_block_sparse(obj)


def _densify(obj):
    from scipy.sparse import issparse
    if issparse(obj):
        return jnp.asarray(obj.toarray())
    from ..parallel.block_sparse import is_block_sparse
    if is_block_sparse(obj):
        return obj.to_dense()
    return jnp.asarray(obj)


class GPlikelihood:
    def __init__(self, data, trainer, noise_function=None, noise_function_grad=None):
        self.data = data
        self.trainer = trainer
        nv = self.noise_variances
        if nv is not None:
            if not (isinstance(nv, np.ndarray) and nv.ndim == 1):
                raise AssertionError("noise_variances must be a 1-d np.ndarray")
            if not np.all(nv > 0.0):
                raise AssertionError("all noise_variances must be positive")
            if callable(noise_function):
                raise Exception("Noise function and measurement noise provided. "
                                "Decide which one to use.")

        self.v_n_params = 2
        self._mode = "default"
        if callable(noise_function):
            self.noise_function = noise_function
            self.v_n_params = len(inspect.signature(noise_function).parameters)
            self._mode = "callable"
        elif nv is not None:
            self.noise_function = self._measured_noise_function
            self._mode = "measured"
        else:
            warnings.warn("No noise function or measurement noise provided. "
                          "Noise variances will be set to (0.01*mean(|y_data|))**2.",
                          stacklevel=2)
            self.noise_function = self._default_noise_function

        self._user_noise_grad = noise_function_grad if callable(noise_function_grad) else None

        # traceability probe for user noise callables
        self.noise_traceable = self._mode != "callable"
        if self._mode == "callable" and self.data.Euclidean:
            x2 = config.asarray(np.asarray(self.x_data[:2], dtype=np.float64))
            h = config.asarray(self.hyperparameters)
            if self.v_n_params == 2:
                self.noise_traceable = _is_traceable(self.noise_function, x2, h)
            else:
                self.noise_traceable = _is_traceable(
                    lambda a, hh: self.noise_function(a, hh, self.args), x2, h)

        self.V = self.calculate_V(self.x_data, self.hyperparameters)

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
    def noise_variances(self):
        return self.data.noise_variances

    @property
    def ram_economy(self):
        return self.data.ram_economy

    # ------------------------------------------------------------------
    def update_state(self):
        self.V = self.calculate_V(self.x_data, self.hyperparameters)

    def calculate_V(self, x_data, hyperparameters):
        """Evaluate the noise model (ref gp_likelihood.py:89-94).
        Returns a device vector (diagonal), a dense matrix, or — for a user
        callable returning scipy.sparse / BlockSparseMatrix — the structured
        host matrix itself, folded in sparse-aware by GPkv.addKV
        (ref gp_likelihood.py:89-110, gp_kv.py:640-669)."""
        if self._mode == "callable":
            hps = (config.asarray(hyperparameters) if self.noise_traceable
                   else np.asarray(hyperparameters))
            x_in = x_data if isinstance(x_data, list) else (
                config.asarray(np.asarray(x_data, dtype=np.float64))
                if self.noise_traceable else np.asarray(x_data))
            if self.v_n_params == 2:
                noise = self.noise_function(x_in, hps)
            elif self.v_n_params == 3:
                noise = self.noise_function(x_in, hps, self.args)
            else:
                raise Exception("No valid noise function signature.")
            if _is_structured(noise):
                return noise
            if not self.noise_traceable:
                noise = np.asarray(noise)
            return jnp.asarray(noise, dtype=config.linalg_dtype(self.args))
        return jnp.asarray(self.noise_function(x_data, hyperparameters),
                           dtype=config.linalg_dtype(self.args))

    def calculate_V_grad(self, x, hyperparameters, direction=None):
        """dV/dh (ref gp_likelihood.py:96-99): user grad > autodiff > FD >
        zeros for the hyperparameter-free defaults."""
        H = len(hyperparameters)
        if self._user_noise_grad is not None:
            if self.ram_economy:
                return jnp.asarray(np.asarray(
                    self._user_noise_grad(x, np.asarray(hyperparameters), direction)))
            return jnp.asarray(np.asarray(
                self._user_noise_grad(x, np.asarray(hyperparameters))))
        if self._mode != "callable":
            if self.ram_economy:
                return jnp.zeros((len(x),), dtype=config.linalg_dtype(self.args))
            return jnp.zeros((H, len(x)), dtype=config.linalg_dtype(self.args))
        if self.noise_traceable:
            hps = config.asarray(hyperparameters)
            jac = jax.jacfwd(lambda h: self.calculate_V(x, h))(hps)
            jac = jnp.moveaxis(jac, -1, 0)
            return jac[direction] if direction is not None else jac
        # host finite differences (ref gp_likelihood.py:123-144)
        if direction is not None:
            return self._fd(x, hyperparameters, direction)
        return jnp.stack([self._fd(x, hyperparameters, i) for i in range(H)])

    def _fd(self, x, hyperparameters, i):
        h1 = np.array(hyperparameters, dtype=np.float64)
        h2 = np.array(hyperparameters, dtype=np.float64)
        h1[i] += 1e-6
        h2[i] -= 1e-6
        V1 = self.calculate_V(x, h1)
        V2 = self.calculate_V(x, h2)
        if _is_structured(V1):
            # structured noise densifies for the FD gradient engine only
            # (the gradient path is dense-N-sized anyway)
            V1, V2 = _densify(V1), _densify(V2)
        return (V1 - V2) / 2e-6

    def calculate_V_host(self, x_data, hyperparameters):
        """Host (numpy) noise diagonal, or None when one is not available
        without a device round-trip.  The scale paths consume the noise on
        the HOST (padding/blocking before one bulk H2D transfer); pulling
        ``calculate_V``'s device vector back with ``np.asarray`` costs a
        device->host transfer of an N-sized array per call."""
        if self._mode == "measured":
            nv = np.asarray(self.noise_variances, dtype=np.float64)
            if len(x_data) == len(nv):
                return nv
            return np.full((len(x_data),), float(np.mean(nv)))
        if self._mode == "default":
            return np.asarray(
                self._default_noise_function(x_data, hyperparameters),
                dtype=np.float64)
        if not self.noise_traceable:
            # host callable: evaluates in numpy already
            noise = self.noise_function(
                x_data if isinstance(x_data, list) else np.asarray(x_data),
                np.asarray(hyperparameters),
                *(() if self.v_n_params == 2 else (self.args,)))
            if _is_structured(noise):
                return None
            noise = np.asarray(noise)
            return noise if noise.ndim == 1 else None
        return None       # traceable device callable: no host shortcut

    # ------------------------------------------------------------------
    def _default_noise_function(self, x, hyperparameters):
        """(0.01 mean|y|)² per point (ref gp_likelihood.py:102)."""
        level = (float(np.mean(np.abs(np.asarray(self.y_data)))) / 100.0) ** 2
        return np.full((len(x),), level)

    def _measured_noise_function(self, x, hyperparameters):
        """Measured variances; mean level for prediction points
        (ref gp_likelihood.py:106)."""
        if len(x) == len(self.noise_variances):
            return self.noise_variances
        return np.full((len(x),), float(np.mean(self.noise_variances)))

    # ------------------------------------------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        if not _is_structured(self.V):
            state["V"] = np.asarray(self.V)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if not _is_structured(self.V):
            self.V = jnp.asarray(self.V)
