"""GP facade — the single-task user API
(parity target: /root/reference/fvgp/gp.py).

Builds the tiered object graph (data → trainer → prior → likelihood → kv →
marginal likelihood → posterior), validates arguments, and exposes the full
reference surface: ``train`` (six methods, sync + async), ``update_gp_data``
(append with blocked rank-n factor updates), the posterior and
information-theory suite, validation metrics, the ``args`` dict, pickling.

Accelerator-first differences from the reference, by design:

* No Dask client anywhere — gp2Scale covariance lives on the device mesh
  (parallel/), async training actors are controller threads.  ``dask_client``
  parameters are accepted and ignored for drop-in compatibility.
* ``compute_device`` accepts "cpu" / "gpu" but is a placement *hint*:
  arrays live wherever JAX's backend puts them; precision is governed by
  config.linalg_dtype and ``args['dtype']``.
* When kernel/mean/noise are jnp callables (the default), training uses one
  jitted ``value_and_grad`` program; hand-written gradients are optional.
"""

import warnings

import numpy as np
from scipy.stats import norm

from .gp_data import GPdata
from .gp_kv import GPkv, sequential_linalg_state
from .gp_likelihood import GPlikelihood
from .gp_marginal_likelihood import GPMarginalLikelihood
from .gp_posterior import GPposterior
from .gp_prior import GPprior
from .gp_training import GPtraining

# deduplicate this package's repeated warnings without rewriting the
# process-global filter (see parallel/sharded_cov.py)
warnings.filterwarnings("once", category=UserWarning,
                        module=r"fvgp_tpu(\..*)?")


def out_of_bounds(x, bounds):
    """(ref gp.py:2179-2185)."""
    x = np.asarray(x)
    bounds = np.asarray(bounds)
    return bool(np.any(x < bounds[:, 0]) or np.any(x > bounds[:, 1]))


class GP:
    """Single-task Gaussian process with pluggable kernel/mean/noise,
    six training methods, a swappable linear-algebra backend, and a
    block-sparse distributed covariance path (gp2Scale equivalent).

    The model is the standard exact GP: given data ``(X, y)``, a kernel
    ``k(x1, x2; θ)``, a prior mean ``m(x; θ)`` and a noise model ``V(θ)``,
    the log marginal likelihood ``-½(yᵀ(K+V)⁻¹y + log|K+V| + N log 2π)``
    is maximized over θ by :meth:`train`, and predictions come from the
    posterior suite (:meth:`posterior_mean`, :meth:`posterior_covariance`,
    and the information-theory methods).  The public surface matches the
    reference ``fvgp.GP`` (ref gp.py:382-401) so existing fvGP code runs
    unchanged; the execution model underneath is JAX on GPU/CPU.

    Parameters
    ----------
    x_data : np.ndarray or list
        Input points.  A 2-D array of shape ``(N, D)`` selects the
        Euclidean path (kernels run on device, trained gradients are
        autodiff).  A *list* of N arbitrary Python objects (strings,
        ragged arrays, graphs, ...) selects the non-Euclidean path: your
        kernel/mean/noise callables receive the objects themselves and
        run on the host, feeding the device linear algebra.
    y_data : np.ndarray
        Targets, shape ``(N,)`` (or ``(N, 1)``).
    init_hyperparameters : np.ndarray, optional
        1-D start vector θ₀.  Required whenever any of the callables
        below is user-supplied (their hyperparameter count is unknowable);
        with the default kernel/mean/noise it defaults to ``ones(D + 1)``
        with a warning — ``[signal variance, lengthscale_1..D]``.
    noise_variances : np.ndarray, optional
        Measured per-point noise variances, shape ``(N,)``.  Mutually
        exclusive with ``noise_function``.  When neither is given the
        noise defaults to the reference's ``(0.01·mean|y|)²`` floor.
    compute_device : str
        ``"cpu"`` / ``"gpu"`` — a *hint* kept for API parity.
        Arrays live wherever the active JAX backend puts them; numeric
        precision is controlled via ``args['dtype']`` instead.
    kernel_function : Callable, optional
        ``k(x1, x2, hps)`` or ``k(x1, x2, hps, args)`` returning the
        ``(len(x1), len(x2))`` cross-covariance.  If it is written in
        ``jax.numpy`` it is traced once into the fused training program
        and differentiated by autodiff; a numpy/host callable works too
        (finite-difference gradients, or supply
        ``kernel_function_grad``).  Default: anisotropic Matérn-3/2 ARD.
    kernel_function_grad : Callable, optional
        ``dk/dθ(x1, x2, hps)`` returning ``(H, len(x1), len(x2))`` (or
        per-direction with ``ram_economy=True``).  Only consulted for
        host kernels — traced kernels get exact gradients for free.
    noise_function : Callable, optional
        ``V(x, hps)`` returning a vector of per-point variances, a dense
        ``(N, N)`` matrix, a ``scipy.sparse`` matrix, or a
        :class:`~fvgp_tpu.parallel.block_sparse.BlockSparseMatrix`
        (sparse forms stay sparse through K+V on the gp2Scale path).
    noise_function_grad : Callable, optional
        ``dV/dθ``; same conventions as ``kernel_function_grad``.
    prior_mean_function : Callable, optional
        ``m(x, hps)`` returning shape ``(len(x),)``.  Default: constant
        ``mean(y)``.
    prior_mean_function_grad : Callable, optional
        ``dm/dθ`` for host mean functions.
    gp2Scale : bool
        Switch the prior covariance to the distributed block-sparse
        engine: the N×N matrix is tiled into B×B blocks (B =
        ``args['gp2Scale_block_size']``), only tiles whose point pairs can
        interact under the kernel's compact support are built (Morton
        ordering + C++ bounding-box pruning), and all linear algebra runs
        matrix-free (preconditioned CG/mBCG + stochastic Lanczos logdet).
        When a ``fvgp_tpu.parallel.mesh`` device mesh is active the tiles
        are row-partitioned across devices.  Unlike the reference, the
        sparse marginal likelihood is differentiable, so gradient-based
        training methods remain available.
    dask_client : Any, optional
        Accepted and ignored (the reference distributes via Dask; this
        build distributes via ``jax.sharding``).  See
        :meth:`initialize_gp2Scale_dask_client`.
    gp2Scale_batch_size : int
        Covariance tile edge B for the gp2Scale path (clamped to a
        ≤256 unless overridden by
        ``args['gp2Scale_block_size']``).
    gp2Scale_distribution : str
        ``"blockwise"`` (upper-triangle tile schedule, mirrored on
        device) or ``"rowwise"`` — accepted for parity; both feed the
        same tile engine here.
    linalg_mode : str or list, optional
        How ``K+V`` is factored/solved/log-det'ed.  ``None`` auto-selects
        (dense Cholesky below the gp2Scale regime, sparse mBCG above).
        Strings: ``"Chol"``, ``"CholInv"``, ``"Inv"``, ``"sparseLU"``,
        ``"sparseCG"``, ``"sparseMINRES"``, ``"sparseCGpre"``,
        ``"sparseMINRESpre"``, ``"sparseSolve"``, plus preconditioner
        aliases ``"sparseCGpre_<block_jacobi|schwarz|amg>"``.  A 3-list
        ``[factor, solve, logdet]`` of callables installs a custom
        backend.  Deviation from the reference: ``sparseLU`` /
        ``sparseSolve`` are served by dense Cholesky below
        ``args['sparse_direct_dense_cutoff']`` and tight preconditioned
        CG above it — sparse *direct* factorization does not suit a GPU.
    ram_economy : bool
        For host-gradient kernels: ``True`` evaluates one hyperparameter
        direction at a time (less memory, more calls); ``False`` expects
        the full ``(H, N, N)`` stack at once.
    args : dict, optional
        Flat advanced-settings store, threaded to every linalg call and
        passed through to 4-argument user callables.  Recognized keys
        include the reference's families —

        * ``sparse_cg_maxiter`` / ``sparse_cg_tol`` / ``sparse_minres_*``
          — Krylov iteration controls,
        * ``random_logdet_fixed_probes`` / ``random_logdet_degree`` /
          ``random_logdet_tol`` — stochastic-Lanczos logdet controls,
        * ``sparse_preconditioner_type`` — ``'block_jacobi'`` (default),
          ``'schwarz'`` (overlapping additive Schwarz — the IC-class
          option), ``'amg'`` (two-level with Galerkin coarse solve),
        * ``warm_start`` — Krylov warm-start reuse across sequential
          evaluations (MCMC),

        — plus the accelerator-specific:

        * ``dtype`` / ``kernel_dtype`` — linalg / kernel eval dtypes,
        * ``gp2Scale_block_size`` — tile edge B (default ≤256),
        * ``gp2Scale_lengthscales`` (callable ``hps → per-dim scales``)
          and ``gp2Scale_support_radius`` — declare a *custom* kernel's
          compact support so tile pruning fires for it too,
        * ``gp2Scale_solver`` (``'mbcg'`` default | ``'slq'``),
          ``gp2Scale_solver_dtype`` / ``gp2Scale_storage_dtype`` (e.g.
          ``'bfloat16'`` tile streaming/storage),
          ``gp2Scale_precond_width`` (group w adjacent Morton-neighbor
          blocks into exact wB preconditioner factors),
          ``gp2Scale_tile_filter`` / ``gp2Scale_filter_drift`` (exact
          zero-tile filter + drift-based reuse policy),
          ``gp2Scale_traced_lml`` — force the traced differentiable
          sparse LML on/off,
        * ``sparse_direct_dense_cutoff`` — see ``linalg_mode``.

        Changing ``args`` via :meth:`set_args` does *not* invalidate
        cached factorizations (same contract as the reference).

    Attributes
    ----------
    x_data, y_data, noise_variances : the training data as given.
    hyperparameters : np.ndarray — the committed hyperparameter vector.
    K, m, V : prior covariance, prior mean, noise model at the committed
        hyperparameters (``K`` is a ``BlockSparseMatrix`` under gp2Scale).
    index_set_dim, input_set_dim : dimensionality bookkeeping (equal for
        single-task GPs; they differ for :class:`fvGP`).
    mcmc_info, bo_info : diagnostics dicts from the last synchronous
        ``train(method='mcmc' | 'bo')`` run.
    args : the advanced-settings dict (assignable).
    """

    def __init__(self, x_data, y_data, init_hyperparameters=None,
                 noise_variances=None, compute_device="cpu",
                 kernel_function=None, kernel_function_grad=None,
                 noise_function=None, noise_function_grad=None,
                 prior_mean_function=None, prior_mean_function_grad=None,
                 gp2Scale=False, dask_client=None, gp2Scale_batch_size=10000,
                 gp2Scale_distribution="blockwise", linalg_mode=None,
                 ram_economy=False, args=None):
        if not (isinstance(noise_variances, np.ndarray) or noise_variances is None):
            raise AssertionError("wrong format in noise_variances")
        if not (init_hyperparameters is None
                or isinstance(init_hyperparameters, np.ndarray)):
            raise AssertionError("wrong init_hyperparameters")
        if not isinstance(compute_device, str):
            raise AssertionError("wrong format in compute_device")
        for fn, name in ((kernel_function, "kernel_function"),
                         (kernel_function_grad, "kernel_function_grad"),
                         (noise_function, "noise_function"),
                         (noise_function_grad, "noise_function_grad"),
                         (prior_mean_function, "prior_mean_function"),
                         (prior_mean_function_grad, "prior_mean_function_grad")):
            if not (callable(fn) or fn is None):
                raise AssertionError(f"wrong format in {name}")
        if len(x_data) != len(y_data):
            raise AssertionError("x_data and y_data do not have the same lengths.")

        if args is None:
            args = {}
        hyperparameters = init_hyperparameters

        # tier 1: data
        self.data = GPdata(x_data, y_data, args=args,
                           noise_variances=noise_variances,
                           ram_economy=ram_economy, gp2Scale=gp2Scale,
                           compute_device=compute_device,
                           gp2Scale_batch_size=gp2Scale_batch_size)

        if self.data.Euclidean:
            if callable(kernel_function) or callable(prior_mean_function) \
                    or callable(noise_function):
                if init_hyperparameters is None:
                    raise Exception(
                        "You have provided callables for kernel, mean, or noise "
                        "functions but no initial hyperparameters.")
            else:
                if init_hyperparameters is None:
                    hyperparameters = np.ones(self.index_set_dim + 1)
                    warnings.warn("Hyperparameters initialized to a vector of ones.")
        else:
            hyperparameters = init_hyperparameters
        if hyperparameters is None:
            raise Exception("'init_hyperparameters' not provided and could not "
                            "be calculated. Please provide them.")

        # tier 2: trainer (hyperparameter owner)
        self.trainer = GPtraining(self.data, hyperparameters)
        # tier 3: prior, likelihood, kv
        self.prior = GPprior(self.data, self.trainer,
                             kernel=kernel_function,
                             prior_mean_function=prior_mean_function,
                             kernel_grad=kernel_function_grad,
                             prior_mean_function_grad=prior_mean_function_grad,
                             gp2Scale_batch_size=gp2Scale_batch_size,
                             gp2Scale_distribution=gp2Scale_distribution)
        self.likelihood = GPlikelihood(self.data, self.trainer,
                                       noise_function=noise_function,
                                       noise_function_grad=noise_function_grad)
        self.kv = GPkv(self.data, self.prior, self.likelihood,
                       linalg_mode=linalg_mode)
        # tier 4: inference
        self.marginal_likelihood = GPMarginalLikelihood(
            self.data, self.prior, self.likelihood, self.trainer, self.kv)
        self.posterior = GPposterior(self.data, self.prior, self.trainer,
                                     self.kv, self.likelihood)

    # ----------------------------------------------------------------------
    # properties (ref gp.py:539-610)
    # ----------------------------------------------------------------------
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
    def index_set_dim(self):
        return self.data.index_set_dim

    @property
    def input_set_dim(self):
        return self.data.input_set_dim

    @property
    def mcmc_info(self):
        return self.trainer.mcmc_info

    @property
    def bo_info(self):
        """Diagnostics from the last synchronous ``method='bo'`` run
        (ref gp.py:564-578)."""
        return self.trainer.bo_info

    @property
    def args(self):
        return self.data.args

    @args.setter
    def args(self, args):
        self.data.args = args

    @property
    def K(self):
        return self.prior.K

    @property
    def m(self):
        return self.prior.m

    @property
    def V(self):
        return self.likelihood.V

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    @property
    def dask_client(self):
        """Always None — this build has no Dask; kept for API parity."""
        return None

    def initialize_gp2Scale_dask_client(self, gp2Scale=None, dask_client=None):
        """API-parity no-op (ref gp.py:2126-2134).  The reference lazily spins
        up a local ``dask.distributed`` cluster here; this build distributes
        the covariance over a ``jax.sharding.Mesh`` instead, so there is no
        client to create.  Returns the (ignored) ``dask_client`` argument."""
        return dask_client

    # ----------------------------------------------------------------------
    def set_args(self, new_args):
        """Change the advanced-settings dict.  New args do not invalidate
        cached state; see ref gp.py:613-632 for the flush idiom."""
        self.args = new_args

    def set_hyperparameters(self, hps):
        """Commit a hyperparameter vector and refresh prior/likelihood/kv
        (ref gp.py:635-650)."""
        if not (isinstance(hps, np.ndarray) and hps.ndim == 1):
            raise AssertionError("wrong format in hyperparameters")
        self.trainer.hyperparameters = np.asarray(hps, dtype=np.float64)
        self.prior.update_state_hyperparameters()
        self.likelihood.update_state()
        self.kv.update_state_hyperparameters()

    def update_gp_data(self, x_new, y_new, noise_variances_new=None,
                       append=True, rank_n_update=None):
        """Replace or extend the training data without rebuilding the GP
        (ref gp.py:652-712).

        Parameters
        ----------
        x_new, y_new, noise_variances_new :
            Same formats as the constructor.  With ``append=True`` they
            are appended; with ``append=False`` they replace the dataset.
        append : bool
            Appends are incremental: the prior only computes the new
            B (old×new) and D (new×new) covariance blocks, and the
            Cholesky factor is extended by a blocked rank-n trailing
            update instead of refactorizing.
        rank_n_update : bool, optional
            Defaults to ``append``.  Forced to ``False`` (with a warning)
            when ``append=False`` — the old factorization describes data
            that no longer exists.
        """
        if not isinstance(x_new, (list, np.ndarray)):
            raise AssertionError("wrong format in x_new")
        if not (isinstance(y_new, np.ndarray) and y_new.ndim in (1, 2)):
            raise AssertionError("wrong format in y_new")
        if not (isinstance(noise_variances_new, np.ndarray)
                or noise_variances_new is None):
            raise AssertionError("wrong format in noise_variances_new")
        if len(x_new) != len(y_new):
            raise AssertionError("updated x and y do not have the same lengths.")
        if (isinstance(noise_variances_new, np.ndarray)
                and len(noise_variances_new) != len(y_new)):
            raise AssertionError(
                "noise_variances_new and y_new do not have the same lengths.")
        # reject a column-count mismatch BEFORE delegating: GPdata vstacks x
        # first, so a failure inside the y vstack would leave the dataset
        # half-mutated (x extended, y not)
        y_cols_new = 1 if y_new.ndim == 1 else y_new.shape[1]
        y_cols_old = np.asarray(self.data.y_data).shape[1]
        if append and y_cols_new != y_cols_old:
            raise AssertionError(
                f"y_new has {y_cols_new} column(s) but the stored y_data has "
                f"{y_cols_old}; appended outputs must match.")
        if rank_n_update is None:
            rank_n_update = append
        if not append and rank_n_update:
            warnings.warn("`rank_n_update=True` is invalid when `append=False` "
                          "(the previous factorization belongs to data that no "
                          "longer exists). Forcing `rank_n_update=False`.")
            rank_n_update = False
        self.data.update(x_new, y_new, noise_variances_new, append=append)
        if append:
            self.prior.augment_state_data()
        else:
            self.prior.update_state_data()
        self.likelihood.update_state()
        self.kv.update_state_data(rank_n_update)
        self.marginal_likelihood.invalidate_traced()

    def _get_default_hyperparameter_bounds(self):
        """Data-driven bounds for the default kernel (ref gp.py:715-737)."""
        if not self.data.Euclidean:
            raise Exception("Please provide custom hyperparameter bounds to the "
                            "training in the non-Euclidean setting")
        if len(self.hyperparameters) != self.index_set_dim + 1:
            raise Exception("Please provide custom hyperparameter_bounds when "
                            "kernel, mean or noise functions are customized")
        bounds = np.zeros((self.index_set_dim + 1, 2))
        bounds[0] = np.array([np.var(self.y_data) / 100., np.var(self.y_data) * 10.])
        for i in range(self.index_set_dim):
            range_xi = np.max(self.x_data[:, i]) - np.min(self.x_data[:, i])
            bounds[i + 1] = np.array([range_xi / 100., range_xi * 10.])
        return bounds

    # ----------------------------------------------------------------------
    # training (ref gp.py:744-1073)
    # ----------------------------------------------------------------------
    def train(self, hyperparameter_bounds=None, objective_function=None,
              objective_function_gradient=None, objective_function_hessian=None,
              init_hyperparameters=None, method="mcmc", pop_size=20,
              tolerance=0.0001, max_iter=10000, mcmc_prior=None,
              mcmc_prop_distrs="normal", mcmc_args=None, bo_args=None,
              local_optimizer="L-BFGS-B", global_optimizer="genetic",
              constraints=(), dask_client=None, info=False, asynchronous=False):
        """Find hyperparameters by maximizing the log marginal likelihood
        (or a user objective), then commit them to the model
        (ref gp.py:744-1073).

        Parameters
        ----------
        hyperparameter_bounds : np.ndarray, optional
            ``(H, 2)`` box bounds.  Defaults are derived from the data
            (signal variance from ``var(y)``, lengthscales from per-axis
            input ranges) — valid only for the default kernel; custom
            callables must pass bounds explicitly.
        objective_function : Callable, optional
            ``f(hps) -> float`` to *minimize* instead of the negative log
            marginal likelihood.  Ignored (with a warning) by
            ``method='mcmc'``, which always samples the LML.
        objective_function_gradient, objective_function_hessian : Callable
            Required alongside a user objective for ``'local'``/``'hgdl'``;
            default to the (autodiff or FD) LML derivatives otherwise.
        init_hyperparameters : np.ndarray, optional
            Start vector; defaults to the current ``hyperparameters``, or
            a uniform draw inside the bounds if those are out of bounds.
        method : str or Callable
            * ``'global'`` — differential-evolution-style population
              search; the whole population is evaluated as one vmapped
              device program per generation.
            * ``'local'`` — scipy ``minimize`` (``local_optimizer``,
              default L-BFGS-B) on the fused ``value_and_grad`` program.
            * ``'hgdl'`` — HGDL-equivalent hybrid: vmapped multi-start
              Adam epochs on device + L-BFGS-B polish of the leaders.
            * ``'mcmc'`` (default) — adaptive-Metropolis sampling
              (:class:`~fvgp_tpu.models.gp_mcmc.gpMCMC`); returns the MAP
              draw and fills :attr:`mcmc_info`.
            * ``'adam'`` — projected Adam; on the gp2Scale path the whole
              K-step chain runs as one device program.
            * ``'bo'`` — Bayesian optimization of the LML for the
              expensive/noisy regime (SLQ logdet noise is fed to the
              surrogate automatically); fills :attr:`bo_info`.
            * a ``Callable(trainer)`` — bring your own optimizer: it
              receives the live ``GPtraining`` instance (objective,
              bounds, and start live on it) and returns the
              hyperparameter vector, exactly like the reference
              (ref gp_training.py:192).
        pop_size : int
            Population (``'global'``) / restarts (``'hgdl'``).
        tolerance, max_iter : float, int
            Convergence tolerance and iteration/evaluation budget,
            interpreted per method.
        mcmc_prior : Callable, optional
            ``log p(θ)`` for MCMC; default = uniform over the bounds.
        mcmc_prop_distrs : ``"normal"`` or list of ProposalDistribution
            Proposal machinery for MCMC (per-block proposals supported).
        mcmc_args : dict, optional
            Extra sampler settings (``n_updates``, ``break_condition``,
            ``n_chains`` for the vectorized multi-chain sampler, ...).
        bo_args : dict, optional
            BO settings (``n_init``, ``noise_function``, ...).
        local_optimizer, global_optimizer, constraints :
            Passed through to the scipy-driven stages.
        dask_client : ignored (parity).
        info : bool
            Print per-method progress.
        asynchronous : bool
            ``True`` (methods hgdl/mcmc/adam/bo) returns immediately with
            a pollable optimizer proxy running in a controller thread —
            poll with :meth:`update_hyperparameters`, stop with
            :meth:`stop_training` / :meth:`kill_client`.  Not available
            under gp2Scale (parity with the reference).

        Returns
        -------
        np.ndarray — the trained hyperparameters (already committed via
        :meth:`set_hyperparameters`), or the async optimizer proxy when
        ``asynchronous=True``.
        """
        if mcmc_args is None:
            mcmc_args = {}
        # gp2Scale guards (ref gp.py:934-949)
        if self.gp2Scale and asynchronous:
            asynchronous = False
            warnings.warn(f"gp2Scale does not allow asynchronous training "
                          f"(method=`{method}`)! `asynchronous` set to False.")
        if self.gp2Scale and method not in ("mcmc", "bo"):
            # the reference forces MCMC here (ref gp.py:947-949) because its
            # sparse path has no gradient.  Our sparse LML is differentiable
            # (ops/sparse_lml mBCG custom VJP), so gradient-based training
            # stays available whenever the kernel is jax-traceable.
            if not self.marginal_likelihood._sparse_traced_ready():
                warnings.warn("gp2Scale enabled with a non-traceable kernel. "
                              "Method switched to MCMC!")
                method = "mcmc"

        _async_methods = {"hgdl", "mcmc", "adam", "bo"}
        if asynchronous and method not in _async_methods:
            warnings.warn(f"Asynchronous execution is not supported for "
                          f"method=`{method}`. Supported: "
                          f"{sorted(_async_methods)}. `asynchronous` set to False.")
            asynchronous = False

        if hyperparameter_bounds is None:
            hyperparameter_bounds = self._get_default_hyperparameter_bounds()
            warnings.warn("Default hyperparameter_bounds initialized because "
                          "none were provided. This will fail for custom "
                          "kernel, mean, or noise functions")
        if init_hyperparameters is None:
            if out_of_bounds(self.hyperparameters, hyperparameter_bounds):
                init_hyperparameters = np.random.uniform(
                    low=hyperparameter_bounds[:, 0],
                    high=hyperparameter_bounds[:, 1],
                    size=len(hyperparameter_bounds))
            else:
                init_hyperparameters = self.hyperparameters
        elif out_of_bounds(init_hyperparameters, hyperparameter_bounds):
            warnings.warn("Your init_hyperparameters are out of bounds. "
                          "They will be over-written")
            init_hyperparameters = np.random.uniform(
                low=hyperparameter_bounds[:, 0],
                high=hyperparameter_bounds[:, 1],
                size=len(hyperparameter_bounds))

        user_provided_obj = objective_function is not None
        if method == "mcmc":
            if user_provided_obj:
                warnings.warn("MCMC always optimizes the log marginal likelihood; "
                              "the user-defined objective_function is ignored.")
                # the run samples the default LML, so the batched/fused
                # device programs (vectorized multi-chain path) apply
                user_provided_obj = False
            objective_function = self.marginal_likelihood.log_likelihood
        elif objective_function is None:
            objective_function = self.marginal_likelihood.neg_log_likelihood
        if user_provided_obj and objective_function_gradient is None \
                and method in ("local", "hgdl"):
            raise Exception("A gradient (and Hessian) of the objective function "
                            "must be provided for method='local' or method='hgdl'.")
        if objective_function_gradient is None:
            objective_function_gradient = \
                self.marginal_likelihood.neg_log_likelihood_gradient
        if objective_function_hessian is None:
            objective_function_hessian = \
                self.marginal_likelihood.neg_log_likelihood_hessian

        # feed the SLQ estimator's own precision to BO (ref gp.py:999-1016)
        if method == "bo" and not user_provided_obj:
            bo_args = dict(bo_args or {})
            if "noise_function" not in bo_args and "noise_variance" not in bo_args:
                _ml = self.marginal_likelihood

                def _estimator_noise(hps, _ml=_ml):
                    return _ml.log_likelihood_variance()

                bo_args["noise_function"] = _estimator_noise

        if method == "bo":
            self._warn_about_bo_suitability(hyperparameter_bounds, max_iter, bo_args)

        # fused device programs for the default objective
        fused_vg = None
        batched_objective = None
        batched_vg = None
        if not user_provided_obj and self.marginal_likelihood._traced_ready():
            ml = self.marginal_likelihood

            def fused_vg(hps, _ml=ml):
                val, grad = _ml.log_likelihood_value_and_gradient(hps)
                return -val, -grad

            def batched_objective(P, _ml=ml):
                return _ml.batched_neg_log_likelihood(P)

            batched_vg = ml.batched_value_and_grad_device()
        adam_chain_runner = None
        if (not user_provided_obj
                and self.marginal_likelihood._sparse_traced_ready()):
            ml = self.marginal_likelihood

            def fused_vg(hps, _ml=ml):
                val, grad = _ml.log_likelihood_value_and_gradient(hps)
                return -val, -grad

            def adam_chain_runner(theta, m, v, t, steps, bounds, _ml=ml):
                # K Adam steps per device program (sparse path; see
                # GPMarginalLikelihood.sparse_adam_steps)
                return _ml.sparse_adam_steps(theta, m, v, t, steps,
                                             bounds=bounds)

        common = dict(
            objective_function=objective_function,
            objective_function_gradient=objective_function_gradient,
            objective_function_hessian=objective_function_hessian,
            hyperparameter_bounds=np.asarray(hyperparameter_bounds, dtype=np.float64),
            init_hyperparameters=np.asarray(init_hyperparameters, dtype=np.float64),
            method=method, pop_size=pop_size, tolerance=tolerance,
            max_iter=max_iter, mcmc_prior=mcmc_prior,
            mcmc_prop_distrs=mcmc_prop_distrs, mcmc_args=mcmc_args,
            bo_args=bo_args, local_optimizer=local_optimizer,
            global_optimizer=global_optimizer, constraints=constraints,
            info=info)

        if not asynchronous:
            with sequential_linalg_state(self.args, method):
                hyperparameters = self.trainer.train(
                    dask_client=None, batched_objective=batched_objective,
                    fused_value_and_grad=fused_vg,
                    batched_value_and_grad=batched_vg,
                    adam_chain_runner=adam_chain_runner, **common)
                self.set_hyperparameters(hyperparameters)
                return hyperparameters
        # the sequential-state gate must live as long as the BACKGROUND run:
        # entering it here and restoring on return would re-enable warm
        # starts microseconds into the async training (the actor wraps its
        # whole thread in this context instead)
        common.pop("constraints")
        common.pop("global_optimizer")
        return self.trainer.train_async(
            dask_client=dask_client, fused_value_and_grad=fused_vg,
            global_optimizer=global_optimizer, constraints=constraints,
            run_context=lambda: sequential_linalg_state(self.args, method),
            **common)

    @staticmethod
    def _warn_about_bo_suitability(hyperparameter_bounds, max_iter, bo_args):
        """Pre-flight warnings for method='bo' degradation modes
        (ref gp.py:1076-1137)."""
        from .gp_bo import default_initial_design_size
        n_hps = len(hyperparameter_bounds)
        n_init = int((bo_args or {}).get(
            "n_init", default_initial_design_size(n_hps, max_iter)))
        n_init = max(2, min(n_init, max_iter))
        if n_init >= max_iter:
            warnings.warn(
                f"method='bo' has a budget of {max_iter} evaluations but its "
                f"space-filling initial design alone needs {n_init} for {n_hps} "
                f"hyperparameters, so the entire budget goes to that design and "
                f"no Bayesian optimization is performed — this is random "
                f"search. Raise max_iter well above {n_init}, or lower "
                f"bo_args['n_init'].")
        if n_hps > 20:
            warnings.warn(
                f"method='bo' is being asked to tune {n_hps} hyperparameters. "
                f"Bayesian optimization is intended for a handful up to roughly "
                f"20; beyond that the result degrades without any error being "
                f"raised. Consider 'mcmc' or 'global', or reduce the number of "
                f"trained hyperparameters.")
        elif n_hps > 10:
            warnings.warn(
                f"method='bo' is being asked to tune {n_hps} hyperparameters, "
                f"which is at the edge of what it does well. Expect a less "
                f"precise optimum than at 2-5 and give it a larger max_iter.")

    def stop_training(self, opt_obj):
        """Stop an asynchronous training run (ref gp.py:1140-1150)."""
        self.trainer.stop_training(opt_obj)

    def kill_client(self, opt_obj):
        """Stop an asynchronous run and release its resources
        (ref gp.py:1153-1163)."""
        self.trainer.kill_client(opt_obj)

    def update_hyperparameters(self, opt_obj):
        """Pull the latest hyperparameters from a running async optimizer and
        commit them (ref gp.py:1166-1183)."""
        hps = self.trainer.update_hyperparameters(opt_obj)
        self.set_hyperparameters(hps)
        return hps

    def get_hyperparameters(self):
        """Deprecated accessor (ref gp.py:1186-1199)."""
        warnings.warn("`get_hyperparameters()` is deprecated. Please use "
                      "`hyperparameters`", DeprecationWarning, stacklevel=2)
        return self.hyperparameters

    def get_prior_pdf(self):
        """(ref gp.py:1202-1213)."""
        return {"prior covariance (K)": self.prior.K, "prior mean": self.prior.m}

    def log_likelihood(self, hyperparameters=None):
        """(ref gp.py:1215-1235)."""
        if hyperparameters is not None:
            if not (isinstance(hyperparameters, np.ndarray)
                    and hyperparameters.ndim == 1):
                raise AssertionError("wrong format in hyperparameters")
        return self.marginal_likelihood.log_likelihood(hyperparameters=hyperparameters)

    def neg_log_likelihood_gradient(self, hyperparameters=None, component=0):
        """(ref gp.py:1237-1254)."""
        return self.marginal_likelihood.neg_log_likelihood_gradient(
            hyperparameters=hyperparameters, component=component)

    def test_log_likelihood_gradient(self, hyperparameters, epsilon=1e-6):
        """(ref gp.py:1256-1274)."""
        if not (isinstance(hyperparameters, np.ndarray)
                and hyperparameters.ndim == 1):
            raise AssertionError("wrong format in hyperparameters")
        return self.marginal_likelihood.test_log_likelihood_gradient(
            hyperparameters, epsilon=epsilon)

    # ----------------------------------------------------------------------
    # posterior delegators (ref gp.py:1281-1653)
    # ----------------------------------------------------------------------
    def posterior_mean(self, x_pred, hyperparameters=None, x_out=None):
        """Posterior mean ``m(x*) + k(x*, X)ᵀ (K+V)⁻¹ (y − m)`` at the
        prediction points (ref gp.py:1281).

        Parameters
        ----------
        x_pred : np.ndarray ``(M, D)`` or list of objects (non-Euclidean).
        hyperparameters : np.ndarray, optional
            One-off override: K, V, m and the solve are recomputed at
            this θ for *this call only* — nothing is committed.  Useful
            inside objective functions and for what-if evaluation.
        x_out : np.ndarray, optional
            1-D output coordinates for multi-task models (see
            :class:`fvGP`); predictions are formed over the cartesian
            product ``x_pred × x_out``.

        Returns
        -------
        dict with ``"x"`` (your input), ``"m(x)"`` (``(M,)``, or
        ``(M, len(x_out))`` task-major), ``"m(x)_flat"`` (the flattened
        product-space vector) and ``"x_pred"`` (the product-space points).
        """
        return self.posterior.posterior_mean(x_pred, hyperparameters=hyperparameters,
                                             x_out=x_out)

    def posterior_mean_grad(self, x_pred, hyperparameters=None, x_out=None,
                            direction=None, component=0):
        """Gradient of the posterior mean with respect to the *input*
        ``x`` (ref gp.py:1311).  ``direction=i`` returns ``dm/dx_i``
        (shape ``(M,)``); ``direction=None`` returns all directions
        (``(M, D)``).  Returns dict with ``"x"``, ``"direction"``,
        ``"dm/dx"``."""
        return self.posterior.posterior_mean_grad(
            x_pred, hyperparameters=hyperparameters, x_out=x_out,
            direction=direction, component=component)

    def posterior_covariance(self, x_pred, x_out=None, variance_only=False,
                             add_noise=False):
        """Posterior covariance ``S = k(x*,x*) − k(x*,X)ᵀ(K+V)⁻¹k(x*,X)``
        (ref gp.py:1338).

        Parameters
        ----------
        x_pred : np.ndarray ``(M, D)`` or list of objects.
        x_out : np.ndarray, optional — multi-task output coordinates.
        variance_only : bool
            ``True`` skips the full M×M matrix; when the explicit inverse
            is stored (``linalg_mode='CholInv'``) the variances come from
            a single einsum without any solve.
        add_noise : bool
            Add the noise model evaluated at ``x_pred`` to ``v``/``S``
            (predictive distribution of *observations*).

        Returns
        -------
        dict with ``"v(x)"`` (variances, clipped at 0 with a warning if
        negative values appear), ``"S"`` (``(M, M)``, or task-major
        ``(M, M, T, T)``; ``None`` if ``variance_only``), and the
        flattened ``"v_flat"``/``"S_flat"``.  Under gp2Scale the
        cross-solve is chunked so memory stays bounded at large M.
        """
        return self.posterior.posterior_covariance(
            x_pred, x_out=x_out, variance_only=variance_only, add_noise=add_noise)

    def posterior_covariance_grad(self, x_pred, x_out=None, direction=None):
        """Gradient of the posterior (co)variance w.r.t. the input
        (ref gp.py:1368): dict with ``"dv/dx"`` and, for a single
        ``direction``, ``"dS/dx"``."""
        return self.posterior.posterior_covariance_grad(x_pred, x_out=x_out,
                                                        direction=direction)

    def joint_gp_prior(self, x_pred, x_out=None):
        """Joint *prior* over data + prediction points (ref gp.py:1398):
        dict with the blocks ``"K"``, ``"k"``, ``"kappa"``, the joint
        ``"prior mean"`` and the stacked joint covariance ``"S"``."""
        return self.posterior.joint_gp_prior(x_pred, x_out=x_out)

    def joint_gp_prior_grad(self, x_pred, direction, x_out=None):
        """Input-gradient of the joint prior blocks (ref gp.py:1429)."""
        return self.posterior.joint_gp_prior_grad(x_pred, direction, x_out=x_out)

    def gp_entropy(self, x_pred, x_out=None):
        """Differential entropy ``½ log det(2πe·K(x*,x*))`` of the prior
        at the prediction points (ref gp.py:1459)."""
        return self.posterior.gp_entropy(x_pred, x_out=x_out)

    def gp_entropy_grad(self, x_pred, direction, x_out=None):
        """Input-direction gradient of :meth:`gp_entropy`
        (ref gp.py:1480)."""
        return self.posterior.gp_entropy_grad(x_pred, direction, x_out=x_out)

    def gp_kl_div(self, x_pred, comp_mean, comp_cov, x_out=None):
        """KL divergence between the GP posterior at ``x_pred`` and a
        comparison Gaussian ``N(comp_mean, comp_cov)`` (ref gp.py:1501).
        Returns dict with ``"kl-div"`` and the posterior moments used."""
        return self.posterior.gp_kl_div(x_pred, comp_mean, comp_cov, x_out=x_out)

    def gp_mutual_information(self, x_pred, x_out=None, add_noise=False):
        """Mutual information ``I(f(X); f(x*))`` between the data and the
        prediction points under the joint prior (ref gp.py:1541)."""
        return self.posterior.gp_mutual_information(x_pred, x_out=x_out,
                                                    add_noise=add_noise)

    def gp_total_correlation(self, x_pred, x_out=None, add_noise=False):
        """Multivariate generalization of mutual information over
        data + predictions jointly (ref gp.py:1566)."""
        return self.posterior.gp_total_correlation(x_pred, x_out=x_out,
                                                   add_noise=add_noise)

    def gp_relative_information_entropy(self, x_pred, x_out=None, add_noise=False):
        """KL divergence of the posterior from the prior at ``x_pred`` —
        how much the data taught the model about these points
        (ref gp.py:1591).  Returns dict with ``"RIE"``."""
        return self.posterior.gp_relative_information_entropy(
            x_pred, x_out=x_out, add_noise=add_noise)

    def gp_relative_information_entropy_set(self, x_pred, x_out=None,
                                            add_noise=False):
        """Pointwise variant of :meth:`gp_relative_information_entropy`:
        one RIE value per prediction point, each computed as a singleton
        set (ref gp.py:1617)."""
        return self.posterior.gp_relative_information_entropy_set(
            x_pred, x_out=x_out, add_noise=add_noise)

    def posterior_probability(self, x_pred, comp_mean, comp_cov, x_out=None):
        """Probability that the posterior and the Gaussian
        ``N(comp_mean, comp_cov)`` describe the same function values
        (ref gp.py:1643): dict with the fused ``"mu"``/``"covariance"``
        and ``"probability"``."""
        return self.posterior.posterior_probability(x_pred, comp_mean, comp_cov,
                                                    x_out=x_out)

    # ----------------------------------------------------------------------
    # validation metrics (ref gp.py:1659-1976)
    # ----------------------------------------------------------------------
    @staticmethod
    def _crps_s(x, mu, sigma):
        res = abs(sigma * ((1. / np.sqrt(np.pi))
                           - 2. * norm.pdf((x - mu) / sigma)
                           - (((x - mu) / sigma)
                              * (2. * norm.cdf((x - mu) / sigma) - 1.))))
        return np.mean(res), np.sqrt(np.var(res))

    def crps(self, x_test, y_test):
        """Continuous rank probability score (ref gp.py:1666)."""
        mean = self.posterior_mean(x_test)["m(x)"]
        sigma = np.sqrt(self.posterior_covariance(x_test)["v(x)"])
        if not (mean.shape == sigma.shape == y_test.shape):
            raise AssertionError(f"crps: shape mismatch mean={mean.shape} "
                                 f"sigma={sigma.shape} y_test={y_test.shape}")
        return self._crps_s(y_test, mean, sigma)

    def rmse(self, x_test, y_test):
        """Root mean squared error (ref gp.py:1689)."""
        v1, v2 = y_test, self.posterior_mean(x_test)["m(x)"]
        if v1.shape != v2.shape:
            raise AssertionError(f"rmse: y_test shape {v1.shape} != posterior "
                                 f"mean shape {v2.shape}")
        return np.sqrt(np.sum((v1 - v2) ** 2) / v1.size)

    def nrmse(self, x_test, y_test):
        """Normalized RMSE (ref gp.py:1712)."""
        return self.rmse(x_test, y_test) / (np.max(y_test) - np.min(y_test))

    def nlpd(self, x_test, y_test):
        """Negative log predictive density (ref gp.py:1732)."""
        mean = self.posterior_mean(x_test)["m(x)"]
        v = self.posterior_covariance(x_test)["v(x)"]
        if not (mean.shape == v.shape == y_test.shape):
            raise AssertionError(f"nlpd: shape mismatch mean={mean.shape} "
                                 f"v={v.shape} y_test={y_test.shape}")
        return np.mean(0.5 * np.log(2 * np.pi * v)
                       + 0.5 * ((y_test - mean) ** 2) / v)

    def r2(self, x_test, y_test):
        """R² prediction score (ref gp.py:1759)."""
        y_pred = self.posterior_mean(x_test)["m(x)"]
        if y_pred.shape != y_test.shape:
            raise AssertionError(f"r2: y_test shape {y_test.shape} != posterior "
                                 f"mean shape {y_pred.shape}")
        ss_res = np.sum((y_test - y_pred) ** 2)
        ss_tot = np.sum((y_test - np.mean(y_test)) ** 2)
        return 1. - ss_res / ss_tot

    def picp(self, x_test, y_true, interval=0.95):
        """Prediction-interval coverage probability (ref gp.py:1781)."""
        mu = self.posterior_mean(x_test)["m(x)"]
        y_true = np.asarray(y_true)
        assert y_true.shape == np.asarray(mu).shape, (
            f"y shape {y_true.shape} does not match posterior mean shape "
            f"{np.asarray(mu).shape}")   # a (M,1)-vs-(M,) broadcast would
        # silently average M^2 cross-pair comparisons
        sigma = np.sqrt(self.posterior_covariance(x_test, add_noise=True)["v(x)"])
        z = norm.ppf(1 - (1 - interval) / 2)
        lower, upper = mu - z * sigma, mu + z * sigma
        return np.mean((y_true >= lower) & (y_true <= upper))

    def coverage_curve(self, x_test, y_test, intervals=None):
        """Calibration curve over coverage levels (ref gp.py:1815)."""
        if intervals is None:
            intervals = np.linspace(0.05, 0.95, 19)
        return {"target_coverage": list(intervals),
                "measured_coverage": [self.picp(x_test, y_test, interval=q)
                                      for q in intervals]}

    def mpiw(self, x_test, interval=0.95):
        """Mean prediction-interval width (ref gp.py:1842)."""
        v = self.posterior_covariance(x_test, add_noise=True)["v(x)"]
        sigma = np.sqrt(np.clip(v, 0.0, None))
        z = norm.ppf(1 - (1 - interval) / 2)
        return np.mean(2 * z * sigma)

    def interval_score(self, x_test, y_test, interval=0.95):
        """Winkler interval score (ref gp.py:1865)."""
        mean = self.posterior_mean(x_test)["m(x)"]
        sigma = np.sqrt(self.posterior_covariance(x_test, add_noise=True)["v(x)"])
        if not (mean.shape == sigma.shape == y_test.shape):
            raise AssertionError(f"interval_score: shape mismatch "
                                 f"mean={mean.shape} sigma={sigma.shape} "
                                 f"y_test={y_test.shape}")
        alpha = 1 - interval
        z = norm.ppf(1 - alpha / 2)
        lower, upper = mean - z * sigma, mean + z * sigma
        width = upper - lower
        penalty_low = (2 / alpha) * np.maximum(lower - y_test, 0)
        penalty_high = (2 / alpha) * np.maximum(y_test - upper, 0)
        return np.mean(width + penalty_low + penalty_high)

    def mae(self, x_test, y_test):
        """Mean absolute error (ref gp.py:1899)."""
        v1, v2 = y_test, self.posterior_mean(x_test)["m(x)"]
        if v1.shape != v2.shape:
            raise AssertionError(f"mae: y_test shape {v1.shape} != posterior "
                                 f"mean shape {v2.shape}")
        return np.mean(np.abs(v1 - v2))

    def mape(self, x_test, y_test):
        """Mean absolute percentage error (ref gp.py:1921)."""
        v1, v2 = y_test, self.posterior_mean(x_test)["m(x)"]
        if v1.shape != v2.shape:
            raise AssertionError(f"mape: y_test shape {v1.shape} != posterior "
                                 f"mean shape {v2.shape}")
        return np.mean(np.abs((v1 - v2) / v1))

    def msll(self, x_test, y_test):
        """Mean standardized log loss (ref gp.py:1945)."""
        mean = self.posterior_mean(x_test)["m(x)"]
        v = self.posterior_covariance(x_test)["v(x)"]
        if not (mean.shape == v.shape == y_test.shape):
            raise AssertionError(f"msll: shape mismatch mean={mean.shape} "
                                 f"v={v.shape} y_test={y_test.shape}")
        nlpd_gp = np.mean(0.5 * np.log(2 * np.pi * v)
                          + 0.5 * ((y_test - mean) ** 2) / v)
        baseline_mean = np.mean(self.y_data)
        baseline_var = np.var(self.y_data)
        nlpd_baseline = np.mean(0.5 * np.log(2 * np.pi * baseline_var)
                                + 0.5 * ((y_test - baseline_mean) ** 2)
                                / baseline_var)
        return nlpd_gp - nlpd_baseline

    def plot_observed_vs_predicted(self, x_test, y_test, title=None, ax=None):
        """Observed-vs-predicted scatter with 1σ bars (ref gp.py:1978)."""
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            warnings.warn("matplotlib is not installed; cannot create "
                          "observed-vs-predicted plot.")
            return
        y_pred = self.posterior_mean(x_test)["m(x)"]
        y_var = self.posterior_covariance(x_test, add_noise=True)["v(x)"]
        y_obs_flat = np.asarray(y_test).reshape(-1)
        y_pred_flat = np.asarray(y_pred).reshape(-1)
        y_sigma_flat = np.sqrt(np.clip(np.asarray(y_var).reshape(-1), 0.0, None))
        if ax is None:
            _, ax = plt.subplots(figsize=(6, 6))
        ax.errorbar(y_obs_flat, y_pred_flat, yerr=y_sigma_flat, fmt="o",
                    alpha=0.6, markersize=4, capsize=2, elinewidth=0.8,
                    label="prediction ± 1σ")
        lo = float(min(y_obs_flat.min(), (y_pred_flat - y_sigma_flat).min()))
        hi = float(max(y_obs_flat.max(), (y_pred_flat + y_sigma_flat).max()))
        ax.plot([lo, hi], [lo, hi], "k--", linewidth=1, label="y = x")
        ax.set_xlabel("Observed")
        ax.set_ylabel("Predicted")
        if title is not None:
            ax.set_title(title)
        ax.set_aspect("equal", adjustable="box")
        ax.legend(loc="best")

    # ----------------------------------------------------------------------
    # conveniences (ref gp.py:2035-2124)
    # ----------------------------------------------------------------------
    @staticmethod
    def gaussian_1d(x, mu, sigma):
        coefficient = 1.0 / (np.sqrt(2 * np.pi) * sigma)
        exponent = -((x - mu) ** 2) / (2 * sigma ** 2)
        return coefficient * np.exp(exponent)

    @staticmethod
    def make_2d_x_pred(bx, by, resx=100, resy=100):
        from itertools import product
        x = np.linspace(bx[0], bx[1], resx)
        y = np.linspace(by[0], by[1], resy)
        return np.array(list(product(x, y)))

    @staticmethod
    def make_1d_x_pred(b, res=100):
        return np.linspace(b[0], b[1], res).reshape(res, -1)

    def get_gp2Scale_exec_time(self, time_per_worker_execution, number_of_workers):
        """Covariance wall-clock cost model t = D²·t_block/(2·n·batch²)
        (ref gp.py:2104-2124); here, "workers" are devices."""
        b = self.prior.batch_size
        D = len(self.x_data)
        return (D ** 2 * time_per_worker_execution) / (2. * number_of_workers * b ** 2)

    # ----------------------------------------------------------------------
    def __getstate__(self):
        return dict(data=self.data, prior=self.prior, likelihood=self.likelihood,
                    kv=self.kv, marginal_likelihood=self.marginal_likelihood,
                    trainer=self.trainer, posterior=self.posterior)

    def __setstate__(self, state):
        self.__dict__.update(state)
