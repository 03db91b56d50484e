"""Training dispatcher (parity target: /root/reference/fvgp/gp_training.py).

Methods: ``global`` (differential evolution — population evaluated as ONE
vmapped device call when the LML is traced, replacing scipy's sequential
loop), ``local`` (L-BFGS-B over a fused jitted value_and_grad), ``hgdl``
(the HGDL-package replacement: vmapped multi-start — a population of local
optimizers advancing in lockstep on device — plus local polish), ``mcmc``
(adaptive Metropolis), ``adam``, ``bo`` (Bayesian optimization), and a user
callable.  Async variants run the same code in daemon threads with the
get_latest()/stop() polling contract (gp_actor).
"""

import warnings

import numpy as np
from scipy.optimize import minimize

from .gp_actor import (AsyncOptimizer, _AdamActor, _BOActor, _MCMCActor,
                       _MultistartActor)
from .gp_bo import bayesian_optimize
from .gp_mcmc import gpMCMC

class GPtraining:
    def __init__(self, data, hyperparameters):
        self.mcmc_info = None
        self.bo_info = None
        self.data = data
        self.hyperparameters = np.asarray(hyperparameters, dtype=np.float64)

    @property
    def args(self):
        return self.data.args

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    # ------------------------------------------------------------------
    def train(self, objective_function=None, objective_function_gradient=None,
              objective_function_hessian=None, hyperparameter_bounds=None,
              init_hyperparameters=None, method="global", pop_size=20,
              tolerance=0.0001, max_iter=120, local_optimizer="L-BFGS-B",
              global_optimizer="genetic", constraints=(), mcmc_prior=None,
              mcmc_prop_distrs="normal", mcmc_args=None, bo_args=None,
              dask_client=None, info=False,
              batched_objective=None, fused_value_and_grad=None,
              batched_value_and_grad=None, adam_chain_runner=None):
        """Synchronous training; returns the optimized hyperparameters
        (ref gp_training.py:28-196)."""
        if mcmc_args is None:
            mcmc_args = {}
        if not self._in_bounds(init_hyperparameters, hyperparameter_bounds):
            raise Exception("Starting positions outside of optimization bounds.",
                            init_hyperparameters, hyperparameter_bounds)

        if method == "global":
            hyperparameters = self._differential_evolution(
                objective_function, hyperparameter_bounds, init_hyperparameters,
                pop_size=pop_size, tol=tolerance, max_iter=max_iter, info=info,
                batched_objective=batched_objective, constraints=constraints)
        elif method == "local":
            progress = None
            if info:
                state = {"i": 0}

                def progress(intermediate_result):
                    state["i"] += 1
                    print(f"fvgp_tpu local iteration {state['i']}: "
                          f"f(x)= {float(intermediate_result.fun)}")
            fun, jac = self._fun_and_jac(objective_function,
                                         objective_function_gradient,
                                         fused_value_and_grad)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = minimize(fun, init_hyperparameters, method=local_optimizer,
                               jac=jac, hess=objective_function_hessian,
                               bounds=hyperparameter_bounds, tol=tolerance,
                               callback=progress, constraints=constraints,
                               options={"maxiter": max_iter})
            hyperparameters = res["x"]
        elif method == "hgdl":
            optima = self.multistart_optimize(
                objective_function, objective_function_gradient,
                hyperparameter_bounds, init_hyperparameters,
                n_starts=max(pop_size, 4), epochs=max_iter,
                tolerance=tolerance, local_optimizer=local_optimizer,
                fused_value_and_grad=fused_value_and_grad, info=info,
                batched_value_and_grad=batched_value_and_grad,
                constraints=constraints)
            hyperparameters = optima[0]["x"]
        elif method == "mcmc":
            n_chains = int(mcmc_args.get("n_chains", 1))
            if n_chains > 1 and batched_objective is not None \
                    and mcmc_prior is None and mcmc_prop_distrs == "normal":
                # parallel chains: one vmapped device call evaluates every
                # chain's proposal (gp_mcmc.run_mcmc_vectorized)
                from .gp_mcmc import run_mcmc_vectorized
                bounds = np.asarray(hyperparameter_bounds, dtype=np.float64)
                rng = np.random.default_rng(11)
                x0s = rng.uniform(bounds[:, 0], bounds[:, 1],
                                  size=(n_chains, len(bounds)))
                x0s[0] = np.asarray(init_hyperparameters, dtype=np.float64)
                res = run_mcmc_vectorized(
                    lambda X: -np.asarray(batched_objective(X)),
                    bounds, x0s, n_updates=max_iter, info=info)
                hyperparameters = res["median(x)"]
                self.mcmc_info = res
                return np.asarray(hyperparameters)

            def prior_function(theta, bounds, args):
                return 0. if self._in_bounds(theta, bounds) else -np.inf

            def likelihood_func(hps, args):
                return objective_function(hps)

            if mcmc_prior is not None:
                prior_function = mcmc_prior
            sampler = gpMCMC(likelihood_func, prior_function=prior_function,
                             proposal_distributions=mcmc_prop_distrs,
                             bounds=hyperparameter_bounds, args=mcmc_args)
            res = sampler.run_mcmc(x0=init_hyperparameters, n_updates=max_iter,
                                   info=info, break_condition="default")
            hyperparameters = res["median(x)"]
            self.mcmc_info = res
        elif method == "adam":
            chain_steps = int(self.args.get("adam_chain_steps", 8))
            if adam_chain_runner is not None and chain_steps > 1:
                # device-chained Adam: chain_steps steps per compiled
                # program (sparse traced path; the host loop's per-step
                # dispatch costs as much as an N=50k evaluation itself)
                theta = np.asarray(init_hyperparameters, np.float64).copy()
                m = np.zeros_like(theta)
                v = np.zeros_like(theta)
                bounds = np.asarray(hyperparameter_bounds, np.float64)
                t = 0
                # full chunks only: a ragged final chunk would compile a
                # second program for a handful of steps — but never MORE
                # steps than the user's budget
                chain_steps = min(chain_steps, max(int(max_iter), 1))
                n_chunks = max(1, int(max_iter) // chain_steps)
                for _ in range(n_chunks):
                    k = chain_steps
                    theta_new, m, v, fvals = adam_chain_runner(
                        theta, m, v, t, k, bounds)
                    t += k
                    step_norm = np.linalg.norm(theta_new - theta) / k
                    theta = theta_new
                    if info:
                        print(f"fvgp_tpu adam (device chain) iteration {t} "
                              f"out of {max_iter}: f(x)= {float(fvals[-1])}")
                    if step_norm < tolerance * 1e-2:
                        break
                hyperparameters = theta
            else:
                adam_progress = None
                if info:
                    def adam_progress(theta, fval, grad, iteration):
                        if iteration % 10 == 0 or iteration == 1:
                            print(f"fvgp_tpu adam iteration {iteration} out of "
                                  f"{max_iter}: f(x)= {float(fval)}, "
                                  f"|grad|= {float(np.linalg.norm(grad))}")
                obj_fn, grad_fn = objective_function, objective_function_gradient
                if fused_value_and_grad is not None:
                    # one device call per step instead of two: adam_optimize
                    # always evaluates value then gradient at the SAME theta
                    memo = {}

                    def obj_fn(theta, _f=fused_value_and_grad, _m=memo):
                        v, g = _f(np.asarray(theta))
                        _m["g"] = (np.asarray(theta).tobytes(), g)
                        return v

                    def grad_fn(theta, _f=fused_value_and_grad, _m=memo):
                        key = np.asarray(theta).tobytes()
                        hit = _m.get("g")
                        if hit is not None and hit[0] == key:
                            return hit[1]
                        return _f(np.asarray(theta))[1]
                hyperparameters, _ = self.adam_optimize(
                    obj_fn, grad_fn,
                    init_hyperparameters, max_iter=max_iter,
                    callback=adam_progress)
        elif method == "bo":
            hyperparameters, self.bo_info = bayesian_optimize(
                objective_function, hyperparameter_bounds, init_hyperparameters,
                max_iter=max_iter, bo_args=bo_args, info=info)
        elif callable(method):
            hyperparameters = method(self)
        else:
            raise ValueError("No optimization mode specified in fvgp_tpu")
        hyperparameters = np.asarray(hyperparameters)
        if hyperparameters.ndim != 1:
            raise AssertionError("Optimizer returned invalid hyperparameters: "
                                 + str(hyperparameters))
        return hyperparameters

    # ------------------------------------------------------------------
    @staticmethod
    def _fun_and_jac(objective, gradient, fused):
        """scipy calls f and g separately; a fused jitted value_and_grad
        halves the device work by caching the pair."""
        if fused is None:
            return objective, gradient
        cache = {}

        def fun(x):
            key = x.tobytes()
            if key not in cache:
                cache.clear()
                cache[key] = fused(x)
            return cache[key][0]

        def jac(x):
            key = x.tobytes()
            if key not in cache:
                cache.clear()
                cache[key] = fused(x)
            return np.asarray(cache[key][1])

        return fun, jac

    # ------------------------------------------------------------------
    @staticmethod
    def _constraint_violation(constraints, x):
        """Total violation of scipy-style constraints at x: 0 when feasible.
        Accepts NonlinearConstraint/LinearConstraint objects and the
        dict convention ({'type': 'ineq'|'eq', 'fun': ...}) — the same
        objects the reference forwarded to scipy/HGDL
        (ref gp_training.py:66-77, :131-138)."""
        total = 0.0
        for c in (constraints or ()):
            if isinstance(c, dict):
                val = np.atleast_1d(np.asarray(c["fun"](x), dtype=np.float64))
                if c.get("type", "ineq") == "eq":
                    total += float(np.sum(np.abs(val)))
                else:                      # ineq convention: fun(x) >= 0
                    total += float(np.sum(np.maximum(-val, 0.0)))
                continue
            val = np.atleast_1d(np.asarray(
                c.fun(x) if callable(getattr(c, "fun", None)) else c.A @ x,
                dtype=np.float64))
            lb = np.broadcast_to(np.atleast_1d(c.lb), val.shape)
            ub = np.broadcast_to(np.atleast_1d(c.ub), val.shape)
            total += float(np.sum(np.maximum(lb - val, 0.0))
                           + np.sum(np.maximum(val - ub, 0.0)))
        return total

    def _differential_evolution(self, objective, bounds, x0, pop_size=20,
                                tol=1e-4, max_iter=120, info=False,
                                batched_objective=None, constraints=()):
        """best/1/bin differential evolution.  With a batched objective the
        whole population is one vmapped device call per generation — the GPU
        evaluates pop_size·H Choleskys in a single batched program
        (replaces scipy differential_evolution, ref gp_training.py:60-80).
        Constraints are honored by Deb's feasibility rules, matching scipy
        differential_evolution's behavior: feasible beats infeasible,
        infeasible candidates compete on total violation."""
        bounds = np.asarray(bounds, dtype=np.float64)
        H = len(bounds)
        NP = max(4, int(pop_size) * H)
        rng = np.random.default_rng(42)
        pop = rng.uniform(bounds[:, 0], bounds[:, 1], size=(NP, H))
        pop[0] = np.clip(np.asarray(x0, dtype=np.float64), bounds[:, 0], bounds[:, 1])

        def eval_pop(P):
            if batched_objective is not None:
                return np.asarray(batched_objective(P), dtype=np.float64)
            return np.array([objective(p) for p in P], dtype=np.float64)

        def viol_pop(P):
            if not constraints:
                return np.zeros(len(P))
            return np.array([self._constraint_violation(constraints, p)
                             for p in P])

        fit = eval_pop(pop)
        fit = np.where(np.isfinite(fit), fit, np.inf)
        viol = viol_pop(pop)
        F, CR = 0.8, 0.9
        for gen in range(int(max_iter)):
            best_i = np.lexsort((fit, viol))[0]     # feasibility-first best
            best = pop[best_i]
            idx = np.arange(NP)
            r1 = rng.permutation(NP)
            r2 = rng.permutation(NP)
            mutant = best[None, :] + F * (pop[r1] - pop[r2])
            cross = rng.uniform(size=(NP, H)) < CR
            cross[idx, rng.integers(0, H, NP)] = True
            trial = np.where(cross, mutant, pop)
            trial = np.clip(trial, bounds[:, 0], bounds[:, 1])
            f_trial = eval_pop(trial)
            f_trial = np.where(np.isfinite(f_trial), f_trial, np.inf)
            v_trial = viol_pop(trial)
            # Deb's rules: less violation wins; ties compete on fitness
            improved = (v_trial < viol) | ((v_trial == viol) & (f_trial < fit))
            pop[improved] = trial[improved]
            fit[improved] = f_trial[improved]
            viol[improved] = v_trial[improved]
            if info:
                print(f"fvgp_tpu DE generation {gen}: best f(x)= {fit.min()}")
            finite = fit[np.isfinite(fit)]
            if len(finite) == NP and np.std(finite) <= tol * (abs(np.mean(finite)) + 1e-12):
                break
        return pop[np.lexsort((fit, viol))[0]]

    # ------------------------------------------------------------------
    def _device_multistart_phase(self, bvg_device, bounds, starts, epochs,
                                 lr=0.05):
        """Advance ALL restarts in lockstep on the device: a jitted
        lax.scan of (vmapped value_and_grad -> Adam -> bound projection).
        This is the device expression of HGDL's parallel local-optimizer
        epochs (SURVEY.md §2c item 4): one batched program instead of
        pop_size sequential optimizers.  The compiled runner is cached per
        (objective identity, epochs, lr, shapes) — bounds travel as
        arguments — so repeated train('hgdl') calls in an active-learning
        loop do not recompile the whole scan."""
        import jax
        import jax.numpy as jnp
        import optax
        from .. import config as _config

        lo = _config.asarray(bounds[:, 0])
        hi = _config.asarray(bounds[:, 1])
        X0 = _config.asarray(starts)
        key = (id(bvg_device), int(epochs), float(lr), X0.shape, X0.dtype)
        cache = getattr(self, "_multistart_runner_cache", None)
        if cache is None:
            cache = self._multistart_runner_cache = {}
        run = cache.get(key)
        if run is None:
            opt = optax.adam(lr)

            @jax.jit
            def run(X0, lo, hi):
                state = opt.init(X0)

                def step(carry, _):
                    X, state = carry
                    vals, grads = bvg_device(X)
                    grads = jnp.where(jnp.isfinite(grads), grads, 0.0)
                    updates, state = opt.update(grads, state)
                    X = jnp.clip(optax.apply_updates(X, updates), lo, hi)
                    return (X, state), vals

                (X, _), vals = jax.lax.scan(step, (X0, state), None,
                                            length=int(epochs))
                final_vals, _ = bvg_device(X)
                return X, final_vals

            cache.clear()            # one live runner: chains hold arrays
            cache[key] = run

        X, vals = run(X0, lo, hi)
        return np.asarray(X, dtype=np.float64), np.asarray(vals, np.float64)

    def multistart_optimize(self, objective, gradient, bounds, x0,
                            n_starts=20, epochs=120, tolerance=1e-4,
                            local_optimizer="L-BFGS-B",
                            fused_value_and_grad=None, info=False,
                            publish=None, stop_requested=None,
                            batched_value_and_grad=None, constraints=()):
        """HGDL replacement (ref gp_training.py:126-144 + external hgdl):
        multi-start local optimization.

        With a device-batched value_and_grad (the traced LML), a vmapped
        Adam phase advances every start in lockstep on the accelerator,
        then the best few are polished with bounded L-BFGS-B.  Otherwise
        each start is polished sequentially.  Results are HGDL-style sorted
        optima [{"x", "f(x)"}, ...]."""
        bounds = np.asarray(bounds, dtype=np.float64)
        H = len(bounds)
        rng = np.random.default_rng(7)
        starts = rng.uniform(bounds[:, 0], bounds[:, 1], size=(int(n_starts), H))
        starts[0] = np.clip(np.asarray(x0, dtype=np.float64),
                            bounds[:, 0], bounds[:, 1])
        if batched_value_and_grad is not None and len(starts) > 1:
            dev_epochs = int(self.args.get("multistart_device_epochs",
                                           min(int(epochs), 200)))
            if info and dev_epochs < int(epochs):
                print(f"fvgp_tpu multistart device phase capped at "
                      f"{dev_epochs} lockstep epochs (of {int(epochs)}; "
                      "override with args['multistart_device_epochs']); "
                      "the polish phase gets the full budget")
            X, vals = self._device_multistart_phase(
                batched_value_and_grad, bounds, starts, epochs=dev_epochs)
            rank = np.where(np.isfinite(vals), vals, np.inf)
            if constraints:
                # feasibility-first ranking for the polish selection
                v = np.array([self._constraint_violation(constraints, xx)
                              for xx in X])
                order = np.lexsort((rank, v))
            else:
                order = np.argsort(rank)
            n_polish = min(3, len(starts))
            starts = X[order[:n_polish]]
            if info:
                print(f"fvgp_tpu multistart device phase: best f(x)= "
                      f"{vals[order[0]]}, polishing top {n_polish}")
        fun, jac = self._fun_and_jac(objective, gradient, fused_value_and_grad)
        # L-BFGS-B cannot take constraints; scipy's SLSQP honors both
        # bounds and scipy-style constraint objects (the reference handed
        # constraints to scipy/HGDL, ref gp_training.py:131-138)
        polish_method = local_optimizer
        if constraints and str(local_optimizer).upper() in ("L-BFGS-B",
                                                            "LBFGSB"):
            polish_method = "SLSQP"
        optima = []
        for s_i, s in enumerate(starts):
            if stop_requested is not None and stop_requested():
                break
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    res = minimize(fun, s, method=polish_method, jac=jac,
                                   bounds=bounds, tol=tolerance,
                                   constraints=constraints,
                                   options={"maxiter": int(epochs)})
                except Exception:
                    continue
            if np.isfinite(res.fun):
                optima.append({"x": np.asarray(res.x), "f(x)": float(res.fun)})
                optima.sort(key=lambda o: o["f(x)"])
                if publish is not None:
                    publish(optima=list(optima))
                if info:
                    print(f"fvgp_tpu multistart {s_i + 1}/{len(starts)}: "
                          f"f(x)= {res.fun}, best= {optima[0]['f(x)']}")
        if not optima:
            raise Exception("Multi-start optimization failed on every start.")
        return optima

    # ------------------------------------------------------------------
    def train_async(self, dask_client=None, objective_function=None,
                    objective_function_gradient=None,
                    objective_function_hessian=None, hyperparameter_bounds=None,
                    init_hyperparameters=None, method="global", pop_size=20,
                    tolerance=0.0001, max_iter=120, local_optimizer="L-BFGS-B",
                    global_optimizer="genetic", constraints=(), mcmc_prior=None,
                    mcmc_prop_distrs="normal", mcmc_args=None, bo_args=None,
                    info=False, fused_value_and_grad=None,
                    run_context=None):
        """Submit an asynchronous run; returns an AsyncOptimizer proxy
        (ref gp_training.py:198-271).  `dask_client` is accepted for API
        compatibility and ignored — actors are controller threads.
        ``run_context`` (a zero-arg context-manager factory) wraps the
        WHOLE background run — the linalg sequential-state gate must live
        as long as the actor thread, not the submitting call."""
        if mcmc_args is None:
            mcmc_args = {}
        if method not in ("hgdl", "mcmc", "adam", "bo"):
            raise AssertionError("Asynchronous training only supported for "
                                 "hgdl, mcmc, adam, bo; got method=" + str(method))
        if method == "mcmc":
            def prior_function(theta, bounds, args):
                return 0. if self._in_bounds(theta, bounds) else -np.inf

            def likelihood_func(hps, args):
                return objective_function(hps)

            if mcmc_prior is not None:
                prior_function = mcmc_prior
            actor = _MCMCActor(likelihood_func, hyperparameter_bounds,
                               prior_function, mcmc_prop_distrs, mcmc_args,
                               init_hyperparameters, max_iter, info)
        elif method == "adam":
            actor = _AdamActor(objective_function, objective_function_gradient,
                               init_hyperparameters, 1e-2, 0.9, 0.999, 1e-8,
                               max_iter, 1e-6)
        elif method == "bo":
            actor = _BOActor(objective_function, hyperparameter_bounds,
                             init_hyperparameters, max_iter, bo_args, info)
        else:  # hgdl
            def run_fn(publish, stop_requested):
                return self.multistart_optimize(
                    objective_function, objective_function_gradient,
                    hyperparameter_bounds, init_hyperparameters,
                    n_starts=max(pop_size, 4), epochs=max_iter,
                    tolerance=tolerance, local_optimizer=local_optimizer,
                    fused_value_and_grad=fused_value_and_grad, info=info,
                    publish=publish, stop_requested=stop_requested,
                    constraints=constraints)
            actor = _MultistartActor(run_fn)
        actor._run_context = run_context
        actor.start()
        return AsyncOptimizer(actor)

    # ------------------------------------------------------------------
    @staticmethod
    def stop_training(opt_obj):
        """(ref gp_training.py:473-488)."""
        try:
            opt_obj.cancel_tasks()
        except Exception:
            warnings.warn("No asynchronous training to be canceled; "
                          "no training is running.", UserWarning, stacklevel=2)

    @staticmethod
    def kill_client(opt_obj):
        """(ref gp_training.py:491-506)."""
        try:
            opt_obj.kill_client()
        except Exception:
            warnings.warn("No asynchronous training to be killed; "
                          "no training is running.", UserWarning, stacklevel=2)

    def update_hyperparameters(self, opt_obj):
        """Pull the latest hyperparameters from a running async optimizer
        (ref gp_training.py:508-544)."""
        try:
            opt_list = opt_obj.get_latest()
        except Exception:
            return self.hyperparameters
        if not opt_list:
            warnings.warn("Hyperparameter update not successful: empty optima "
                          "list.", UserWarning, stacklevel=2)
            return self.hyperparameters
        if isinstance(opt_list, list):
            updated = opt_list[0]["x"]
        elif isinstance(opt_list, dict):
            if "median(x)" in opt_list:
                updated = opt_list["median(x)"]
            elif "x" in opt_list:
                updated = opt_list["x"]
            else:
                raise Exception("Reading the updated hyperparameters failed",
                                opt_list)
        else:
            raise Exception("Reading the updated hyperparameters failed", opt_list)
        updated = np.asarray(updated)
        if updated.ndim != 1:
            raise AssertionError("async optimizer returned invalid "
                                 "hyperparameters: " + str(updated))
        return updated

    # ------------------------------------------------------------------
    @staticmethod
    def adam_optimize(nlml, grad_nlml, theta0, lr=1e-2, beta1=0.9, beta2=0.999,
                      eps=1e-8, max_iter=1000, tol=1e-6, callback=None,
                      early_stop=None):
        """Adam on (objective, gradient) callables (ref gp_training.py:577-667).

        Each step is two device calls (or one, when the caller hands a fused
        objective that caches); the moment arithmetic is negligible host work.
        """
        theta = np.asarray(theta0, dtype=np.float64).copy()
        d = theta.size
        m = np.zeros(d)
        v = np.zeros(d)
        history = {"theta": [], "nlml": [], "grad_norm": []}
        for t in range(1, int(max_iter) + 1):
            fval = nlml(theta)
            g = np.asarray(grad_nlml(theta), dtype=np.float64)
            m = beta1 * m + (1.0 - beta1) * g
            v = beta2 * v + (1.0 - beta2) * (g ** 2)
            m_hat = m / (1.0 - beta1 ** t)
            v_hat = v / (1.0 - beta2 ** t)
            step = lr * m_hat / (np.sqrt(v_hat) + eps)
            theta_new = theta - step
            history["theta"].append(theta.copy())
            history["nlml"].append(fval)
            history["grad_norm"].append(np.linalg.norm(g))
            if callback is not None:
                callback(theta, fval, g, t)
            if np.linalg.norm(theta_new - theta) < tol or (
                    early_stop is not None and early_stop()):
                theta = theta_new
                break
            theta = theta_new
        return theta, history

    @staticmethod
    def _in_bounds(v, bounds):
        if not isinstance(bounds, np.ndarray):
            raise AssertionError("bounds must be np.ndarray")
        return not (np.any(v < bounds[:, 0]) or np.any(v > bounds[:, 1]))

    def __getstate__(self):
        bo_info = self.bo_info
        if isinstance(bo_info, dict) and bo_info.get("surrogate") is not None:
            bo_info = {k: v for k, v in bo_info.items() if k != "surrogate"}
        return dict(data=self.data, mcmc_info=self.mcmc_info, bo_info=bo_info,
                    hyperparameters=self.hyperparameters)

    def __setstate__(self, state):
        self.__dict__.update(state)
