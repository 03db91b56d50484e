"""Log marginal likelihood + gradients
(parity target: /root/reference/fvgp/gp_marginal_likelihood.py).

L = -1/2 ( (y-m)ᵀ(K+V)⁻¹(y-m) + log|K+V| + n log 2π )
(ref gp_marginal_likelihood.py:137-179; multi-column y averages the
quadratic term over columns exactly as the reference does, :175).

Accelerator-first redesign: when kernel/mean/noise are jax-traceable the whole
pipeline — kernel assembly, Cholesky, solve, logdet — is ONE jitted
``jax.value_and_grad`` program.  This replaces the reference's hand-written
gradient machinery (dK/dh loops, ram_economy variants, FD fallbacks,
:224-309) on the fast path; the explicit-formula engine
    dL/dh_i = 1/2 bᵀ (dKV/dh_i) b - 1/2 tr((K+V)⁻¹ dKV/dh_i) - dm/dh_iᵀ b
is retained (with the same ram-economy memory/time trade) for host numpy
callables and non-Euclidean input spaces.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import config
from ..ops import dense as dops


class GPMarginalLikelihood:
    def __init__(self, data, prior, likelihood, trainer, kv):
        self.data = data
        self.prior = prior
        self.likelihood = likelihood
        self.trainer = trainer
        self.kv = kv
        self._warm_start_KVinvY = None
        # traced fast-path cache
        self._traced_key = None
        self._lml_jit = None
        self._lml_vg = None

    # -- plumbing ----------------------------------------------------------
    @property
    def args(self):
        return self.data.args

    @property
    def x_data(self):
        return self.data.x_data

    @property
    def y_data(self):
        return self.data.y_data

    @property
    def ram_economy(self):
        return self.data.ram_economy

    @property
    def gp2Scale(self):
        return self.data.gp2Scale

    @property
    def hyperparameters(self):
        return self.trainer.hyperparameters

    # ------------------------------------------------------------------
    # traced fast path
    # ------------------------------------------------------------------
    def _traced_ready(self):
        return (not self.gp2Scale
                and self.data.Euclidean
                and isinstance(self.kv.mode, str)
                and self.kv.mode in ("Chol", "CholInv")
                and self.prior.traceable
                and self.likelihood.noise_traceable)

    def _get_traced(self):
        """(jitted lml, jitted value_and_grad) — rebuilt when the dataset
        shape moves."""
        key = (self.data.point_number, self.y_data.shape[1],
               id(self.prior._x_dev))
        if key != self._traced_key:
            self._build_traced()
            self._traced_key = key
        return self._lml_jit, self._lml_vg

    def _build_traced(self):
        prior = self.prior
        likelihood = self.likelihood
        dtype = config.linalg_dtype(self.args)
        x = prior._x_dev
        y = jnp.asarray(self.y_data, dtype=dtype)
        n = y.shape[0]
        args_dict = self.args
        k_n = prior.k_n_params
        kernel = prior.kernel
        mean_default = prior._default_mean
        mean_fn = prior.mean_function
        m_n = prior.m_n_params
        mean_const = float(np.mean(self.y_data)) if mean_default else 0.0
        noise_mode = likelihood._mode
        v_n = likelihood.v_n_params
        noise_fn = likelihood.noise_function
        if noise_mode != "callable":
            V_const = jnp.asarray(likelihood.calculate_V(self.x_data,
                                                         self.hyperparameters),
                                  dtype=dtype)
        else:
            # placeholder operand (the callable branch never reads it):
            # the data tuple keeps a fixed pytree structure either way
            V_const = jnp.zeros((0,), dtype=dtype)

        # x/y/V/mean_const are jit ARGUMENTS, not closure constants:
        # constants are baked into the program (and its compile-cache
        # hash), so every update_gp_data at the same N recompiled the
        # dense pipeline, and the compiler serializes the constants with
        # the program.  A same-shape data refresh now reuses the live
        # jitted program (the program cache below), and across processes
        # the persistent compile cache key no longer churns with the data.
        self._lml_data = (x, y, V_const,
                          jnp.asarray(mean_const, dtype=dtype))
        # args-consuming callables (4-arg kernel / 3-arg mean / 3-arg
        # noise) read args_dict AT TRACE TIME, and in-place args mutation
        # is invisible to any key — such models rebuild on every data
        # flush exactly as before round 5, so the reference's flush idiom
        # (mutate args, then update_gp_data/set_hyperparameters) keeps
        # working.  Program reuse applies only when args never enters the
        # trace.
        consumes_args = (k_n == 4
                         or (not mean_default and m_n == 3)
                         or (noise_mode == "callable" and v_n == 3))
        pkey = None if consumes_args else (
            n, int(y.shape[1]), str(dtype), id(kernel), k_n,
            mean_default, id(mean_fn), m_n, noise_mode, id(noise_fn),
            v_n, V_const.ndim)
        if pkey is not None and pkey == getattr(self, "_lml_pkey", None):
            return                       # programs still valid; data refreshed

        def lml_on(hps, x, y, V_arg, mc):
            if k_n == 3:
                K = kernel(x, x, hps)
            else:
                K = kernel(x, x, hps, args_dict)
            if noise_mode == "callable":
                V = noise_fn(x, hps) if v_n == 2 else noise_fn(x, hps, args_dict)
            else:
                V = V_arg
            if V.ndim == 1:
                KV = dops.add_diagonal(K, V)
            else:
                KV = K + V
            if mean_default:
                m = jnp.full((n,), mc, dtype=dtype)
            else:
                m = mean_fn(x, hps) if m_n == 2 else mean_fn(x, hps, args_dict)
            L = jnp.linalg.cholesky(KV)
            ym = y - m[:, None]
            alpha = jax.scipy.linalg.cho_solve((L, True), ym)
            l1 = jnp.sum(ym * alpha) / ym.shape[1]
            logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            return -0.5 * (l1 + logdet + n * jnp.log(2.0 * jnp.pi))

        jit_fn = jax.jit(lml_on)
        vg_fn = jax.jit(jax.value_and_grad(lml_on))   # argnums=0: hps only
        self._lml_pkey = pkey
        self._lml_on = lml_on
        self._lml_raw = lambda h: lml_on(h, *self._lml_data)
        self._lml_jit = lambda h: jit_fn(h, *self._lml_data)
        self._lml_vg = lambda h: vg_fn(h, *self._lml_data)
        self._lml_vmap = None
        self._bvg_dev = None
        self._lml_hess = None

    def batched_neg_log_likelihood(self, P):
        """Vectorized -LML over a (pop, H) batch of hyperparameter vectors —
        one device program for a whole optimizer population (no reference
        equivalent; enabled by the traced design)."""
        if not self._traced_ready():
            return None
        self._get_traced()
        if self._lml_vmap is None:
            self._lml_vmap = jax.jit(jax.vmap(
                lambda h, *d: -self._lml_on(h, *d),
                in_axes=(0, None, None, None, None)))
        vals = self._lml_vmap(config.asarray(np.asarray(P)),
                              *self._lml_data)
        return config.to_numpy(vals)

    def batched_value_and_grad_device(self):
        """A jitted vmapped value_and_grad of the NEGATIVE LML over a
        (pop, H) device batch — the engine of the HGDL-replacement's device
        phase (all restarts advance in lockstep on the device).  None when the
        traced path is unavailable."""
        if not self._traced_ready():
            return None
        self._get_traced()
        if getattr(self, "_bvg_dev", None) is None:
            bvg = jax.jit(jax.vmap(
                jax.value_and_grad(                   # argnums=0: hps only
                    lambda h, *d: -self._lml_on(h, *d)),
                in_axes=(0, None, None, None, None)))
            self._bvg_dev = lambda P: bvg(P, *self._lml_data)
        return self._bvg_dev

    def invalidate_traced(self):
        self._traced_key = None
        self._sparse_cache = {}
        # the tile-liveness keep mask and the box-prune candidate set are
        # functions of the dataset as well as the lengthscales — stale ones
        # after update_gp_data would silently drop live covariance tiles
        # (corrupting LML and gradient)
        self._filter_mask_cache = None
        self._candidate_cache = None

    # ------------------------------------------------------------------
    # traced sparse fast path (gp2Scale training hot loop)
    # ------------------------------------------------------------------
    def _sparse_traced_ready(self):
        """The gp2Scale LML can run as ONE cached compiled program when the
        kernel is traceable and mean/noise carry no hyperparameters.  The
        tile occupancy is a runtime argument, so MCMC/BO moves never
        recompile (ops/sparse_lml.py)."""
        return (self.gp2Scale and self.data.Euclidean
                and self.y_data.shape[1] == 1
                and self.prior.kernel_traceable
                and self.prior._default_mean
                and self.likelihood._mode != "callable"
                and bool(self.args.get("gp2Scale_traced_lml", True)))

    def _sparse_lml_eval(self, hyperparameters, want_grad=False):
        from ..ops.sparse_lml import make_padded_inputs, make_sparse_lml
        from ..parallel.mesh import current_mesh, tile_device_count, \
            tile_spec
        from ..parallel.sharded_cov import (_bucket, _candidate_pairs,
                                            support_geometry)
        prior = self.prior
        args = self.args
        x = np.asarray(self.x_data, dtype=np.float64)
        n = len(x)
        B = int(args.get("gp2Scale_block_size", min(prior.batch_size, 256)))
        # row-partitioned mesh path: each device owns a contiguous range of
        # row blocks (parallel/partition.py), so the blocking is padded to
        # divide evenly and the SpMM runs as a shard_map with no
        # cross-device reduction
        mesh = current_mesh()
        n_dev = 1
        if mesh is not None:
            n_dev = tile_device_count(mesh)
        if n_dev <= 1:
            mesh = None
        # width-w preconditioner: group w adjacent (Morton-neighboring)
        # point blocks into exact wB-sized factors — captures the coupling
        # that stalls block-Jacobi on long length scales while M stays
        # block-diagonal (the mBCG log|M| correction needs that).  The
        # blocking is padded so every device's local block count divides by
        # w: pad blocks are all-masked with unit noise, so they enter the
        # preconditioner as identity and the quadrature as log(1) = 0
        pwidth = int(args.get("gp2Scale_precond_width", 1))
        row_mult = n_dev * max(pwidth, 1)
        nb = -(-(-(-n // B)) // row_mult) * row_mult
        dtype = config.linalg_dtype(args)

        from ..utils.logging import phase_timer
        ls, radius = support_geometry(prior, hyperparameters, args)
        if ls is None:
            # unknown support (warned in support_geometry): no whitening,
            # radius stays inf, so EVERY tile is a candidate — correct but
            # unpruned.  np.asarray(None) would be NaN and NaN gaps compare
            # False, which silently yielded ZERO candidates (a noise-only
            # covariance) instead of the promised dense one.
            ls = np.ones(x.shape[1], dtype=np.float64)
        # the box-prune candidate structure costs seconds of host time at
        # N~1M and depends only on (data, B, lengthscales); it is cached
        # under the same drift policy as the liveness mask.  Candidates are
        # computed at INFLATED lengthscales ls·(1+tol) — larger ls brings
        # whitened boxes closer, so the inflated set is a superset for
        # every ls within the tolerance band; the exact tile-liveness
        # filter (below) then prunes it exactly, and with the filter off
        # the extras are exact zeros of the compact-support kernel.
        tol_c = float(args.get("gp2Scale_filter_drift", 0.05))
        data_token = (self.data.point_number, self.data.generation)
        ls_now = np.asarray(ls, dtype=np.float64)
        ccache = getattr(self, "_candidate_cache", None)
        if (ccache is not None
                and ccache[0] == (data_token, B, float(radius))
                and np.all(np.abs(ls_now / ccache[1] - 1.0) <= tol_c)):
            rows_f, cols_f = ccache[2], ccache[3]
        else:
            # disk layer (utils/structure_cache): the candidate set is a
            # pure function of (dataset bytes, inflated ls, radius, B) —
            # repeat cold starts load it instead of re-pruning
            from ..utils import structure_cache as sc
            cdir = sc.cache_dir(args)
            token = self.data.content_token if cdir else None
            dkey = None
            hit = None
            if token is not None:
                dkey = sc.content_key("candidates", token,
                                      B, float(radius),
                                      ls_now * (1.0 + tol_c))
                hit = sc.load(cdir, "candidates", dkey)
            if hit is not None:
                rows_f, cols_f = hit["rows"], hit["cols"]
            else:
                with phase_timer("sparse LML: candidate structure"):
                    rows, cols = _candidate_pairs(x, None,
                                                  ls_now * (1.0 + tol_c),
                                                  radius, B, symmetric=True)
                off = rows < cols
                rows_f = np.concatenate([rows, cols[off]]).astype(np.int32)
                cols_f = np.concatenate([cols, rows[off]]).astype(np.int32)
                if dkey is not None:
                    sc.store(cdir, "candidates", dkey,
                             rows=rows_f, cols=cols_f)
            self._candidate_cache = ((data_token, B, float(radius)), ls_now,
                                     rows_f, cols_f)

        cg_iters = int(args.get("sparse_cg_maxiter",
                                args.get("sparse_krylov_maxiter", 64)) or 64)
        # early-exit tolerance (relative preconditioned residual); None =
        # dtype-matched default (ops/sparse_lml._freeze_tol_sq) — maxiter is
        # then a safety bound, not the iteration count actually paid
        ctol = args.get("sparse_cg_tol", None)
        ctol = float(ctol) if ctol is not None else None
        sdt = args.get("gp2Scale_solver_dtype", None)
        if isinstance(sdt, str):
            sdt = jnp.dtype(sdt)
        probes = int(args.get("random_logdet_fixed_probes",
                              max(16, int(args.get(
                                  "random_logdet_min_num_samples", 10)))))
        degree = int(args.get("random_logdet_lanczos_degree", 20))
        # mbcg (default): ONE preconditioned CG over [y-m | probes] yields
        # the solve and a degree-cg_iters preconditioned SLQ logdet, with a
        # backward that reuses the probe solves — 2-3x the slq path
        # (ops/sparse_lml._mbcg_factory).  "slq" restores separate CG+SLQ.
        solver = str(args.get("gp2Scale_solver", "mbcg"))

        if not hasattr(self, "_sparse_cache"):
            self._sparse_cache = {}
        key = (n, B, nb, cg_iters, ctol, probes, degree, str(dtype), str(sdt),
               solver, pwidth, self.data.point_number, mesh)
        entry = self._sparse_cache.get(key)
        if entry is None:
            from ..parallel.sharded_cov import _stable_kernel_closure
            kern_fn = _stable_kernel_closure(prior)
            with phase_timer("sparse LML: padded inputs (host pad + "
                             "device transfer)"):
                # noise on the HOST: np.asarray(calculate_V(...)) would pull
                # an N-sized device vector back
                noise_h = self.likelihood.calculate_V_host(self.x_data,
                                                           hyperparameters)
                if noise_h is None:
                    noise_h = np.asarray(self.likelihood.calculate_V(
                        self.x_data, hyperparameters))
                xb, mask, y_pad, ypad_mask, noise_pad = make_padded_inputs(
                    x, np.asarray(self.y_data)[:, 0], noise_h,
                    B, dtype=dtype, row_multiple=row_mult)
            # the compiled program's nb and the padded arrays' block count
            # are derived independently — they must never diverge
            assert xb.shape[0] == nb, (xb.shape, nb)
            if mesh is not None:
                repl = NamedSharding(mesh, P())
                row_s = NamedSharding(mesh, tile_spec(mesh))
                xb = jax.device_put(xb, repl)
                mask = jax.device_put(mask, repl)
                y_pad = jax.device_put(y_pad, row_s)
                ypad_mask = jax.device_put(ypad_mask, row_s)
                noise_pad = jax.device_put(noise_pad, row_s)
            lml = make_sparse_lml(kern_fn, nb, B, cg_iters=cg_iters,
                                  slq_degree=degree, with_variance=True,
                                  solver_dtype=sdt, solver=solver, mesh=mesh,
                                  precond_width=pwidth, cg_tol=ctol)
            # one jitted fn across occupancy buckets: jit's own shape cache
            # keeps every bucket's program warm as the hp moves change T_pad
            entry = {"fn": jax.jit(lml), "vg": None, "lml": lml,
                     "kern_fn": kern_fn, "xb": xb, "mask": mask,
                     "y_pad": y_pad, "ypad_mask": ypad_mask,
                     "noise_pad": noise_pad, "counter": 0}
            self._sparse_cache = {key: entry}
        if want_grad and entry["vg"] is None:
            # the differentiable sparse LML (no reference equivalent: its
            # sparse training is MCMC/BO only, gp_marginal_likelihood.py:240)
            entry["vg"] = jax.jit(jax.value_and_grad(entry["lml"],
                                                     has_aux=True))
        fn = entry["vg"] if want_grad else entry["fn"]
        kern_fn = entry["kern_fn"]
        xb, mask = entry["xb"], entry["mask"]
        y_pad, ypad_mask = entry["y_pad"], entry["ypad_mask"]
        noise_pad = entry["noise_pad"]
        rng_key = jax.random.fold_in(jax.random.PRNGKey(42), entry["counter"])
        entry["counter"] += 1

        # exact-sparsity pass: the box prune is loose (boxes overlap even
        # when no point pair is inside the support), so drop exact-zero
        # tiles before CG+SLQ run hundreds of matvec passes over them.
        # The keep mask is cached under the framework's drift policy: while
        # the candidate structure is byte-identical and the support
        # lengthscales moved < gp2Scale_filter_drift (default 5%), the mask
        # is reused — the only tiles whose status could flip under such a
        # move sit exactly on the support boundary where k ~ 0, far below
        # the SLQ estimator's own noise.  So the filter pass costs one
        # assembly every few dozen MCMC/BO moves, not one per eval.
        hps_dev = config.asarray(hyperparameters, args)
        if (bool(args.get("gp2Scale_tile_filter", True))
                and np.isfinite(radius) and len(rows_f)):
            pair_key = rows_f.astype(np.int64) * (nb + 1) + cols_f
            ls_now = np.asarray(ls, dtype=np.float64)
            tol = float(args.get("gp2Scale_filter_drift", 0.05))
            data_token = (self.data.point_number, self.data.generation)
            cache = getattr(self, "_filter_mask_cache", None)
            if (cache is not None and len(cache) == 4
                    and cache[2] == data_token
                    and cache[3] == (nb, B, float(radius))
                    and np.all(np.abs(ls_now / cache[0] - 1.0) <= tol)):
                # reuse: known-dead pairs stay dropped; candidates not seen
                # at the reference lengthscales are conservatively kept
                keep = ~np.isin(pair_key, cache[1])
            else:
                # exact geometric liveness in the native C++ runtime
                # (OpenMP, early-exit): a tile is live iff some point pair
                # sits inside the support radius — equivalent to max|k| > 0
                # for compactly supported kernels, ~5x the device assembly
                # pass at N=1M and it leaves the device free
                from ..native import tile_live
                from ..utils import structure_cache as sc
                cdir = sc.cache_dir(args)
                token = self.data.content_token if cdir else None
                lkey = None
                keep = None
                if token is not None:
                    lkey = sc.content_key("liveness", token,
                                          B, float(radius), ls_now,
                                          rows_f, cols_f)
                    hit = sc.load(cdir, "liveness", lkey)
                    if hit is not None:
                        keep = hit["keep"].astype(bool)
                if keep is None:
                    with phase_timer("sparse LML: exact tile liveness"):
                        keep = tile_live(x / ls_now, rows_f, cols_f, B,
                                         radius)
                    if lkey is not None:
                        sc.store(cdir, "liveness", lkey,
                                 keep=np.asarray(keep, dtype=bool))
                # keyed on (nb, B, radius) too: pair_key encodes indices as
                # rows*(nb+1)+cols, so a block-size change would otherwise
                # reuse dead keys under the wrong encoding
                self._filter_mask_cache = (ls_now, np.sort(pair_key[~keep]),
                                           data_token,
                                           (nb, B, float(radius)))
                # exact-branch result: the prediction path (GPkv's
                # committed fast solver) needs the identical filtered
                # structure at these lengthscales — share it so posterior
                # setup skips its own ~7 s host pass at N=1M.  (The
                # drift-reuse branch above yields an ls-approximate set
                # and is never shared.)
                shared = getattr(self.data, "structure_cache", None)
                if shared is not None:
                    skey = ("tile_structure", self.data.generation,
                            self.data.point_number, B, float(radius),
                            ls_now.tobytes(), True)
                    shared.clear()
                    shared[skey] = (rows_f[keep], cols_f[keep])
            rows_f = rows_f[keep]
            cols_f = cols_f[keep]

        nb_eff = nb
        layout_idx = None
        xb_m, mask_m = xb, mask
        y_m, ym_m, np_m = y_pad, ypad_mask, noise_pad
        if mesh is not None:
            # contiguous row-range ownership: device d's (position-sharded)
            # segment holds exactly the tiles whose row block it owns, so
            # the shard_map SpMM needs no cross-device reduction.  Ranges
            # are VARIABLE-width, balanced by tile count, and mapped onto
            # equal-width shards via a permuted padded block layout
            # (parallel/partition.tile_balanced_layout) — the solver sees
            # only remapped indices and permuted vectors.  The partitioned
            # schedule is cached while the filtered candidate set is
            # byte-identical (the common case: the liveness mask is reused
            # under the drift policy above)
            pcache = entry.get("partition_cache")
            if (pcache is not None and len(pcache[0][0]) == len(rows_f)
                    and np.array_equal(pcache[0][0], rows_f)
                    and np.array_equal(pcache[0][1], cols_f)):
                (rows_d, cols_d, xb_m, mask_m, y_m, ym_m, np_m,
                 nb_eff, layout_idx, halo) = pcache[1]
            else:
                from ..parallel.partition import (apply_block_layout,
                                                  partition_schedule,
                                                  permute_blocked,
                                                  schedule_stats,
                                                  tile_balanced_layout)
                layout, W = tile_balanced_layout(
                    rows_f, nb, n_dev, width=entry.get("layout_width"))
                if layout is not None and entry.get("layout_width") is None:
                    # pin the per-device width to a bucket so later drift
                    # of the tile structure reuses the compiled program
                    W0 = nb // n_dev
                    step = max(1, -(-W0 // 8))
                    Wb = min(-(-W // step) * step,
                             int(np.ceil(1.5 * W0)))
                    entry["layout_width"] = Wb
                    if Wb != W:
                        layout, W = tile_balanced_layout(
                            rows_f, nb, n_dev, width=Wb)
                rows_u, cols_u = rows_f, cols_f
                layout_idx = None
                if layout is not None:
                    rows_u, cols_u, nb_eff = apply_block_layout(
                        layout, rows_f, cols_f, nb)
                    xb_m = permute_blocked(layout, np.asarray(xb))
                    mask_m = permute_blocked(layout, np.asarray(mask))
                    y_m = permute_blocked(
                        layout, np.asarray(y_pad).reshape(nb, B)).ravel()
                    ym_m = permute_blocked(
                        layout, np.asarray(ypad_mask).reshape(nb, B)).ravel()
                    np_m = permute_blocked(
                        layout, np.asarray(noise_pad).reshape(nb, B),
                        pad_value=1.0).ravel()
                    repl = NamedSharding(mesh, P())
                    row_s = NamedSharding(mesh, tile_spec(mesh))
                    xb_m = jax.device_put(jnp.asarray(xb_m, dtype), repl)
                    mask_m = jax.device_put(jnp.asarray(mask_m, dtype), repl)
                    y_m = jax.device_put(jnp.asarray(y_m, dtype), row_s)
                    ym_m = jax.device_put(jnp.asarray(ym_m, dtype), row_s)
                    np_m = jax.device_put(jnp.asarray(np_m, dtype), row_s)
                    # probe vectors stay defined per LOGICAL point: the base
                    # Z is generated unpermuted, then gathered through this
                    # index so mesh and meshless runs share identical probes
                    layout_idx = jnp.asarray(
                        np.where(layout >= 0, layout, 0), jnp.int32)
                W_eff = nb_eff // n_dev
                if len(rows_u):
                    cnt = np.bincount(
                        np.minimum(rows_u // W_eff, n_dev - 1),
                        minlength=n_dev)
                    pad_to = _bucket(int(cnt.max()))
                else:
                    pad_to = _bucket(1)
                rows_p, cols_p, _, _ = partition_schedule(
                    rows_u, cols_u, nb_eff, n_dev, pad_to=pad_to)
                tile_s = NamedSharding(mesh, tile_spec(mesh))
                rows_d = jax.device_put(jnp.asarray(rows_p), tile_s)
                cols_d = jax.device_put(jnp.asarray(cols_p), tile_s)
                # halo exchange: ship only the referenced non-local column
                # blocks instead of all-gathering X — flat or hierarchical
                # (2-D mesh), selected by THE shared cost model
                # (parallel/partition.choose_halo, same as the committed
                # posterior solver), or forced via
                # args["gp2Scale_halo_exchange"]
                from ..parallel.partition import choose_halo
                halo = None
                halo_mode = args.get("gp2Scale_halo_exchange", "auto")
                choice = choose_halo(
                    rows_p, cols_p, nb_eff, mesh, halo_mode=halo_mode,
                    dcn_ratio=float(args.get("gp2Scale_dcn_ici_ratio",
                                             8.0)),
                    bucket=max(8, W_eff // 8))
                hstats = choice["stats"] if choice is not None else None
                hier_stats = (choice["hier_stats"] if choice is not None
                              else None)
                send_mask = (choice["send_mask"] if choice is not None
                             else None)
                if choice is not None and choice["engaged"] is not None:
                    plan_s = NamedSharding(mesh, tile_spec(mesh, 2))
                    halo = tuple(
                        jax.device_put(
                            jnp.asarray(p) if p.dtype.kind == "i"
                            else jnp.asarray(p, dtype), plan_s)
                        for p in choice["plan"]) + (
                        jax.device_put(jnp.asarray(choice["cols_remap"]),
                                       tile_s),
                        choice["halo_S"])
                entry["partition_cache"] = (
                    (rows_f.copy(), cols_f.copy()),
                    (rows_d, cols_d, xb_m, mask_m, y_m, ym_m, np_m, nb_eff,
                     layout_idx, halo))
                import logging

                from ..utils.logging import logger
                if logger.isEnabledFor(logging.DEBUG):
                    logger.debug("sparse LML schedule: %s",
                                 schedule_stats(rows_p, cols_p, nb_eff,
                                                n_dev, B, n_rhs=probes + 1))
                    from ..parallel.mesh import SLICE_AXIS, TILE_AXIS
                    if (SLICE_AXIS in mesh.shape
                            and halo_mode not in (False, "off")):
                        from ..parallel.partition import dcn_split
                        logger.debug(
                            "sparse LML 2-D mesh comm split: %s",
                            dcn_split(hstats, n_dev,
                                      int(mesh.shape[TILE_AXIS]),
                                      send_mask=send_mask))
                        if hier_stats is not None:
                            logger.debug(
                                "sparse LML hierarchical halo plan: %s "
                                "(engaged=%s)", hier_stats,
                                halo is not None and isinstance(
                                    halo[-1], tuple))
        else:
            halo = None
            T_pad = _bucket(max(len(rows_f), 1))
            rows_p = np.full(T_pad, nb, np.int32)
            cols_p = np.full(T_pad, nb, np.int32)
            rows_p[:len(rows_f)] = rows_f
            cols_p[:len(cols_f)] = cols_f
            rows_d = jnp.asarray(rows_p)
            cols_d = jnp.asarray(cols_p)
        # halo layout: (plan arrays..., cols_remap, key); the key is the
        # flat pad size S (int) or ("hier", S_ici, S_fwd, S_dcn)
        halo_S = halo[-1] if halo is not None else None
        if nb_eff != nb or halo_S is not None:
            # the permuted layout inflates the block count / the halo plan
            # changes the SpMM program: compile (and cache) a variant
            from ..ops.sparse_lml import make_sparse_lml
            akey = (nb_eff, halo_S)
            alt = entry.setdefault("alt_fns", {}).get(akey)
            if alt is None:
                lml_alt = make_sparse_lml(
                    kern_fn, nb_eff, B, cg_iters=cg_iters, slq_degree=degree,
                    with_variance=True, solver_dtype=sdt, solver=solver,
                    mesh=mesh, precond_width=pwidth, halo_S=halo_S,
                    cg_tol=ctol)
                alt = {"lml": lml_alt, "fn": jax.jit(lml_alt), "vg": None}
                entry["alt_fns"][akey] = alt
            if want_grad and alt["vg"] is None:
                alt["vg"] = jax.jit(jax.value_and_grad(alt["lml"],
                                                       has_aux=True))
            fn = alt["vg"] if want_grad else alt["fn"]
        Z = jax.random.rademacher(rng_key, (nb * B, probes), dtype=dtype)
        Z = Z * ypad_mask[:, None]
        if nb_eff != nb:
            Zb = jnp.reshape(Z, (nb, B, probes))[layout_idx]
            Z = Zb.reshape(nb_eff * B, probes) * ym_m[:, None]
        if mesh is not None:
            Z = jax.device_put(Z, NamedSharding(mesh, tile_spec(mesh, 1)))
        halo_args = halo[:-1] if halo is not None else ()
        # context for the device-chained optimizers (sparse_adam_steps):
        # the raw differentiable program + its bound runtime arguments
        entry["chain_ctx"] = {
            "lml": (entry["alt_fns"][(nb_eff, halo_S)]["lml"]
                    if (nb_eff != nb or halo_S is not None)
                    else entry["lml"]),
            "static": (rows_d, cols_d, xb_m, mask_m, y_m, ym_m, np_m)
                      + halo_args,
            "nb": nb, "nb_eff": nb_eff, "B": B, "probes": probes,
            "dtype": dtype, "ypad_mask": ypad_mask, "ym_m": ym_m,
            "layout_idx": layout_idx if nb_eff != nb else None,
            "mesh": mesh, "ls_ref": np.asarray(ls, np.float64),
            "data_token": (self.data.point_number, self.data.generation),
        }
        with phase_timer("sparse LML: device program (incl. compile on "
                         "first shape)"):
            out = fn(hps_dev, rows_d, cols_d,
                     xb_m, mask_m, y_m, ym_m, np_m, Z, *halo_args)
            jax.block_until_ready(out)
        if want_grad:
            (val, var), grad = out
        else:
            val, var = out
        self.kv.last_logdet_variance = float(var)
        self.kv.last_logdet_info = {"variance": float(var),
                                    "num_samples": probes, "degree": degree}
        if want_grad:
            return float(val), np.asarray(config.to_numpy(grad),
                                          dtype=np.float64)
        return float(val)

    def sparse_adam_steps(self, theta, m, v, t_start, n_steps, seed=0,
                          lr=1e-2, beta1=0.9, beta2=0.999, eps=1e-8,
                          bounds=None):
        """``n_steps`` Adam steps on the NEGATIVE sparse LML as ONE device
        program (``lax.scan`` of value_and_grad + moment update), reusing
        the cached tile structure for the whole chunk.

        Per-step host dispatch and the host round-trip of each step's
        value and gradient are paid once per chunk instead of once per
        step.  The structure
        reuse inside a chunk is the same bet the drift policy already
        makes (moves < gp2Scale_filter_drift keep the mask); callers bound
        the chunk length and this method revalidates all caches against
        the CURRENT theta on entry, so staleness never exceeds one chunk.

        Returns ``(theta, m, v, fvals)`` (numpy); ``fvals`` are the
        per-step negative LML values.
        """
        theta = np.asarray(theta, dtype=np.float64)
        # refresh structure/program caches for the current point — but only
        # when the support geometry left the drift band (the refresh costs
        # a full LML+gradient evaluation)
        entry = ctx = None
        cache = getattr(self, "_sparse_cache", None)
        if cache:
            entry = next(iter(cache.values()))
            ctx = entry.get("chain_ctx")
        if ctx is not None:
            from ..parallel.sharded_cov import support_geometry
            ls, _ = support_geometry(self.prior, theta, self.args)
            if ls is None:                 # unknown support: never drifts
                ls = np.ones_like(ctx["ls_ref"])
            tol = float(self.args.get("gp2Scale_filter_drift", 0.05))
            if (ctx["data_token"] != (self.data.point_number,
                                      self.data.generation)
                    or not np.all(np.abs(np.asarray(ls, np.float64)
                                         / ctx["ls_ref"] - 1.0) <= tol)):
                ctx = None
        if ctx is None:
            self._sparse_lml_eval(theta, want_grad=True)
            entry = next(iter(self._sparse_cache.values()))
            ctx = entry["chain_ctx"]
        # the chain closure binds ym_m/layout_idx/ypad_mask: key on THEIR
        # identities too, so a drift refresh that rebuilds the partition
        # layout (same lml object, new permuted arrays) rebuilds the chain
        # instead of permuting probes with the stale layout
        ckey = ("adam_chain", id(ctx["lml"]), id(ctx["ym_m"]),
                id(ctx["layout_idx"]), id(ctx["ypad_mask"]),
                int(n_steps), float(lr),
                float(beta1), float(beta2), float(eps), bounds is not None)
        chain = entry.get(ckey)
        if chain is None:
            lml = ctx["lml"]
            nb, nb_eff, B = ctx["nb"], ctx["nb_eff"], ctx["B"]
            probes, dtype = ctx["probes"], ctx["dtype"]
            ypm, ym_m, lidx = ctx["ypad_mask"], ctx["ym_m"], ctx["layout_idx"]

            def run(theta, m, v, t0, key, lo, hi, *static):
                def step(carry, i):
                    theta, m, v = carry
                    Z = jax.random.rademacher(
                        jax.random.fold_in(key, i), (nb * B, probes),
                        dtype=dtype) * ypm[:, None]
                    if nb_eff != nb:
                        Z = (jnp.reshape(Z, (nb, B, probes))[lidx]
                             .reshape(nb_eff * B, probes) * ym_m[:, None])
                    # signature: lml(hps, <7 data args>, Z[, halo args])
                    (val, _), g = jax.value_and_grad(lml, has_aux=True)(
                        theta, *static[:7], Z, *static[7:])
                    g = -g                                  # minimize -LML
                    g = jnp.where(jnp.isfinite(g), g, 0.0).astype(theta.dtype)
                    dt = theta.dtype
                    b1 = jnp.asarray(beta1, dt)
                    b2 = jnp.asarray(beta2, dt)
                    t = (t0 + i + 1).astype(dt)
                    m2 = b1 * m + (1.0 - b1) * g
                    v2 = b2 * v + (1.0 - b2) * g * g
                    mh = m2 / (1.0 - b1 ** t)
                    vh = v2 / (1.0 - b2 ** t)
                    theta2 = theta - jnp.asarray(lr, dt) * mh \
                        / (jnp.sqrt(vh) + jnp.asarray(eps, dt))
                    if bounds is not None:
                        theta2 = jnp.clip(theta2, lo, hi)
                    return (theta2, m2, v2), -val
                (theta, m, v), fvals = jax.lax.scan(
                    step, (theta, m, v), jnp.arange(n_steps))
                return theta, m, v, fvals

            chain = jax.jit(run)
            # stale chains hold the old layout arrays alive — drop them
            for old in [k for k in entry
                        if isinstance(k, tuple) and k
                        and k[0] == "adam_chain" and k != ckey]:
                del entry[old]
            entry[ckey] = chain

        hp_dtype = config.linalg_dtype(self.args)
        if bounds is not None:
            lo = jnp.asarray(np.asarray(bounds)[:, 0], hp_dtype)
            hi = jnp.asarray(np.asarray(bounds)[:, 1], hp_dtype)
        else:
            lo = hi = jnp.zeros((len(theta),), hp_dtype)
        static = entry["chain_ctx"]["static"]
        # fold the ABSOLUTE step index in: chunk k+1 must not replay chunk
        # k's probe sequence (the per-step fold_in(key, i) restarts at 0
        # every chunk), or the SLQ gradient noise becomes a fixed
        # repeating bias over the whole run
        th, m2, v2, fvals = chain(
            jnp.asarray(theta, hp_dtype), jnp.asarray(m, hp_dtype),
            jnp.asarray(v, hp_dtype), jnp.asarray(int(t_start)),
            jax.random.fold_in(
                jax.random.fold_in(jax.random.PRNGKey(seed),
                                   entry["counter"]), int(t_start)),
            lo, hi, *static)
        return (np.asarray(th, np.float64), np.asarray(m2, np.float64),
                np.asarray(v2, np.float64), np.asarray(fvals, np.float64))

    # ------------------------------------------------------------------
    # warm-start plumbing (ref gp_marginal_likelihood.py:92-134)
    # ------------------------------------------------------------------
    def _warm_start_enabled(self):
        return bool(self.args.get("sparse_krylov_warm_start", False))

    def _iterative_initial_guess(self, target_shape):
        if not self._warm_start_enabled():
            return None
        for candidate in (self._warm_start_KVinvY, self.kv.KVinvY):
            if candidate is None:
                continue
            guess = jnp.asarray(candidate)
            if guess.ndim == 1:
                guess = guess.reshape(-1, 1)
            if guess.shape[0] != target_shape[0]:
                continue
            if guess.shape[1] == target_shape[1]:
                return guess
            if guess.shape[1] == 1 and target_shape[1] > 1:
                return jnp.repeat(guess, target_shape[1], axis=1)
        return None

    def _update_warm_start(self, KVinvY):
        if self._warm_start_enabled():
            self._warm_start_KVinvY = jnp.array(KVinvY)

    def compute_new_KVinvY(self, KV, m):
        shape = (self.y_data.shape[0], self.y_data.shape[1])
        x0 = self._iterative_initial_guess(shape)
        KVinvY = self.kv.compute_new_KVinvY(KV, m, x0=x0)
        self._update_warm_start(KVinvY)
        return KVinvY

    def compute_new_KVlogdet_KVinvY(self, K, V, m):
        shape = (self.y_data.shape[0], self.y_data.shape[1])
        x0 = self._iterative_initial_guess(shape)
        KVinvY, KVlogdet = self.kv.compute_new_KVlogdet_KVinvY(K, V, m, x0=x0)
        self._update_warm_start(KVinvY)
        return KVinvY, KVlogdet

    # ------------------------------------------------------------------
    # public surface
    # ------------------------------------------------------------------
    def log_likelihood(self, hyperparameters=None):
        """Marginal log-likelihood (ref gp_marginal_likelihood.py:137)."""
        if hyperparameters is None:
            if self._sparse_traced_ready() \
                    and self.kv._fast_sparse_solver() is not None:
                # committed state through the traced sparse program: same
                # estimator as training evaluations, and the stored K+V
                # (~10 GB at N=1M) never materializes.  Gated on the kv
                # fast path so small-N dense modes (Chol/dense-cutoff LU)
                # keep their EXACT deterministic logdet
                val = self._sparse_lml_eval(np.asarray(self.hyperparameters))
                return val if np.isfinite(val) else -np.inf
            K, V, m = self.prior.K, self.likelihood.V, self.prior.m
            KVinvY = self.kv.KVinvY
            KVlogdet = self.kv.logdet_KV
            n = len(self.y_data)
            ym = jnp.asarray(self.y_data,
                             dtype=config.linalg_dtype(self.args)) - m[:, None]
            l1 = float(jnp.sum(ym * KVinvY)) / ym.shape[1]
            return -0.5 * (l1 + KVlogdet + n * np.log(2.0 * np.pi))
        hyperparameters = np.asarray(hyperparameters)
        if self._traced_ready():
            lml_jit, _ = self._get_traced()
            val = lml_jit(config.asarray(hyperparameters))
            val = float(val)
            if not np.isfinite(val):
                # non-PD Cholesky produces NaN under jit; surface it like the
                # reference's linalg failure (-inf keeps optimizers moving)
                return -np.inf
            return val
        if self._sparse_traced_ready():
            val = self._sparse_lml_eval(hyperparameters)
            return val if np.isfinite(val) else -np.inf
        K = self.prior.compute_prior_covariance_matrix(self.x_data, hyperparameters)
        V = self.likelihood.calculate_V(self.x_data, hyperparameters)
        m = self.prior.compute_mean(self.x_data, hyperparameters)
        try:
            KVinvY, KVlogdet = self.compute_new_KVlogdet_KVinvY(K, V, m)
        except Exception as e:
            raise Exception(
                f"Linear algebra failed for hyperparameters {hyperparameters}: {e}"
            ) from e
        n = len(self.y_data)
        ym = jnp.asarray(self.y_data,
                         dtype=config.linalg_dtype(self.args)) - m[:, None]
        l1 = float(jnp.sum(ym * KVinvY)) / ym.shape[1]
        return -0.5 * (l1 + KVlogdet + n * np.log(2.0 * np.pi))

    def neg_log_likelihood(self, hyperparameters=None):
        return -self.log_likelihood(hyperparameters=hyperparameters)

    def log_likelihood_variance(self):
        """Variance of the latest stochastic LML evaluation — the SLQ
        estimator noise scaled by 0.25; None for exact modes
        (ref gp_marginal_likelihood.py:182-204)."""
        v = getattr(self.kv, "last_logdet_variance", None)
        if v is None:
            return None
        return 0.25 * float(v)

    def log_likelihood_value_and_gradient(self, hyperparameters):
        """(L, dL/dh) in one compiled pass on the traced path — the
        training hot loop calls this."""
        hyperparameters = np.asarray(hyperparameters)
        if self._traced_ready():
            _, vg = self._get_traced()
            val, grad = vg(config.asarray(hyperparameters))
            return float(val), config.to_numpy(grad)
        if self._sparse_traced_ready():
            # differentiable gp2Scale LML (mBCG custom VJP) — the reference
            # has NO sparse gradient and restricts training to MCMC/BO
            val, grad = self._sparse_lml_eval(hyperparameters, want_grad=True)
            if not np.isfinite(val):
                return -np.inf, np.zeros_like(hyperparameters, dtype=float)
            return val, grad
        if self.gp2Scale:
            # non-traceable kernel under gp2Scale: the value exists (sparse
            # iterative), the gradient raises with the reference's guidance
            val = self.log_likelihood(hyperparameters)
            grad = -self.neg_log_likelihood_gradient(hyperparameters)
            return val, np.asarray(grad)
        # host (numpy-kernel) path: assemble and factor the trial ONCE and
        # share it between the value and the formula gradient — previously
        # this path paid two kernel assemblies and two O(n^3) factorizations
        # per training step
        K = self.prior.compute_prior_covariance_matrix(self.x_data,
                                                       hyperparameters)
        V = self.likelihood.calculate_V(self.x_data, hyperparameters)
        m = self.prior.compute_mean(self.x_data, hyperparameters)
        try:
            KVinvY, KVlogdet = self.compute_new_KVlogdet_KVinvY(K, V, m)
        except Exception as e:
            raise Exception(
                f"Linear algebra failed for hyperparameters "
                f"{hyperparameters}: {e}") from e
        n = len(self.y_data)
        ym = jnp.asarray(self.y_data,
                         dtype=config.linalg_dtype(self.args)) - m[:, None]
        l1 = float(jnp.sum(ym * KVinvY)) / ym.shape[1]
        val = -0.5 * (l1 + KVlogdet + n * np.log(2.0 * np.pi))
        grad = -self._formula_gradient(hyperparameters,
                                       trial=(K, V, KVinvY))
        return val, np.asarray(grad)

    def neg_log_likelihood_gradient(self, hyperparameters=None, component=0):
        """Gradient of -L (ref gp_marginal_likelihood.py:224).  Under
        gp2Scale the gradient exists HERE (traced mBCG sparse LML) whenever
        the kernel is traceable — the reference raises unconditionally."""
        if self.gp2Scale:
            if self._sparse_traced_ready():
                hps = (self.hyperparameters if hyperparameters is None
                       else hyperparameters)
                _, grad = self._sparse_lml_eval(np.asarray(hps),
                                                want_grad=True)
                return -grad
            raise Exception("Can't compute neg_log_likelihood_gradient for "
                            "gp2Scale with a non-traceable (host numpy) "
                            "kernel")
        if hyperparameters is not None and self._traced_ready():
            _, vg = self._get_traced()
            _, grad = vg(config.asarray(np.asarray(hyperparameters)))
            return -config.to_numpy(grad)
        return self._formula_gradient(hyperparameters, component)

    def _formula_gradient(self, hyperparameters, component=0, trial=None):
        """Explicit-formula gradient for host callables / committed state
        (same math as ref gp_marginal_likelihood.py:243-309, including the
        ram-economy per-direction path).  ``trial=(K, V, KVinvY)`` reuses
        a caller's already-assembled trial state (the value+gradient path
        computes it once for both)."""
        if hyperparameters is None:
            KVinvY = self.kv.KVinvY
            K = self.prior.K
            V = self.likelihood.V
            KV = self.kv.addKV(K, V)
            hyperparameters = self.hyperparameters
        elif trial is not None:
            K, V, KVinvY = trial
            KV = self.kv.addKV(K, V)
        else:
            K = self.prior.compute_prior_covariance_matrix(self.x_data, hyperparameters)
            V = self.likelihood.calculate_V(self.x_data, hyperparameters)
            m = self.prior.compute_mean(self.x_data, hyperparameters)
            KV = self.kv.addKV(K, V)
            KVinvY = self.compute_new_KVinvY(KV, m)

        b = KVinvY[:, component]
        H = len(hyperparameters)
        n = len(self.x_data)
        dm_dh = self.prior.dm_dh(self.x_data, hyperparameters)
        dL_dH = np.zeros(H)
        dL_dHm = np.zeros(H)

        L = dops.cholesky_factor(self.kv._densify(KV))

        if not self.ram_economy:
            noise_der = self.likelihood.calculate_V_grad(self.x_data, hyperparameters)
            dK_dH = self.prior.dk_dh(self.x_data, self.x_data, hyperparameters)
            if noise_der.ndim == 2:
                idx = jnp.arange(n)
                dKV_dH = dK_dH.at[:, idx, idx].add(noise_der)
            else:
                dKV_dH = dK_dH + noise_der
            # batched solve: (H, n, n)
            sol = jax.vmap(lambda M: dops.cholesky_solve(L, M))(dKV_dH)
            traces = jax.vmap(jnp.trace)(sol)
            quad = jnp.einsum("i,hij,j->h", b, dKV_dH, b)
            dm_term = dm_dh @ b
            grads = jnp.where(dm_term == 0.0,
                              -0.5 * (quad - traces), 0.0)
            return config.to_numpy(grads) + config.to_numpy(-dm_term)
        for i in range(H):
            dL_dHm[i] = -float(dm_dh[i] @ b)
            noise_der = self.likelihood.calculate_V_grad(self.x_data,
                                                         hyperparameters, direction=i)
            dK = self.prior.dk_dh(self.x_data, self.x_data, hyperparameters,
                                  direction=i)
            if noise_der.ndim == 1:
                dKV = dops.add_diagonal(dK, noise_der)
            else:
                dKV = dK + noise_der
            if dL_dHm[i] == 0.0:
                sol = dops.cholesky_solve(L, dKV)
                mtrace = float(b @ (dKV @ b))
                dL_dH[i] = -0.5 * (mtrace - float(jnp.trace(sol)))
        return dL_dH + dL_dHm

    def neg_log_likelihood_hessian(self, hyperparameters=None):
        """Hessian of the negative LML.  On the traced path this is the
        EXACT ``jax.hessian`` (forward-over-reverse) of the compiled LML —
        the reference can only finite-difference its hand-written gradient
        (ref gp_marginal_likelihood.py:312-336); the FD-of-gradient engine
        is retained for host callables and non-Euclidean spaces."""
        if hyperparameters is None:
            hyperparameters = self.hyperparameters
        if self._traced_ready():
            self._get_traced()
            if getattr(self, "_lml_hess", None) is None:
                hess = jax.jit(jax.hessian(     # argnums=0: hps only
                    lambda h, *d: -self._lml_on(h, *d)))
                self._lml_hess = lambda h: hess(h, *self._lml_data)
            Hm = self._lml_hess(config.asarray(np.asarray(hyperparameters)))
            return np.asarray(Hm, dtype=np.float64)
        H = len(hyperparameters)
        d2 = np.zeros((H, H))
        # CENTRAL differences with a noise-aware step: the host gradient
        # itself carries FD-kernel noise (~1e-5 after the _fd_dk_dh step
        # fix), so a 1e-6 forward difference of it amplified that noise
        # ~10⁶× into a garbage Hessian; eps ~ 1e-3·|h| keeps the
        # amplification at ~1% against O(1) curvatures (measured on the
        # squared-exponential host-kernel oracle, tests/
        # test_host_callable_branches.py)
        for i in range(H):
            eps = 1e-3 * max(1.0, abs(float(hyperparameters[i])))
            hp = np.array(hyperparameters, dtype=np.float64)
            hm = np.array(hyperparameters, dtype=np.float64)
            hp[i] += eps
            hm[i] -= eps
            d2[i] = (self.neg_log_likelihood_gradient(hyperparameters=hp)
                     - self.neg_log_likelihood_gradient(hyperparameters=hm)
                     ) / (2.0 * eps)
        return 0.5 * (d2 + d2.T)

    def test_log_likelihood_gradient(self, hyperparameters, epsilon=1e-6):
        """FD vs analytic gradient self-test
        (ref gp_marginal_likelihood.py:338)."""
        thps = np.array(hyperparameters, dtype=np.float64)
        grad = np.empty(len(thps))
        base = self.log_likelihood(hyperparameters=thps)
        for i in range(len(thps)):
            aux = np.array(thps)
            aux[i] += epsilon
            grad[i] = (self.log_likelihood(hyperparameters=aux) - base) / epsilon
        analytical = -self.neg_log_likelihood_gradient(hyperparameters=thps)
        return grad, np.asarray(analytical)

    def __getstate__(self):
        state = dict(
            data=self.data, prior=self.prior, likelihood=self.likelihood,
            trainer=self.trainer, kv=self.kv,
            _warm_start_KVinvY=None if self._warm_start_KVinvY is None
            else np.asarray(self._warm_start_KVinvY))
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._traced_key = None
        self._lml_jit = None
        self._lml_vg = None
        self._lml_vmap = None
        self._bvg_dev = None
        self._sparse_cache = {}
        self._filter_mask_cache = None
