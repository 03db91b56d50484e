"""Multi-chip gp2Scale over a device mesh — the row-partitioned scale path.

Each mesh device owns a contiguous range of covariance row blocks and
exactly the tiles that write them, so the training step's SpMM needs no
cross-device reduction (parallel/partition.py; comm model in
docs/source/comm_model.md).  The SAME public-API code runs on one chip, a
multi-GPU host, or — as here, for demonstration — a virtual CPU mesh.

Run with a virtual 8-device mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_mesh.py
"""
import os as _os, sys as _sys
# runnable from a bare checkout: put the repo root on sys.path
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np


def main():
    import jax

    from fvgp_tpu import GP
    from fvgp_tpu.parallel import mesh as pmesh
    from fvgp_tpu.parallel.ordering import morton_order

    n_dev = len(jax.devices())
    print(f"{n_dev} device(s) on platform {jax.devices()[0].platform}")

    rng = np.random.default_rng(0)
    n = 2000
    x = rng.uniform(0, 60, (n, 2))
    x = x[morton_order(x)]                    # spatial locality -> tile
    y = np.sin(x[:, 0]) + 0.05 * rng.standard_normal(n)   # sparsity + halo

    mesh = pmesh.make_mesh(n_dev)
    with pmesh.use_mesh(mesh):
        gp = GP(x, y, init_hyperparameters=np.array([1.0, 2.0, 2.0]),
                gp2Scale=True,
                args={"gp2Scale_block_size": 64,
                      "gp2Scale_precond_width": 2,
                      # collective selection: "auto" (default) picks the
                      # halo exchange when its measured volume beats the
                      # X all-gather; True/False force it
                      "gp2Scale_halo_exchange": "auto"})
        print("LML:", round(gp.log_likelihood(), 2))
        # gradient-based training AT SCALE — the reference cannot do this
        # (its sparse path has no gradient); here the row-partitioned mBCG
        # LML is one differentiable program over the mesh
        gp.train(method="adam", max_iter=25)
        print("trained hps:", np.round(gp.hyperparameters, 3),
              "| LML:", round(gp.log_likelihood(), 2))
        xp = x[:5] + 0.05
        print("posterior mean:",
              np.round(np.asarray(gp.posterior_mean(xp)["m(x)"]), 3))

    # multi-slice: the same program on a 2-D (slice, tiles) mesh — slices
    # own contiguous Morton ranges (DCN boundary), chips own sub-ranges
    if n_dev >= 4 and n_dev % 2 == 0:
        with pmesh.use_mesh(pmesh.make_mesh_2d(2, n_dev // 2)):
            gp2 = GP(x, y, init_hyperparameters=np.array([1.0, 2.0, 2.0]),
                     gp2Scale=True, args={"gp2Scale_block_size": 64})
            print("2-D (2 x", n_dev // 2, ") mesh LML:",
                  round(gp2.log_likelihood(), 2))


if __name__ == "__main__":
    main()
