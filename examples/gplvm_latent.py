"""GPLVM — learn a 1-D latent embedding of a curve observed in 5-D
(parity target: the reference's dev/gplvm.py fork), then use the full
posterior suite at NEW latent coordinates.

Shows the round-4 surface: joint Adam training (latents + kernel hps +
noise as ONE jitted value_and_grad program), the L-BFGS-B and MCMC
training dispatch, and posterior mean/variance/entropy at query latents.
"""
import os as _os, sys as _sys
# runnable from a bare checkout: put the repo root on sys.path
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np

from fvgp_tpu import GPLVM


def main():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, np.pi, 80))           # hidden 1-D parameter
    Y = np.stack([np.sin(t), np.cos(t), np.sin(2 * t), np.cos(2 * t),
                  0.3 * t], axis=1)
    Y += 0.01 * rng.standard_normal(Y.shape)

    m = GPLVM(Y, latent_dim=1)
    print("initial LML:", m.log_likelihood())

    # 1) joint Adam over (latents, kernel hps, noise) — the accelerator-first path
    m.train(max_iter=600)
    print("after adam:  LML:", m.log_likelihood())

    # 2) polish jointly with L-BFGS-B under a hyperparameter box
    bounds = np.array([[1e-2, 1e2], [1e-2, 1e2], [1e-5, 1.0]])
    m.train(method="local", hyperparameter_bounds=bounds, max_iter=100)
    print("after local: LML:", m.log_likelihood(),
          " theta:", m.get_hyperparameters())

    # 3) sample the hyperparameters by MCMC at the learned latents
    m.train(method="mcmc", hyperparameter_bounds=bounds, max_iter=400)
    print("after mcmc:  LML:", m.log_likelihood(),
          " MAP:", m.mcmc_info["MAP"])

    # the learned latent must order the points along the hidden curve
    z = m.latent_coordinates[:, 0]
    corr = abs(np.corrcoef(np.argsort(np.argsort(z)), np.arange(len(t)))[0, 1])
    print("latent/parameter rank correlation:", round(corr, 3))

    # posterior suite at NEW latent coordinates
    zq = np.linspace(z.min(), z.max(), 9).reshape(-1, 1)
    mean = m.posterior_mean(zq)["m(x)"]              # (9, 5) decoded curve
    var = m.posterior_covariance(zq, variance_only=True)["v(x)"]
    print("decoded shape:", mean.shape, " max posterior sd:",
          float(np.sqrt(var.max())))
    print("joint-prior entropy at queries:", round(m.gp_entropy(zq), 2))

    rec = m.reconstruct()
    rel = np.linalg.norm(rec - Y) / np.linalg.norm(Y - Y.mean(axis=0))
    print("reconstruction relative error:", round(rel, 4))


if __name__ == "__main__":
    main()
