"""fvgp_tpu — an exact Gaussian-process framework in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of
lbl-camera/fvGP: single-task / multi-task / non-Euclidean exact GPs,
pluggable kernel/mean/noise callables, six hyperparameter-training methods
(sync + async), a swappable linear-algebra state machine from dense Cholesky
to preconditioned Krylov + stochastic-Lanczos log-determinants, and a
distributed block-sparse covariance path ("gp2Scale" equivalent) sharded
over device meshes.

Public surface mirrors the reference (/root/reference/fvgp/__init__.py):
``GP``, ``fvGP``, ``gpMCMC``, ``ProposalDistribution``, ``GGMP``.
"""

from . import config  # noqa: F401  (must run first: enables x64)
from .models.gp import GP  # noqa: E402
from .models.fvgp import fvGP  # noqa: E402
from .models.gp_mcmc import gpMCMC, ProposalDistribution  # noqa: E402
from .models import ggmp  # noqa: E402  (module export, ref __init__.py:19)
from .models.ggmp import GGMP  # noqa: E402
from .models.gplvm import GPLVM  # noqa: E402
from .models.gpm import GPm  # noqa: E402

__all__ = ["GP", "fvGP", "gpMCMC", "ProposalDistribution", "ggmp", "GGMP",
           "GPLVM", "GPm"]
__version__ = "0.1.0"
