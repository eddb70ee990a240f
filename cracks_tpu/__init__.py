"""cracks_tpu — a phase-field fracture framework in JAX.

A from-scratch JAX/XLA reimplementation of the capabilities of the
pfm-cracks application (Heister/Wheeler/Wick, CMAME 290 (2015) 466-495):

 * quasi-monolithic displacement / phase-field formulation,
 * primal-dual active set treatment of crack irreversibility,
 * predictor-corrector mesh adaptivity,
 * parallelism via SPMD sharding of element arrays over an accelerator
   device mesh (instead of MPI + p4est + Trilinos).

Design: a structured adaptive quad-/octree forest over an unstructured
coarse root mesh, batched Q1 element quadrature as dense `(n_cells, ...)`
array math, matrix-free Jacobian-vector products via `jax.jvp`, and
masked semismooth Newton for the irreversibility constraint.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# The physics requires float64 for the tolerances used by the reference
# test suite (Newton residuals down to 1e-10).  Individual kernels can be
# instantiated in float32 for speed; the default is double precision.
_jax.config.update("jax_enable_x64", True)


def compilation_cache_dir(environ=_os.environ) -> str | None:
    """Directory to give JAX's persistent compilation cache, or None.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself and the package must not override it.  Otherwise a
    fixed ``.jax_cache`` directory in the checkout — the path is part of
    the cache key, so it must not move between runs.  Disable the cache
    with JAX's own ``JAX_ENABLE_COMPILATION_CACHE=false``."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache")


_cache_dir = compilation_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)

from .config import Parameters, parse_prm, default_parameters  # noqa: E402,F401
