"""Precision utilities.

JAX counterpart of the reference's precision helpers
(``sopht.utils.precision.get_real_t / get_test_tol``, used throughout
/root/reference/sopht_mpi and its tests). float32 is the default flow
precision (reference: flow_simulators_mpi_2d.py:32); float64 is supported on
CPU (and via jax_enable_x64) for the double-precision test tier.
"""

import jax.numpy as jnp
import numpy as np


def get_real_t(precision: str = "single"):
    """Return the floating dtype for a named precision level."""
    if precision == "single":
        return jnp.float32
    elif precision == "double":
        return jnp.float64
    raise ValueError(f"Invalid precision: {precision}")


def get_test_tol(precision: str = "single") -> float:
    """Testing tolerance matching the reference's numerical parity contract."""
    if precision == "single":
        return float(1e3 * np.finfo(np.float32).eps)
    elif precision == "double":
        return float(1e6 * np.finfo(np.float64).eps)
    raise ValueError(f"Invalid precision: {precision}")


def get_dtype_eps(real_t) -> float:
    return float(np.finfo(np.dtype(real_t)).eps)
