"""The single-device free-space Poisson solvers (lazy padding, early
truncation, Green's spectrum from the half-grid kernel) against a numpy
float64 dense convolution on the doubled domain, with the free-space
Green's function built independently in float64: 2D and 3D, scalar and
3-component, including odd and anisotropic grids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sopht_mpi_tpu.ops import UnboundedPoissonSolver2D, UnboundedPoissonSolver3D
from sopht_mpi_tpu.utils import get_real_t

# float32 solves land in the 1e-7..1e-6 class; float64 in 1e-13
RTOL = {"single": 2e-6, "double": 1e-11}


def dense_free_space_solve(rhs, dx):
    """Doubled-domain dense FFT convolution of a 2D or 3D ``rhs`` with the
    even-reflected free-space Green's function."""
    doubled = tuple(2 * n for n in rhs.shape)
    dist = np.meshgrid(
        *[np.minimum(np.arange(m), m - np.arange(m)) * dx for m in doubled],
        indexing="ij",
    )
    r = np.sqrt(sum(d * d for d in dist))
    origin = (0,) * rhs.ndim
    with np.errstate(divide="ignore"):
        if rhs.ndim == 3:
            g = 1.0 / (4.0 * np.pi * r)
            g[origin] = 1.0 / (4.0 * np.pi * dx)
        else:
            g = -np.log(r) / (2.0 * np.pi)
            g[origin] = -(2.0 * np.log(dx / np.sqrt(np.pi)) - 1.0) / (
                4.0 * np.pi
            )
    axes = tuple(range(rhs.ndim))
    ghat = np.fft.rfftn(g) * dx**rhs.ndim
    out = np.fft.irfftn(
        np.fft.rfftn(rhs, doubled, axes=axes) * ghat, doubled, axes=axes
    )
    return out[tuple(slice(0, n) for n in rhs.shape)]


def _solve_ref(rhs, dx, batched):
    if batched:
        return np.stack([dense_free_space_solve(c, dx) for c in rhs])
    return dense_free_space_solve(rhs, dx)


def _check(got, want, precision):
    rel = np.linalg.norm(np.asarray(got, np.float64) - want) / (
        np.linalg.norm(want)
    )
    assert rel <= RTOL[precision], rel


@pytest.mark.parametrize(
    "grid", [(32, 32, 32), (16, 24, 32), (8, 16, 64), (9, 12, 10), (32, 8, 16)]
)
def test_3d_scalar_solve_matches_dense_f64(grid, precision):
    real_t = get_real_t(precision)
    rhs = np.random.default_rng(0).standard_normal(grid)
    solver = UnboundedPoissonSolver3D(*grid, x_range=1.0, real_t=real_t)
    got = jax.jit(solver.solve)(jnp.asarray(rhs, real_t))
    _check(got, _solve_ref(rhs, solver.dx, False), precision)


@pytest.mark.parametrize("grid", [(32, 32, 32), (8, 16, 64)])
def test_3d_vector_solve_matches_dense_f64(grid, precision):
    real_t = get_real_t(precision)
    rhs = np.random.default_rng(1).standard_normal((3, *grid))
    solver = UnboundedPoissonSolver3D(*grid, x_range=1.0, real_t=real_t)
    got = jax.jit(solver.vector_field_solve)(jnp.asarray(rhs, real_t))
    _check(got, _solve_ref(rhs, solver.dx, True), precision)


@pytest.mark.parametrize("grid", [(32, 32), (64, 64), (128, 128), (32, 512)])
def test_2d_scalar_solve_matches_dense_f64(grid, precision):
    real_t = get_real_t(precision)
    rhs = np.random.default_rng(2).standard_normal(grid)
    solver = UnboundedPoissonSolver2D(*grid, x_range=1.0, real_t=real_t)
    got = jax.jit(solver.solve)(jnp.asarray(rhs, real_t))
    _check(got, _solve_ref(rhs, solver.dx, False), precision)


@pytest.mark.parametrize("grid", [(64, 64), (16, 48)])
def test_2d_three_component_solve_matches_dense_f64(grid, precision):
    real_t = get_real_t(precision)
    rhs = np.random.default_rng(3).standard_normal((3, *grid))
    solver = UnboundedPoissonSolver2D(*grid, x_range=1.0, real_t=real_t)
    got = jax.jit(jax.vmap(solver.solve))(jnp.asarray(rhs, real_t))
    _check(got, _solve_ref(rhs, solver.dx, True), precision)
