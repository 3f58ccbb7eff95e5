"""Reverse mode of the linear operators on the flow step's path: for each
operator A, ``jax.vjp`` must be its exact transpose, <A x, y> = <x, A^T y>
in float64 - the free-space convolutions (single-device and sharded) and
the stencils the adjoint/inversion examples differentiate through."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sopht_mpi_tpu.ops import (
    UnboundedPoissonSolver2D,
    UnboundedPoissonSolver3D,
    cross_product_3d,
    curl_3d,
    diffusion_timestep_vector_3d,
    laplacian_filter_vector_3d,
    penalise_field_boundary_vector_3d,
    update_vorticity_from_velocity_forcing_3d,
)
from sopht_mpi_tpu.parallel import (
    create_mesh,
    distributed_rfftn,
    shard_scalar_field,
)


def _solver_op(kind):
    if kind == "poisson-3d":
        s = UnboundedPoissonSolver3D(12, 10, 14, real_t=jnp.float64)
        return s.solve, (12, 10, 14)
    if kind == "poisson-3d-vector":
        s = UnboundedPoissonSolver3D(8, 8, 12, real_t=jnp.float64)
        return s.vector_field_solve, (3, 8, 8, 12)
    s = UnboundedPoissonSolver2D(24, 16, real_t=jnp.float64)
    return s.solve, (24, 16)


def _distributed_op(grid_dim, mesh_shape, batched=False):
    from sopht_mpi_tpu.parallel.fft import distributed_free_space_convolve

    grid = (16, 16, 16) if grid_dim == 3 else (16, 16)
    mesh = create_mesh(grid_dim, mesh_shape)
    rng = np.random.default_rng(7)
    half = rng.standard_normal(tuple(n + 1 for n in grid))
    idx = [np.minimum(np.arange(2 * n), 2 * n - np.arange(2 * n))
           for n in grid]
    kernel = jnp.asarray(half[np.ix_(*idx)])
    g = jnp.real(distributed_rfftn(shard_scalar_field(kernel, mesh), mesh))
    shape = (3, *grid) if batched else grid
    return (lambda x: distributed_free_space_convolve(x, g, mesh)), shape


def _stencil_op(kind):
    shape = (3, 9, 12, 10)
    u = jnp.asarray(np.random.default_rng(8).standard_normal(shape))
    return {
        "diffusion": lambda w: diffusion_timestep_vector_3d(w, 0.3),
        "curl": lambda w: curl_3d(w, 0.5),
        "filter-multiplicative": lambda w: laplacian_filter_vector_3d(
            w, 2, "multiplicative"),
        "filter-convolution": lambda w: laplacian_filter_vector_3d(
            w, 1, "convolution"),
        "penalise": lambda w: penalise_field_boundary_vector_3d(w, 2),
        "rotational-update": lambda w: update_vorticity_from_velocity_forcing_3d(
            w, cross_product_3d(u, w), 0.05),
    }[kind], shape


def _check_adjoint(op, shape):
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal(shape))
    ax, vjp = jax.vjp(jax.jit(op), x)
    y = jnp.asarray(rng.standard_normal(ax.shape))
    (aty,) = vjp(y)
    lhs = float(jnp.vdot(ax, y))
    rhs = float(jnp.vdot(x, aty))
    assert abs(lhs - rhs) <= 1e-11 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("kind", ["poisson-3d", "poisson-3d-vector",
                                  "poisson-2d"])
def test_single_device_convolve_vjp_is_transpose(kind):
    _check_adjoint(*_solver_op(kind))


@pytest.mark.parametrize("grid_dim,mesh_shape,batched", [
    (3, (4, 2), False), (3, (2, 4), True), (2, (4, 2), False),
])
def test_distributed_convolve_vjp_is_transpose(grid_dim, mesh_shape, batched):
    _check_adjoint(*_distributed_op(grid_dim, mesh_shape, batched))


@pytest.mark.parametrize("kind", [
    "diffusion", "curl", "filter-multiplicative", "filter-convolution",
    "penalise", "rotational-update",
])
def test_stencil_vjp_is_transpose(kind):
    _check_adjoint(*_stencil_op(kind))
