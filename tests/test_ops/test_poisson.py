"""Unbounded Poisson solver tests.

Oracle 1: the Hockney-Eastwood doubled-domain FFT convolution equals the
direct O(N^2) Green's-function sum exactly - validate against a brute-force
numpy sum on small grids (this plays the role of the reference's serial
PYFFTW oracle, tests/.../test_unbounded_poisson_solver_mpi_2d.py).
Oracle 2: physical far-field behavior of a compact 3D blob.
Oracle 3: sharded == single-device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sopht_mpi_tpu.ops import UnboundedPoissonSolver2D, UnboundedPoissonSolver3D
from sopht_mpi_tpu.parallel import create_mesh, shard_scalar_field
from sopht_mpi_tpu.utils import get_real_t, get_test_tol


def _greens_2d(r, dx):
    with np.errstate(divide="ignore"):
        g = -np.log(r) / (2 * np.pi)
    g[r == 0] = -(2 * np.log(dx / np.sqrt(np.pi)) - 1) / (4 * np.pi)
    return g


def _greens_3d(r, dx):
    with np.errstate(divide="ignore"):
        g = 1.0 / (4 * np.pi * r)
    g[r == 0] = 1.0 / (4 * np.pi * dx)
    return g


def test_poisson_2d_matches_direct_sum(precision):
    real_t = get_real_t(precision)
    n = 16
    solver = UnboundedPoissonSolver2D(n, n, x_range=1.0, real_t=real_t)
    dx = solver.dx
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal((n, n)).astype(np.dtype(real_t))

    out = np.asarray(solver.solve(jnp.asarray(rhs)))

    x = np.arange(n) * dx
    X, Y = np.meshgrid(x, x)  # [y, x] grid positions (same spacing both)
    ref = np.zeros_like(rhs, dtype=np.float64)
    for i in range(n):
        for j in range(n):
            r = np.sqrt((X - X[i, j]) ** 2 + (Y - Y[i, j]) ** 2)
            ref[i, j] = np.sum(_greens_2d(r, dx) * rhs) * dx**2
    tol = 100 * get_test_tol(precision)
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max())


def test_poisson_3d_matches_direct_sum(precision):
    real_t = get_real_t(precision)
    n = 8
    solver = UnboundedPoissonSolver3D(n, n, n, x_range=1.0, real_t=real_t)
    dx = solver.dx
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal((n, n, n)).astype(np.dtype(real_t))

    out = np.asarray(solver.solve(jnp.asarray(rhs)))

    idx = np.arange(n) * dx
    Z, Y, X = np.meshgrid(idx, idx, idx, indexing="ij")
    ref = np.zeros_like(rhs, dtype=np.float64)
    for i in range(n):
        for j in range(n):
            for k in range(n):
                r = np.sqrt(
                    (X - X[i, j, k]) ** 2
                    + (Y - Y[i, j, k]) ** 2
                    + (Z - Z[i, j, k]) ** 2
                )
                ref[i, j, k] = np.sum(_greens_3d(r, dx) * rhs) * dx**3
    tol = 100 * get_test_tol(precision)
    np.testing.assert_allclose(out, ref, atol=tol * np.abs(ref).max())


def test_poisson_3d_far_field_physical():
    """Compact blob: potential far from it approaches Q/(4 pi r)."""
    n = 64
    solver = UnboundedPoissonSolver3D(n, n, n, x_range=1.0, real_t=jnp.float64)
    dx = solver.dx
    x = (np.arange(n) + 0.5) * dx
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    sigma = 0.03
    r2 = (X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.5) ** 2
    rhs = np.exp(-r2 / (2 * sigma**2))
    sol = np.asarray(solver.solve(jnp.asarray(rhs)))
    total = rhs.sum() * dx**3
    # probe at distance 0.3 from the blob center
    i = int(0.8 / dx)
    r_probe = np.sqrt(
        (X[i, n // 2, n // 2] - 0.5) ** 2
        + (Y[i, n // 2, n // 2] - 0.5) ** 2
        + (Z[i, n // 2, n // 2] - 0.5) ** 2
    )
    expected = total / (4 * np.pi * r_probe)
    np.testing.assert_allclose(sol[i, n // 2, n // 2], expected, rtol=1e-3)


@pytest.mark.parametrize(
    "dim,mesh_shape", [(2, (8, 1)), (2, (4, 1)), (2, (4, 2)), (2, (2, 4)), (3, (8, 1)), (3, (4, 2))]
)
def test_poisson_sharded_matches_single(dim, mesh_shape):
    n = 16
    rng = np.random.default_rng(5)
    if dim == 2:
        rhs = rng.standard_normal((n, n))
        single = UnboundedPoissonSolver2D(n, n, real_t=jnp.float64)
        mesh = create_mesh(2, mesh_shape)
        multi = UnboundedPoissonSolver2D(n, n, real_t=jnp.float64, mesh=mesh)
    else:
        rhs = rng.standard_normal((n, n, n))
        single = UnboundedPoissonSolver3D(n, n, n, real_t=jnp.float64)
        mesh = create_mesh(3, mesh_shape)
        multi = UnboundedPoissonSolver3D(n, n, n, real_t=jnp.float64, mesh=mesh)

    out_single = np.asarray(single.solve(jnp.asarray(rhs)))
    rhs_sharded = shard_scalar_field(jnp.asarray(rhs), mesh)
    out_multi = np.asarray(jax.jit(multi.solve)(rhs_sharded))
    np.testing.assert_allclose(out_multi, out_single, atol=1e-12)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (2, 4)])
def test_poisson_sharded_matches_single_asymmetric_grid(mesh_shape):
    """Distinct nz/ny/nx catch axis mix-ups in the lazy-padded distributed
    convolution (parallel/fft.py distributed_free_space_convolve)."""
    nz, ny, nx = 8, 16, 32
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((nz, ny, nx))
    single = UnboundedPoissonSolver3D(nz, ny, nx, real_t=jnp.float64)
    mesh = create_mesh(3, mesh_shape)
    multi = UnboundedPoissonSolver3D(nz, ny, nx, real_t=jnp.float64, mesh=mesh)
    out_single = np.asarray(single.solve(jnp.asarray(rhs)))
    rhs_sharded = shard_scalar_field(jnp.asarray(rhs), mesh)
    out_multi = np.asarray(jax.jit(multi.solve)(rhs_sharded))
    np.testing.assert_allclose(out_multi, out_single, atol=1e-12)


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_device_greens_build_matches_host_build(mesh_shape):
    """The mesh solver's on-device Green's function (the large-grid
    default) lands sharded and matches the float64 host build."""
    nz, ny, nx = 8, 16, 16
    mesh = create_mesh(3, mesh_shape)
    host = UnboundedPoissonSolver3D(nz, ny, nx, mesh=mesh,
                                    build_greens_on_device=False)
    dev = UnboundedPoissonSolver3D(nz, ny, nx, mesh=mesh,
                                   build_greens_on_device=True)
    g_host = np.asarray(host.fourier_greens_times_dx_pow_dim)
    g_dev = dev.fourier_greens_times_dx_pow_dim
    assert g_dev.sharding.is_equivalent_to(
        host.fourier_greens_times_dx_pow_dim.sharding, g_dev.ndim
    )
    np.testing.assert_allclose(np.asarray(g_dev), g_host, rtol=1e-6,
                               atol=1e-6 * np.abs(g_host).max())


def test_solver_overlap_chunks_param_is_exact_and_threads():
    """The solver/simulator `overlap_chunks` constructor parameter (the
    unpipelined control arm of an overlap measurement) reaches the
    distributed convolve and the unpipelined form is bit-equal to the
    chunked default."""
    n = 16
    rng = np.random.default_rng(9)
    rhs = rng.standard_normal((n, n, n)).astype(np.float32)
    mesh = create_mesh(3, (4, 2))
    s_default = UnboundedPoissonSolver3D(n, n, n, mesh=mesh)
    s_control = UnboundedPoissonSolver3D(n, n, n, mesh=mesh,
                                         overlap_chunks=1)
    assert s_control.overlap_chunks == 1
    rhs_sharded = shard_scalar_field(jnp.asarray(rhs), mesh)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(s_control.solve)(rhs_sharded)),
        np.asarray(jax.jit(s_default.solve)(rhs_sharded)),
    )
    # and the simulator threads it to its Poisson solver
    from sopht_mpi_tpu.models import UnboundedFlowSimulator3D

    sim = UnboundedFlowSimulator3D(
        grid_size=(n, n, n), x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes", mesh=mesh, overlap_chunks=1,
    )
    assert sim.unbounded_poisson_solver.overlap_chunks == 1
