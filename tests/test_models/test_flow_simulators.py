"""Flow simulator integration tests (the role of the reference's
tests/test_simulator/test_flow/test_flow_simulators_2d.py, _3d.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sopht_mpi_tpu.models import (
    UnboundedFlowSimulator2D,
    UnboundedFlowSimulator3D,
)
from sopht_mpi_tpu.parallel import (
    create_mesh,
    shard_scalar_field,
    shard_vector_field,
)


def test_stable_timestep_2d():
    sim = UnboundedFlowSimulator2D(
        grid_size=(32, 32), x_range=1.0, kinematic_viscosity=1e-2,
        flow_type="navier_stokes", real_t=jnp.float64,
    )
    sim.velocity_field = sim.velocity_field.at[0].set(2.0).at[1].set(1.0)
    dt = sim.compute_stable_timestep()
    dx = sim.dx
    expected = min(0.1 * dx / 3.0, 0.9 * dx**2 / 4 / 1e-2)
    assert dt == pytest.approx(expected, rel=1e-4)


def test_stable_timestep_3d():
    sim = UnboundedFlowSimulator3D(
        grid_size=(16, 16, 16), x_range=1.0, kinematic_viscosity=1e-2,
        flow_type="navier_stokes", real_t=jnp.float64,
    )
    sim.velocity_field = (
        sim.velocity_field.at[0].set(1.0).at[1].set(1.0).at[2].set(1.0)
    )
    dt = sim.compute_stable_timestep()
    dx = sim.dx
    expected = min(0.1 * dx / 3.0, 0.9 * dx**2 / 6 / 1e-2)
    assert dt == pytest.approx(expected, rel=1e-4)


@pytest.mark.parametrize("flow_type", ["passive_scalar", "passive_vector"])
def test_3d_passive_advection_diffusion_analytical(flow_type):
    """Advecting-diffusing Gaussian blob vs the analytical solution (the
    reference's PointSourceAdvectAndDiffuse case contract)."""
    n = 64
    nu = 1e-3
    sim = UnboundedFlowSimulator3D(
        grid_size=(n, n, n), x_range=1.0, kinematic_viscosity=nu,
        flow_type=flow_type, real_t=jnp.float64,
    )
    dx = sim.dx
    x = np.asarray(sim.position_field[0])
    y = np.asarray(sim.position_field[1])
    z = np.asarray(sim.position_field[2])
    U = np.array([0.5, 0.4, 0.3])
    t0 = 2.0

    def blob(t, c):
        r2 = (x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2
        return (t0 / t) ** 1.5 * np.exp(-r2 / (4 * nu * t))

    c0 = np.array([0.35, 0.35, 0.35])
    field0 = blob(t0, c0)
    if flow_type == "passive_vector":
        sim.primary_vector_field = jnp.asarray(
            np.stack([field0, 0.5 * field0, -field0])
        )
    else:
        sim.primary_field = jnp.asarray(field0)
    sim.velocity_field = jnp.asarray(
        np.broadcast_to(U[:, None, None, None], (3, n, n, n)).copy()
    )

    t_advect = 0.25
    t = 0.0
    while t < t_advect:
        dt = min(sim.compute_stable_timestep(), t_advect - t)
        sim.time_step(dt)
        t += dt

    ref = blob(t0 + t_advect, c0 + U * t_advect)
    out = np.asarray(
        sim.primary_field if flow_type == "passive_scalar"
        else sim.primary_vector_field[0]
    )
    err = np.abs(out - ref).max() / ref.max()
    assert err < 2e-2, f"advection-diffusion error {err}"


@pytest.mark.parametrize("filter_vorticity", [False, True])
def test_3d_navier_stokes_vortex_ring_smoke(filter_vorticity):
    """NS 3D: a Gaussian vortex ring stays divergence-free and bounded."""
    n = 32
    sim = UnboundedFlowSimulator3D(
        grid_size=(n, n, n), x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes", with_free_stream_flow=True,
        real_t=jnp.float64, filter_vorticity=filter_vorticity,
        filter_setting_dict={"order": 1, "type": "multiplicative"},
    )
    x = np.asarray(sim.position_field[0])
    y = np.asarray(sim.position_field[1])
    z = np.asarray(sim.position_field[2])
    # solenoidal vorticity: omega = curl of a vector potential
    psi = np.exp(
        -((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) / 0.02
    )
    dpsi_dy = np.gradient(psi, sim.dx, axis=1)
    dpsi_dz = np.gradient(psi, sim.dx, axis=0)
    omega = np.stack([dpsi_dy * 0, dpsi_dz, -dpsi_dy])  # curl(psi x_hat)
    omega = np.stack([np.zeros_like(psi), dpsi_dz, -dpsi_dy])
    sim.vorticity_field = jnp.asarray(omega)

    w0 = sim.get_max_vorticity()
    for _ in range(5):
        dt = sim.compute_stable_timestep()
        sim.time_step(dt, free_stream_velocity=(1.0, 0.0, 0.0))
    assert np.isfinite(np.asarray(sim.vorticity_field)).all()
    assert sim.get_max_vorticity() < 2.0 * w0
    div_norm = sim.get_vorticity_divergence_l2_norm()
    assert div_norm < 1e-2 * w0


def test_3d_sharded_matches_single():
    n = 32
    rng = np.random.default_rng(0)
    omega0 = np.zeros((3, n, n, n))
    omega0[:, 10:22, 10:22, 10:22] = rng.standard_normal((3, 12, 12, 12))
    results = []
    for mesh_shape in (None, (4, 2)):
        mesh = None if mesh_shape is None else create_mesh(3, mesh_shape)
        sim = UnboundedFlowSimulator3D(
            grid_size=(n, n, n), x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes", real_t=jnp.float64, mesh=mesh,
            filter_vorticity=True,
        )
        sim.vorticity_field = shard_vector_field(jnp.asarray(omega0), mesh)
        for _ in range(3):
            sim.time_step(1e-3)
        results.append(np.asarray(sim.vorticity_field))
    np.testing.assert_allclose(results[0], results[1], atol=1e-10)


def test_2d_with_forcing_resets_forcing_field():
    sim = UnboundedFlowSimulator2D(
        grid_size=(32, 32), x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing", real_t=jnp.float64,
    )
    sim.eul_grid_forcing_field = sim.eul_grid_forcing_field.at[:].set(1.0)
    sim.time_step(1e-3)
    np.testing.assert_array_equal(np.asarray(sim.eul_grid_forcing_field), 0.0)


