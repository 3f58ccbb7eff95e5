"""Fused on-device FSI loop vs the host-driven loop (exact parity)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from sopht_mpi_tpu.models import (
    AnalyticalLinearDamper,
    BaseSystemCollection,
    CircularCylinderForcingGrid,
    CosseratRod,
    CosseratRodElementCentricForcingGrid,
    CosseratRodFlowInteraction,
    Cylinder,
    OneEndFixedBC,
    PositionVerlet,
    RigidBodyFlowInteraction,
    UnboundedFlowSimulator2D,
    build_rigid_fsi_step,
    build_rod_fsi_step,
    extend_stepper_interface,
    init_rigid_fsi_carry,
    init_rod_fsi_carry,
    scan_steps,
)


def _cylinder_case(real_t=jnp.float64):
    flow_sim = UnboundedFlowSimulator2D(
        grid_size=(32, 32),
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
    )
    cyl = Cylinder(center=(0.4, 0.5), radius=0.08, dtype=real_t)
    grid = CircularCylinderForcingGrid(rigid_body=cyl, num_forcing_points=16)
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=cyl,
        forcing_grid=grid,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
    )
    return flow_sim, interactor


def test_rigid_fsi_scan_matches_host_loop():
    """The fused scanned step reproduces the host-driven reference loop
    (time_step -> interactor() -> flow step) bit-for-bit in float64."""
    n_steps = 4
    fsv = (1.0, 0.0)

    # host loop
    flow_sim, interactor = _cylinder_case()
    flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
    for _ in range(n_steps):
        dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)
        interactor.time_step(dt)
        interactor()
        flow_sim.time_step(dt, free_stream_velocity=fsv)
    host_vort = np.asarray(flow_sim.vorticity_field)
    host_mismatch = np.asarray(interactor.state.position_mismatch)

    # fused scan
    flow_sim2, interactor2 = _cylinder_case()
    flow_sim2.velocity_field = jnp.ones_like(flow_sim2.velocity_field)
    step = build_rigid_fsi_step(
        flow_sim2,
        interactor2,
        dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray(fsv, jnp.float64),
    )
    carry, lag_forces = scan_steps(
        step, init_rigid_fsi_carry(flow_sim2, interactor2), n_steps
    )
    np.testing.assert_allclose(
        np.asarray(carry.flow_state.primary_scalar_field),
        host_vort,
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(carry.vb_state.position_mismatch), host_mismatch, atol=1e-13
    )
    assert lag_forces.shape == (n_steps, 2)
    assert np.abs(np.asarray(lag_forces)).max() > 0


def _rod_case(real_t=jnp.float64):
    from sopht_mpi_tpu.models import FlowForces

    flow_sim = UnboundedFlowSimulator2D(
        grid_size=(32, 32),
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
    )
    flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
    rod = CosseratRod.straight_rod(
        8,
        np.array([0.5, 0.3, 0.0]),
        np.array([0.0, 1.0, 0.0]),
        np.array([0.0, 0.0, 1.0]),
        base_length=0.4,
        base_radius=0.02,
        density=1e3,
        youngs_modulus=1e5,
        shear_modulus=1e5 / 1.5,
    )
    collection = BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=CosseratRodElementCentricForcingGrid,
    )
    return flow_sim, rod, collection, interactor


def test_rod_fsi_scan_matches_host_loop():
    """With one rod substep per flow step, the fused scanned rod-FSI step
    reproduces the host-driven loop (do_step -> interactor.time_step ->
    interactor() -> flow step) bit-for-bit in float64."""
    from sopht_mpi_tpu.models import FlowForces

    n_steps = 3
    fsv = (1.0, 0.0)

    # host loop (reference flow_past_rod.py:276-300 structure, nsub = 1)
    flow_sim, rod, collection, interactor = _rod_case()
    collection.add_forcing_to(rod).using(FlowForces, interactor)
    collection.finalize()
    ts = PositionVerlet()
    do_step, stages = extend_stepper_interface(ts, collection)
    rod_time = 0.0
    for _ in range(n_steps):
        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)
        rod_time = do_step(ts, stages, collection, rod_time, flow_dt)
        interactor.time_step(dt=flow_dt)
        interactor()
        flow_sim.time_step(flow_dt, free_stream_velocity=fsv)
    host_vort = np.asarray(flow_sim.vorticity_field)
    host_tip = np.asarray(rod.position_collection[:, -1])
    host_mismatch = np.asarray(interactor.state.position_mismatch)

    # fused scan (FlowForces NOT registered; computed in-trace)
    flow_sim2, rod2, collection2, interactor2 = _rod_case()
    collection2.finalize()
    step = build_rod_fsi_step(
        flow_sim2,
        interactor2,
        collection2,
        rod_substeps=1,
        dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray(fsv, jnp.float64),
    )
    carry, _ = scan_steps(
        step, init_rod_fsi_carry(flow_sim2, interactor2, rod2), n_steps
    )
    np.testing.assert_allclose(
        np.asarray(carry.flow_state.primary_scalar_field), host_vort,
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(carry.rod_state.position[:, -1]), host_tip, atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(carry.vb_state.position_mismatch), host_mismatch,
        atol=1e-13,
    )


def test_rod_fsi_scan_runs_and_is_finite():
    """Fused rod FSI (flow + IBM + position-Verlet substeps in one scan)
    stays finite and deflects the rod."""
    real_t = jnp.float64
    flow_sim = UnboundedFlowSimulator2D(
        grid_size=(32, 32),
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
    )
    flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
    rod = CosseratRod.straight_rod(
        8,
        np.array([0.5, 0.3, 0.0]),
        np.array([0.0, 1.0, 0.0]),
        np.array([0.0, 0.0, 1.0]),
        base_length=0.4,
        base_radius=0.02,
        density=1e3,
        youngs_modulus=1e5,
        shear_modulus=1e5 / 1.5,
    )
    collection = BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    collection.dampen(rod).using(
        AnalyticalLinearDamper, damping_constant=1e-2, time_step=1e-3
    )
    collection.finalize()
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=CosseratRodElementCentricForcingGrid,
    )
    step = build_rod_fsi_step(
        flow_sim,
        interactor,
        collection,
        rod_substeps=4,
        dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray([1.0, 0.0], jnp.float64),
    )
    carry, lag_forces = scan_steps(
        step, init_rod_fsi_carry(flow_sim, interactor, rod), 5
    )
    tip0 = np.asarray(rod.position_collection[:, -1])
    tip1 = np.asarray(carry.rod_state.position[:, -1])
    assert np.isfinite(np.asarray(carry.flow_state.primary_scalar_field)).all()
    assert np.isfinite(tip1).all()
    assert not np.allclose(tip0, tip1)  # flow pushed the rod
    assert float(carry.time) > 0


def test_rigid_fsi_scan_sharded_matches_single():
    """The full fused FSI step over a (4,2) pencil mesh equals the
    single-device result (the multi-chip production path: sharded fields,
    distributed FFT with all_to_all transposes, SPMD stencils)."""
    import numpy as np
    from sopht_mpi_tpu.models import (
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )
    from sopht_mpi_tpu.parallel import create_mesh

    def build(mesh):
        flow_sim = UnboundedFlowSimulator3D(
            grid_size=(16, 16, 16),
            x_range=1.0,
            kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True,
            real_t=jnp.float64,
            mesh=mesh,
        )
        sphere = Sphere(
            center=np.array([0.5, 0.5, 0.5]), radius=0.15, dtype=jnp.float64
        )
        grid = SphereForcingGrid(
            rigid_body=sphere, num_forcing_points_along_equator=8
        )
        interactor = RigidBodyFlowInteraction(
            flow_sim=flow_sim,
            rigid_body=sphere,
            forcing_grid=grid,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
        )
        # seeded vorticity so the Poisson/stencil paths carry real data
        key = jax.random.PRNGKey(7)
        flow_sim.primary_field = flow_sim.primary_field + 0.1 * jax.random.normal(
            key, flow_sim.primary_field.shape, jnp.float64
        )
        step = build_rigid_fsi_step(
            flow_sim,
            interactor,
            dt_prefac=0.5,
            free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], jnp.float64),
        )
        carry, _ = scan_steps(
            step, init_rigid_fsi_carry(flow_sim, interactor, step), 3
        )
        return np.asarray(carry.flow_state.primary_field)

    single = build(None)
    sharded = build(create_mesh(3, (4, 2)))
    np.testing.assert_allclose(sharded, single, atol=1e-10)


def test_rod_fsi_scan_dynamic_substeps_match_host_loop():
    """Dynamic substep mode (rod_dt + max_rod_substeps) reproduces the
    reference's per-step count ``int(flow_dt / min(flow_dt, rod_dt))``
    (flow_past_rod.py:278-279) bit-for-bit against the host loop."""
    from sopht_mpi_tpu.models import FlowForces

    n_steps = 3
    fsv = (1.0, 0.0)
    rod_dt = 2e-4  # ~flow_dt / 2-4 for this case -> n_sub varies per step

    flow_sim, rod, collection, interactor = _rod_case()
    collection.add_forcing_to(rod).using(FlowForces, interactor)
    collection.finalize()
    ts = PositionVerlet()
    do_step, stages = extend_stepper_interface(ts, collection)
    rod_time = 0.0
    host_counts = []
    for _ in range(n_steps):
        flow_dt = float(flow_sim.compute_stable_timestep(dt_prefac=0.5))
        n_sub = int(flow_dt / min(flow_dt, rod_dt))
        host_counts.append(n_sub)
        local_rod_dt = flow_dt / n_sub
        for _ in range(n_sub):
            rod_time = do_step(ts, stages, collection, rod_time, local_rod_dt)
            interactor.time_step(dt=local_rod_dt)
        interactor()
        flow_sim.time_step(flow_dt, free_stream_velocity=fsv)
    assert max(host_counts) > 1  # the case must actually substep
    host_vort = np.asarray(flow_sim.vorticity_field)
    host_tip = np.asarray(rod.position_collection[:, -1])
    host_mismatch = np.asarray(interactor.state.position_mismatch)

    flow_sim2, rod2, collection2, interactor2 = _rod_case()
    collection2.finalize()
    step = build_rod_fsi_step(
        flow_sim2,
        interactor2,
        collection2,
        dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray(fsv, jnp.float64),
        rod_dt=rod_dt,
        max_rod_substeps=max(host_counts) + 2,
    )
    carry, _ = scan_steps(
        step, init_rod_fsi_carry(flow_sim2, interactor2, rod2), n_steps
    )
    np.testing.assert_allclose(
        np.asarray(carry.flow_state.primary_scalar_field), host_vort,
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(carry.rod_state.position[:, -1]), host_tip, atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(carry.vb_state.position_mismatch), host_mismatch,
        atol=1e-13,
    )


def test_scan_steps_donate_matches():
    """donate=True (buffer-reusing) scan gives identical results."""
    flow_sim, interactor = _cylinder_case()
    step = build_rigid_fsi_step(flow_sim, interactor, dt_prefac=0.5)
    c0 = init_rigid_fsi_carry(flow_sim, interactor, step)
    ref, _ = scan_steps(step, c0, 3)

    flow_sim2, interactor2 = _cylinder_case()
    step2 = build_rigid_fsi_step(flow_sim2, interactor2, dt_prefac=0.5)
    c1 = init_rigid_fsi_carry(flow_sim2, interactor2, step2)
    out, _ = scan_steps(step2, c1, 3, donate=True)
    np.testing.assert_array_equal(
        np.asarray(out.flow_state.primary_scalar_field),
        np.asarray(ref.flow_state.primary_scalar_field),
    )


def test_rod_fsi_step_conflicting_substep_args_raise():
    flow_sim, rod, collection, interactor = _rod_case()
    collection.finalize()
    import pytest as _pytest
    with _pytest.raises(ValueError, match="conflicts"):
        build_rod_fsi_step(
            flow_sim, interactor, collection,
            rod_substeps=2, rod_dt=1e-4, max_rod_substeps=4,
        )


def test_fsi_scan_is_reverse_differentiable():
    """jax.grad flows through the WHOLE coupled FSI scan (CFL dt control +
    IBM penalty interaction + NS flow step) on the XLA path - a capability
    the MPI reference cannot offer."""
    flow_sim, interactor = _cylinder_case()
    step = build_rigid_fsi_step(flow_sim, interactor, dt_prefac=0.5)
    carry = init_rigid_fsi_carry(flow_sim, interactor, step)
    rng = np.random.default_rng(0)
    om0 = carry.flow_state.primary_scalar_field + 0.1 * jnp.asarray(
        rng.standard_normal(carry.flow_state.primary_scalar_field.shape)
    )

    def loss(omega0):
        c = carry._replace(
            flow_state=carry.flow_state._replace(primary_scalar_field=omega0)
        )
        c2, _ = scan_steps(step, c, 2)
        return jnp.sum(c2.flow_state.velocity_field ** 2)

    g = jax.grad(loss)(om0)
    assert bool(jnp.isfinite(g).all())
    assert float(jnp.linalg.norm(g)) > 0.0


def test_rigid_fsi_sparse_forcing_matches_dense():
    """The static sparse-window forcing path (spread + curl on the support
    window, no-forcing flow step) equals the dense full-field path: the
    forcing curl is zero outside the window by construction, so the two
    differ only by adding exact 0.0 there."""
    from sopht_mpi_tpu.models import (
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )

    def build(sparse):
        flow_sim = UnboundedFlowSimulator3D(
            grid_size=(32, 32, 32),
            x_range=1.0,
            kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True,
            real_t=jnp.float64,
        )
        sphere = Sphere(
            center=np.array([0.5, 0.5, 0.5]), radius=0.12, dtype=jnp.float64
        )
        grid = SphereForcingGrid(
            rigid_body=sphere, num_forcing_points_along_equator=10
        )
        interactor = RigidBodyFlowInteraction(
            flow_sim=flow_sim,
            rigid_body=sphere,
            forcing_grid=grid,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
        )
        key = jax.random.PRNGKey(5)
        flow_sim.primary_field = flow_sim.primary_field + 0.1 * jax.random.normal(
            key, flow_sim.primary_field.shape, jnp.float64
        )
        step = build_rigid_fsi_step(
            flow_sim,
            interactor,
            dt_prefac=0.5,
            free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], jnp.float64),
            sparse_forcing=sparse,
        )
        carry, forces = scan_steps(
            step, init_rigid_fsi_carry(flow_sim, interactor, step), 3
        )
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.vb_state.position_mismatch),
            np.asarray(forces),
        )

    w_d, m_d, f_d = build(False)
    w_s, m_s, f_s = build(True)
    np.testing.assert_allclose(w_s, w_d, atol=1e-14)
    np.testing.assert_allclose(m_s, m_d, atol=1e-14)
    np.testing.assert_allclose(f_s, f_d, atol=1e-12)


def test_rigid_fsi_sparse_forcing_matches_dense_sharded():
    """Round 4: the static sparse-window forcing path engages under a
    mesh too (window work replicated, one windowed vorticity add into the
    sharded field) and equals the dense full-field path on the same
    mesh."""
    from sopht_mpi_tpu.models import (
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )
    from sopht_mpi_tpu.parallel import create_mesh

    def build(sparse):
        mesh = create_mesh(3, (4, 2))
        flow_sim = UnboundedFlowSimulator3D(
            grid_size=(32, 32, 32),
            x_range=1.0,
            kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True,
            real_t=jnp.float64,
            mesh=mesh,
        )
        sphere = Sphere(
            center=np.array([0.5, 0.5, 0.5]), radius=0.12, dtype=jnp.float64
        )
        grid = SphereForcingGrid(
            rigid_body=sphere, num_forcing_points_along_equator=10
        )
        interactor = RigidBodyFlowInteraction(
            flow_sim=flow_sim,
            rigid_body=sphere,
            forcing_grid=grid,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
        )
        key = jax.random.PRNGKey(5)
        flow_sim.primary_field = flow_sim.primary_field + 0.1 * jax.random.normal(
            key, flow_sim.primary_field.shape, jnp.float64
        )
        step = build_rigid_fsi_step(
            flow_sim,
            interactor,
            dt_prefac=0.5,
            free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], jnp.float64),
            sparse_forcing=sparse,
        )
        assert getattr(step, "uses_sparse_forcing", False) == sparse
        carry, forces = scan_steps(
            step, init_rigid_fsi_carry(flow_sim, interactor, step), 3
        )
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.vb_state.position_mismatch),
            np.asarray(forces),
        )

    w_d, m_d, f_d = build(False)
    w_s, m_s, f_s = build(True)
    np.testing.assert_allclose(w_s, w_d, atol=1e-13)
    np.testing.assert_allclose(m_s, m_d, atol=1e-13)
    np.testing.assert_allclose(f_s, f_d, atol=1e-12)


def test_sparse_forcing_carry_drops_forcing_field():
    """init_rigid_fsi_carry(step=sparse) shrinks the never-read full-field
    forcing leaf to a zero-size placeholder, and the scan still runs."""
    from sopht_mpi_tpu.models import (
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )

    flow_sim = UnboundedFlowSimulator3D(
        grid_size=(32, 32, 32),
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=jnp.float64,
    )
    sphere = Sphere(
        center=np.array([0.5, 0.5, 0.5]), radius=0.12, dtype=jnp.float64
    )
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=SphereForcingGrid(
            rigid_body=sphere, num_forcing_points_along_equator=10
        ),
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
    )
    flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
    step = build_rigid_fsi_step(flow_sim, interactor, sparse_forcing=True)
    carry = init_rigid_fsi_carry(flow_sim, interactor, step)
    assert carry.flow_state.eul_grid_forcing_field.size == 0
    carry, forces = scan_steps(step, carry, 2)
    assert bool(jnp.isfinite(carry.flow_state.primary_field).all())
    assert np.abs(np.asarray(forces)).max() > 0


def test_rod_fsi_sparse_window_matches_dense():
    """The moving-window sparse forcing path for rods (opt-in
    sparse_forcing_window) equals the dense full-field path, and the
    carried window_ok diagnostic stays True when the window covers the
    support."""
    from sopht_mpi_tpu.models import (
        CosseratRodSurfaceForcingGrid,
        UnboundedFlowSimulator3D,
        suggest_rod_forcing_window,
    )
    from sopht_mpi_tpu.models.elastica import CosseratRod as _Rod

    def build(window):
        flow_sim = UnboundedFlowSimulator3D(
            grid_size=(24, 24, 32),
            x_range=1.0,
            kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True,
            real_t=jnp.float64,
        )
        flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
        rod = CosseratRod.straight_rod(
            6,
            np.array([0.5, 0.4, 0.4]),
            np.array([0.0, 1.0, 0.0]),
            np.array([0.0, 0.0, 1.0]),
            base_length=0.3,
            base_radius=0.02,
            density=1e3,
            youngs_modulus=1e5,
            shear_modulus=1e5 / 1.5,
        )
        collection = BaseSystemCollection()
        collection.append(rod)
        collection.constrain(rod).using(
            OneEndFixedBC,
            constrained_position_idx=(0,),
            constrained_director_idx=(0,),
        )
        collection.finalize()
        interactor = CosseratRodFlowInteraction(
            flow_sim=flow_sim,
            cosserat_rod=rod,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
            forcing_grid_cls=CosseratRodSurfaceForcingGrid,
            surface_grid_density_for_largest_element=4,
        )
        win = (
            suggest_rod_forcing_window(interactor, rod, flow_sim.grid_size)
            if window
            else None
        )
        step = build_rod_fsi_step(
            flow_sim,
            interactor,
            collection,
            rod_substeps=1,
            dt_prefac=0.5,
            free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], jnp.float64),
            sparse_forcing_window=win,
        )
        carry, diag = scan_steps(
            step, init_rod_fsi_carry(flow_sim, interactor, rod), 3
        )
        if window:
            forces, ok = diag
            assert bool(jnp.all(ok))
        else:
            forces = diag
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.rod_state.position),
            np.asarray(forces),
        )

    w_d, p_d, f_d = build(False)
    w_s, p_s, f_s = build(True)
    np.testing.assert_allclose(w_s, w_d, atol=1e-14)
    np.testing.assert_allclose(p_s, p_d, atol=1e-14)
    np.testing.assert_allclose(f_s, f_d, atol=1e-12)


# -- multi-body fused FSI (BASELINE config 5: mixed soft/rigid) -------------


def test_multi_body_single_fixed_matches_rigid_builder():
    """A multi-body step with ONE FixedRigidBody reproduces
    build_rigid_fsi_step bit-for-bit (same ordering: mismatch integrate
    with previous interaction, interact, flow step)."""
    from sopht_mpi_tpu.models import (
        FixedRigidBody,
        build_multi_body_fsi_step,
        init_multi_body_fsi_carry,
    )

    n_steps = 4
    fsv = (1.0, 0.0)

    flow_sim, interactor = _cylinder_case()
    flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
    step = build_rigid_fsi_step(
        flow_sim, interactor, dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray(fsv, jnp.float64),
        sparse_forcing=False,
    )
    ref_carry, ref_forces = scan_steps(
        step, init_rigid_fsi_carry(flow_sim, interactor, step), n_steps
    )

    flow_sim2, interactor2 = _cylinder_case()
    flow_sim2.velocity_field = jnp.ones_like(flow_sim2.velocity_field)
    bodies = (FixedRigidBody(interactor2),)
    mstep = build_multi_body_fsi_step(
        flow_sim2, bodies, dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray(fsv, jnp.float64),
    )
    carry, forces = scan_steps(
        mstep, init_multi_body_fsi_carry(flow_sim2, bodies), n_steps
    )
    np.testing.assert_array_equal(
        np.asarray(carry.flow_state.primary_scalar_field),
        np.asarray(ref_carry.flow_state.primary_scalar_field),
    )
    np.testing.assert_array_equal(
        np.asarray(carry.vb_states[0].position_mismatch),
        np.asarray(ref_carry.vb_state.position_mismatch),
    )
    np.testing.assert_array_equal(
        np.asarray(forces[0]), np.asarray(ref_forces)
    )


def test_multi_body_rod_plus_cylinder_matches_host_loop():
    """Mixed bodies: a 2D rod + a fixed cylinder stepping together. The
    fused multi-body step must bit-match the host-driven composed loop
    (the reference's stacked-interactor driver pattern: each interactor
    accumulates onto the shared forcing field before the flow step)."""
    from sopht_mpi_tpu.models import (
        FixedRigidBody,
        FlowForces,
        RodBody,
        build_multi_body_fsi_step,
        init_multi_body_fsi_carry,
    )

    n_steps = 3
    fsv = (1.0, 0.0)

    def build_case():
        flow_sim = UnboundedFlowSimulator2D(
            grid_size=(32, 32), x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True, real_t=jnp.float64,
        )
        flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
        rod = CosseratRod.straight_rod(
            8, np.array([0.7, 0.3, 0.0]), np.array([0.0, 1.0, 0.0]),
            np.array([0.0, 0.0, 1.0]), base_length=0.4, base_radius=0.02,
            density=1e3, youngs_modulus=1e5, shear_modulus=1e5 / 1.5,
        )
        collection = BaseSystemCollection()
        collection.append(rod)
        collection.constrain(rod).using(
            OneEndFixedBC, constrained_position_idx=(0,),
            constrained_director_idx=(0,),
        )
        rod_interactor = CosseratRodFlowInteraction(
            flow_sim=flow_sim, cosserat_rod=rod,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
            forcing_grid_cls=CosseratRodElementCentricForcingGrid,
        )
        cyl = Cylinder(center=(0.3, 0.5), radius=0.08, dtype=jnp.float64)
        cyl_grid = CircularCylinderForcingGrid(
            rigid_body=cyl, num_forcing_points=16
        )
        cyl_interactor = RigidBodyFlowInteraction(
            flow_sim=flow_sim, rigid_body=cyl, forcing_grid=cyl_grid,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
        )
        return flow_sim, rod, collection, rod_interactor, cyl_interactor

    # host loop: rod substeps (FlowForces), rod spread, cylinder
    # time_step + spread, flow step
    flow_sim, rod, collection, rod_i, cyl_i = build_case()
    collection.add_forcing_to(rod).using(FlowForces, rod_i)
    collection.finalize()
    ts = PositionVerlet()
    do_step, stages = extend_stepper_interface(ts, collection)
    rod_time = 0.0
    for _ in range(n_steps):
        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)
        rod_time = do_step(ts, stages, collection, rod_time, flow_dt)
        rod_i.time_step(dt=flow_dt)
        rod_i()
        cyl_i.time_step(dt=flow_dt)
        cyl_i()
        flow_sim.time_step(flow_dt, free_stream_velocity=fsv)
    host_vort = np.asarray(flow_sim.vorticity_field)
    host_tip = np.asarray(rod.position_collection[:, -1])
    host_rod_mis = np.asarray(rod_i.state.position_mismatch)
    host_cyl_mis = np.asarray(cyl_i.state.position_mismatch)

    # fused multi-body scan
    flow_sim2, rod2, collection2, rod_i2, cyl_i2 = build_case()
    collection2.finalize()
    bodies = (RodBody(rod_i2, collection2), FixedRigidBody(cyl_i2))
    mstep = build_multi_body_fsi_step(
        flow_sim2, bodies, dt_prefac=0.5, substeps=1,
        free_stream_fn=lambda t: jnp.asarray(fsv, jnp.float64),
    )
    carry, forces = scan_steps(
        mstep, init_multi_body_fsi_carry(flow_sim2, bodies), n_steps
    )
    np.testing.assert_allclose(
        np.asarray(carry.flow_state.primary_scalar_field), host_vort,
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(carry.body_states[0].position[:, -1]), host_tip,
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(carry.vb_states[0].position_mismatch), host_rod_mis,
        atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(carry.vb_states[1].position_mismatch), host_cyl_mis,
        atol=1e-13,
    )
    assert np.abs(np.asarray(forces[0])).max() > 0
    assert np.abs(np.asarray(forces[1])).max() > 0


def test_multi_body_dynamic_rigid_two_way_coupling():
    """A dense rigid cylinder released in a uniform stream: the flow
    penalty loads accelerate it downstream (two-way coupling through the
    position-Verlet rigid stepper); everything stays finite."""
    from sopht_mpi_tpu.models import (
        DynamicRigidBody,
        build_multi_body_fsi_step,
        init_multi_body_fsi_carry,
    )

    flow_sim = UnboundedFlowSimulator2D(
        grid_size=(32, 32), x_range=1.0, kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True, real_t=jnp.float64,
    )
    flow_sim.velocity_field = jnp.ones_like(flow_sim.velocity_field)
    cyl = Cylinder(
        center=(0.4, 0.5), radius=0.08, dtype=jnp.float64, density=2.0
    )
    grid = CircularCylinderForcingGrid(rigid_body=cyl, num_forcing_points=16)
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim, rigid_body=cyl, forcing_grid=grid,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
    )
    bodies = (DynamicRigidBody(interactor, cyl),)
    mstep = build_multi_body_fsi_step(
        flow_sim, bodies, dt_prefac=0.5, substeps=2,
        free_stream_fn=lambda t: jnp.asarray((1.0, 0.0), jnp.float64),
    )
    carry, _ = scan_steps(
        mstep, init_multi_body_fsi_carry(flow_sim, bodies), 8
    )
    state = carry.body_states[0]
    assert np.isfinite(np.asarray(state.position)).all()
    assert np.isfinite(
        np.asarray(carry.flow_state.primary_scalar_field)
    ).all()
    # the x-stream drags the body downstream
    assert float(state.velocity[0]) > 0
    assert float(state.position[0]) > 0.4


def test_fsi_scan_gradient_assimilates_initial_condition():
    """The gradients are USABLE, not just finite: descent on a scalar
    initial-vorticity amplitude recovers the truth from the final flow
    state alone - data assimilation through the full coupled FSI rollout
    (CFL dt control, IBM penalty interaction, NS step). The observation
    is the final FIELD: a force-trace misfit has fine wiggles from the
    amplitude->dt-control coupling (AD verified equal to finite
    differences there; the wiggles are real physics of the adaptive-dt
    observation operator, not a VJP bug)."""
    flow_sim, interactor = _cylinder_case()
    step = build_rigid_fsi_step(flow_sim, interactor, dt_prefac=0.5)
    carry = init_rigid_fsi_carry(flow_sim, interactor, step)
    rng = np.random.default_rng(3)
    base_omega = jnp.asarray(
        rng.standard_normal(carry.flow_state.primary_scalar_field.shape)
    )
    base_u = carry.flow_state.velocity_field + 1.0

    def final_field(amplitude):
        c = carry._replace(
            flow_state=carry.flow_state._replace(
                primary_scalar_field=amplitude * base_omega,
                velocity_field=base_u,
            )
        )
        c2, _ = scan_steps(step, c, 4)
        return c2.flow_state.primary_scalar_field

    a_true = 0.8
    obs = final_field(a_true)
    loss = jax.jit(
        jax.value_and_grad(
            lambda a: jnp.mean((final_field(a) - obs) ** 2)
        )
    )
    # sign descent with geometric step decay: monotone bracketing of the
    # scalar optimum, insensitive to the loss scale
    a, lr = jnp.asarray(1.6), 0.4  # 2x off
    for _ in range(25):
        _, g = loss(a)
        a = a - lr * jnp.sign(g)
        lr = max(lr * 0.7, 1e-3)
    assert abs(float(a) - a_true) < 5e-3, float(a)


# -- round 5: sparse-window IBM under a mesh (rod + multi-body) --------------


def _rod_3d_case(mesh, sparse, real_t=jnp.float64, **step_kwargs):
    """Small 3D rod FSI case; returns (step, carry, sparse_engaged)."""
    from sopht_mpi_tpu.models import (
        CosseratRodSurfaceForcingGrid,
        UnboundedFlowSimulator3D,
        suggest_rod_forcing_window,
    )

    flow_sim = UnboundedFlowSimulator3D(
        grid_size=(32, 32, 32),
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        mesh=mesh,
    )
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    rod = CosseratRod.straight_rod(
        6,
        np.array([0.5, 0.4, 0.5]),
        np.array([0.0, 1.0, 0.0]),
        np.array([0.0, 0.0, 1.0]),
        base_length=0.25,
        base_radius=0.02,
        density=1e3,
        youngs_modulus=1e5,
        shear_modulus=1e5 / 1.5,
    )
    collection = BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    collection.finalize()
    interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=4,
    )
    win = (
        suggest_rod_forcing_window(interactor, rod, flow_sim.grid_size)
        if sparse
        else None
    )
    if sparse:
        assert win is not None
    step_kwargs.setdefault("rod_substeps", 1)
    step = build_rod_fsi_step(
        flow_sim,
        interactor,
        collection,
        dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], real_t),
        sparse_forcing_window=win,
        **step_kwargs,
    )
    return step, init_rod_fsi_carry(flow_sim, interactor, rod)


def test_rod_fsi_sparse_window_matches_dense_sharded():
    """Round 5: the rod's MOVING sparse forcing window engages under a
    mesh (the round-4 gate at fsi.py:508 is lifted): window work runs
    replicated, the velocity-window gather and the windowed vorticity add
    go through parallel.windows - and equals the dense path on the SAME
    mesh AND the meshless sparse path (reference posture: O(markers)
    Lagrangian work at any rank count,
    VirtualBoundaryForcingMPI.py:333-429)."""
    from sopht_mpi_tpu.parallel import create_mesh

    def run(mesh, sparse):
        step, carry = _rod_3d_case(mesh, sparse)
        carry, diag = scan_steps(step, carry, 3)
        if sparse:
            _, ok = diag
            assert bool(jnp.all(ok))
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.rod_state.position[:, -1]),
        )

    w_ml, tip_ml = run(None, True)
    for mesh_shape in [(4, 2), (8, 1)]:
        mesh = create_mesh(3, mesh_shape)
        w_sp, tip_sp = run(mesh, True)
        w_dn, tip_dn = run(mesh, False)
        np.testing.assert_allclose(w_sp, w_dn, atol=1e-13, err_msg=str(mesh_shape))
        np.testing.assert_allclose(tip_sp, tip_dn, atol=1e-14)
        np.testing.assert_allclose(w_sp, w_ml, atol=1e-13)
        np.testing.assert_allclose(tip_sp, tip_ml, atol=1e-14)


def _multibody_3d_case(mesh, sparse, real_t=jnp.float64, **step_kwargs):
    from sopht_mpi_tpu.models import (
        CosseratRodSurfaceForcingGrid,
        FixedRigidBody,
        RodBody,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
        build_multi_body_fsi_step,
        init_multi_body_fsi_carry,
    )

    flow_sim = UnboundedFlowSimulator3D(
        grid_size=(32, 32, 32),
        x_range=1.0,
        kinematic_viscosity=1e-3,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        mesh=mesh,
    )
    flow_sim.velocity_field = flow_sim.velocity_field + 1.0
    rod = CosseratRod.straight_rod(
        5,
        np.array([0.3, 0.4, 0.6]),
        np.array([0.0, 0.0, -1.0]),
        np.array([0.0, 1.0, 0.0]),
        base_length=0.25,
        base_radius=0.02,
        density=1e3,
        youngs_modulus=1e5,
        shear_modulus=1e5 / 1.5,
    )
    collection = BaseSystemCollection()
    collection.append(rod)
    collection.constrain(rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    collection.finalize()
    rod_interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=rod,
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=4,
    )
    sphere = Sphere(
        center=np.array([0.7, 0.5, 0.5]), radius=0.1, dtype=real_t
    )
    sph_interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=SphereForcingGrid(
            rigid_body=sphere, num_forcing_points_along_equator=12
        ),
        virtual_boundary_stiffness_coeff=-1e3,
        virtual_boundary_damping_coeff=-1e0,
    )
    bodies = (RodBody(rod_interactor, collection), FixedRigidBody(sph_interactor))
    step_kwargs.setdefault("substeps", 1)
    step = build_multi_body_fsi_step(
        flow_sim,
        bodies,
        dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], real_t),
        sparse_forcing=sparse,
        **step_kwargs,
    )
    assert getattr(step, "uses_sparse_forcing") == (sparse is not False)
    return step, init_multi_body_fsi_carry(flow_sim, bodies, step)


@pytest.mark.parametrize("mesh_shape", [None, (4, 2)])
def test_multi_body_sparse_forcing_matches_dense(mesh_shape):
    """Round 5: per-BODY sparse forcing windows in the multi-body step
    (rod window + rigid window, overlapping windowed curls composing by
    linearity) equal the dense shared-forcing-field path - meshless and
    on a pencil mesh (builder PLAN round-5 #3 / VERDICT r04 next #2)."""
    from sopht_mpi_tpu.parallel import create_mesh

    mesh = None if mesh_shape is None else create_mesh(3, mesh_shape)

    def run(sparse):
        step, carry = _multibody_3d_case(mesh, sparse)
        carry, diag = scan_steps(step, carry, 3)
        if sparse is not False:
            sums, ok = diag
            assert bool(jnp.all(ok))
        else:
            sums = diag
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.body_states[0].position[:, -1]),
            np.asarray(sums[1]),
        )

    w_d, tip_d, f_d = run(False)
    w_s, tip_s, f_s = run(None)  # None = auto, must engage on this case
    np.testing.assert_allclose(w_s, w_d, atol=1e-13)
    np.testing.assert_allclose(tip_s, tip_d, atol=1e-14)
    np.testing.assert_allclose(f_s, f_d, atol=1e-12)


def test_multi_body_sparse_carry_drops_forcing_field():
    """init_multi_body_fsi_carry(step=sparse) shrinks the never-read
    full-field forcing leaf to a zero-size placeholder; the scan runs."""
    step, carry = _multibody_3d_case(None, None)
    assert carry.flow_state.eul_grid_forcing_field.size == 0
    carry, (sums, ok) = scan_steps(step, carry, 2)
    assert bool(jnp.all(ok))
    assert bool(jnp.isfinite(carry.flow_state.primary_field).all())
    assert np.abs(np.asarray(sums[1])).max() > 0


def test_rod_substep_load_refresh_modes():
    """Round 5: substep_load_refresh='flow_step' (opt-in approximation -
    frozen loads through the substeps, an O(flow_dt) forcing lag; NOT the
    reference's per-substep-refresh semantics, which stays the default)
    runs finite, needs the step-aware carry, stays sparse==dense at
    machine epsilon, and genuinely differs from 'every'."""
    def run(mode, sparse):
        from sopht_mpi_tpu.models import suggest_rod_forcing_window

        # reuse the 3D rod case builder but override the refresh mode
        from sopht_mpi_tpu.models import (
            CosseratRodSurfaceForcingGrid,
            UnboundedFlowSimulator3D,
        )

        flow_sim = UnboundedFlowSimulator3D(
            grid_size=(32, 32, 32), x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True, real_t=jnp.float64,
        )
        flow_sim.velocity_field = flow_sim.velocity_field + 1.0
        rod = CosseratRod.straight_rod(
            6, np.array([0.5, 0.4, 0.5]), np.array([0.0, 1.0, 0.0]),
            np.array([0.0, 0.0, 1.0]), base_length=0.25, base_radius=0.02,
            density=1e3, youngs_modulus=1e5, shear_modulus=1e5 / 1.5,
        )
        col = BaseSystemCollection()
        col.append(rod)
        col.constrain(rod).using(
            OneEndFixedBC, constrained_position_idx=(0,),
            constrained_director_idx=(0,),
        )
        col.finalize()
        inter = CosseratRodFlowInteraction(
            flow_sim=flow_sim, cosserat_rod=rod,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
            forcing_grid_cls=CosseratRodSurfaceForcingGrid,
            surface_grid_density_for_largest_element=4,
        )
        win = (
            suggest_rod_forcing_window(inter, rod, flow_sim.grid_size)
            if sparse else None
        )
        step = build_rod_fsi_step(
            flow_sim, inter, col, rod_substeps=2, dt_prefac=0.5,
            free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], jnp.float64),
            sparse_forcing_window=win, substep_load_refresh=mode,
        )
        if mode == "flow_step":
            # the frozen carry leaves are required - loud error without
            with pytest.raises(ValueError, match="frozen-loads"):
                scan_steps(
                    step, init_rod_fsi_carry(flow_sim, inter, rod), 1
                )
        carry = init_rod_fsi_carry(flow_sim, inter, rod, step)
        carry, diag = scan_steps(step, carry, 4)
        if sparse:
            assert bool(jnp.all(diag[1]))
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.rod_state.position[:, -1]),
        )

    w_e, tip_e = run("every", False)
    w_fd, tip_fd = run("flow_step", False)
    w_fs, tip_fs = run("flow_step", True)
    assert np.isfinite(w_fd).all() and np.isfinite(w_fs).all()
    # frozen sparse == frozen dense (machine epsilon, f64)
    np.testing.assert_allclose(w_fs, w_fd, atol=1e-13)
    np.testing.assert_allclose(tip_fs, tip_fd, atol=1e-14)
    # and it is a DIFFERENT scheme than the default
    assert np.abs(w_fd - w_e).max() > 0
    with pytest.raises(ValueError, match="substep_load_refresh"):
        run("sometimes", False)


def test_multi_body_substep_load_refresh_modes():
    """Round 5: the multi-body builder's substep_load_refresh='flow_step'
    (opt-in frozen-loads approximation, mirroring the rod builder's)
    runs finite, needs the step-aware carry, keeps sparse == dense at
    machine epsilon, and genuinely differs from the default."""
    from sopht_mpi_tpu.models import (
        CosseratRodSurfaceForcingGrid,
        FixedRigidBody,
        RodBody,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
        build_multi_body_fsi_step,
        init_multi_body_fsi_carry,
    )

    def case(mode, sparse):
        real_t = jnp.float64
        flow_sim = UnboundedFlowSimulator3D(
            grid_size=(32, 32, 32), x_range=1.0, kinematic_viscosity=1e-3,
            flow_type="navier_stokes_with_forcing",
            with_free_stream_flow=True, real_t=real_t,
        )
        flow_sim.velocity_field = flow_sim.velocity_field + 1.0
        rod = CosseratRod.straight_rod(
            5, np.array([0.3, 0.4, 0.6]), np.array([0.0, 0.0, -1.0]),
            np.array([0.0, 1.0, 0.0]), base_length=0.25, base_radius=0.02,
            density=1e3, youngs_modulus=1e5, shear_modulus=1e5 / 1.5,
        )
        col = BaseSystemCollection()
        col.append(rod)
        col.constrain(rod).using(
            OneEndFixedBC, constrained_position_idx=(0,),
            constrained_director_idx=(0,),
        )
        col.finalize()
        rint = CosseratRodFlowInteraction(
            flow_sim=flow_sim, cosserat_rod=rod,
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
            forcing_grid_cls=CosseratRodSurfaceForcingGrid,
            surface_grid_density_for_largest_element=4,
        )
        sph = Sphere(
            center=np.array([0.7, 0.5, 0.5]), radius=0.1, dtype=real_t
        )
        sint = RigidBodyFlowInteraction(
            flow_sim=flow_sim, rigid_body=sph,
            forcing_grid=SphereForcingGrid(
                rigid_body=sph, num_forcing_points_along_equator=12
            ),
            virtual_boundary_stiffness_coeff=-1e3,
            virtual_boundary_damping_coeff=-1e0,
        )
        bodies = (RodBody(rint, col), FixedRigidBody(sint))
        step = build_multi_body_fsi_step(
            flow_sim, bodies, dt_prefac=0.5, substeps=2,
            free_stream_fn=lambda t: jnp.asarray([1.0, 0.0, 0.0], real_t),
            sparse_forcing=sparse, substep_load_refresh=mode,
        )
        if mode == "flow_step":
            with pytest.raises(ValueError, match="frozen-loads"):
                scan_steps(
                    step, init_multi_body_fsi_carry(flow_sim, bodies), 1
                )
        carry = init_multi_body_fsi_carry(flow_sim, bodies, step)
        carry, _ = scan_steps(step, carry, 3)
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.body_states[0].position[:, -1]),
        )

    w_e, _ = case("every", None)
    w_f, tip_f = case("flow_step", None)
    w_fd, tip_fd = case("flow_step", False)
    assert np.isfinite(w_f).all()
    np.testing.assert_allclose(w_f, w_fd, atol=1e-13)
    np.testing.assert_allclose(tip_f, tip_fd, atol=1e-14)
    assert np.abs(w_f - w_e).max() > 0


def test_substep_interp_gather_matches_window_mm():
    """Round 5: substep_interp='gather' (plain XLA support-gather of the
    frozen velocity field inside the substeps - the large-window fast
    path; fsi._GATHER_SUBSTEP_WINDOW_CELLS crossover) produces the same
    trajectory as 'window_mm' to f64 roundoff on both the sparse rod and
    sparse multi-body steps (the weights are identical; only the
    summation order differs), and the guards are loud: an unknown value
    raises, and 'gather' under a mesh raises (XLA would all-gather the
    sharded operand per substep)."""
    from sopht_mpi_tpu.parallel import create_mesh

    def run_rod(interp):
        step, carry = _rod_3d_case(
            None, True, rod_substeps=2, substep_interp=interp
        )
        carry, (forces, ok) = scan_steps(step, carry, 4)
        assert bool(jnp.all(ok))
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.rod_state.position[:, -1]),
            np.asarray(forces),
        )

    w_mm, tip_mm, f_mm = run_rod("window_mm")
    w_g, tip_g, f_g = run_rod("gather")
    assert np.abs(w_mm).max() > 0
    np.testing.assert_allclose(w_g, w_mm, atol=1e-13)
    np.testing.assert_allclose(tip_g, tip_mm, atol=1e-14)
    np.testing.assert_allclose(f_g, f_mm, atol=1e-12)

    def run_mb(interp):
        step, carry = _multibody_3d_case(
            None, True, substeps=2, substep_interp=interp
        )
        carry, (sums, ok) = scan_steps(step, carry, 3)
        assert bool(jnp.all(ok))
        return (
            np.asarray(carry.flow_state.primary_field),
            np.asarray(carry.body_states[0].position[:, -1]),
        )

    wb_mm, tipb_mm = run_mb("window_mm")
    wb_g, tipb_g = run_mb("gather")
    np.testing.assert_allclose(wb_g, wb_mm, atol=1e-13)
    np.testing.assert_allclose(tipb_g, tipb_mm, atol=1e-14)

    with pytest.raises(ValueError, match="substep_interp"):
        _rod_3d_case(None, True, substep_interp="sometimes")
    with pytest.raises(ValueError, match="substep_interp"):
        _multibody_3d_case(None, True, substep_interp="sometimes")
    mesh = create_mesh(3, (4, 2))
    with pytest.raises(ValueError, match="unsharded"):
        _rod_3d_case(mesh, True, substep_interp="gather")
    with pytest.raises(ValueError, match="unsharded"):
        _multibody_3d_case(mesh, True, substep_interp="gather")
