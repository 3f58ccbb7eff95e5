"""Flow past a fixed sphere at Re=100 (drag benchmark).

Counterpart of /root/reference/examples/3d_examples/FlowPastSphereCase/
flow_past_sphere_case.py (same physics: sphere diameter 0.4*min(z,y)-extent,
centered at (0.25, 0.5, 0.5) of the domain, unit free stream in x,
coupling stiffness -1.5e5 / damping -87.5, drag + divergence diagnostics).

Run:
    python examples/3d/flow_past_sphere.py --grid-size-x 128 --nondim-time 5
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def flow_past_sphere_case(
    nondim_time=10.0,
    grid_size=(128, 128, 128),
    reynolds=100.0,
    coupling_stiffness=-6e5 / 4,
    coupling_damping=-3.5e2 / 4,
    precision="single",
    mesh=None,
    save_flow_data=False,
):
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import (
        RigidBodyFlowInteraction,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
    )
    from sopht_mpi_tpu.utils import get_real_t, logger

    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    x_range = 1.0
    far_field_velocity = 1.0
    sphere_diameter = 0.4 * min(grid_size_z, grid_size_y) / grid_size_x * x_range
    nu = far_field_velocity * sphere_diameter / reynolds
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu,
        real_t=real_t,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        mesh=mesh,
    )
    rho_f = 1.0
    sphere_projected_area = 0.25 * np.pi * sphere_diameter**2
    drag_force_scale = 0.5 * rho_f * far_field_velocity**2 * sphere_projected_area
    velocity_free_stream = np.array([far_field_velocity, 0.0, 0.0])

    sphere_com = np.array(
        [0.25 * flow_sim.x_range, 0.5 * flow_sim.y_range, 0.5 * flow_sim.z_range]
    )
    sphere = Sphere(
        center=sphere_com, radius=sphere_diameter / 2.0, dtype=real_t
    )
    num_forcing_points_along_equator = int(
        1.875 * sphere_diameter / x_range * grid_size_x
    )
    forcing_grid = SphereForcingGrid(
        rigid_body=sphere,
        num_forcing_points_along_equator=num_forcing_points_along_equator,
    )
    sphere_flow_interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=forcing_grid,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )

    if save_flow_data:
        from sopht_mpi_tpu.utils import FieldBinding, FieldIO

        io = FieldIO(dim=3, real_dtype=real_t)
        io.define_eulerian_grid(
            origin=np.array(
                [
                    float(flow_sim.position_field[2].min()),
                    float(flow_sim.position_field[1].min()),
                    float(flow_sim.position_field[0].min()),
                ]
            ),
            dx=flow_sim.dx * np.ones(3),
            grid_size=np.asarray(grid_size),
        )
        io.add_as_eulerian_fields_for_io(
            vorticity=FieldBinding(flow_sim, "vorticity_field"),
            velocity=FieldBinding(flow_sim, "velocity_field"),
        )
        sphere_io = FieldIO(dim=3, real_dtype=real_t)
        sphere_io.add_as_lagrangian_fields_for_io(
            lagrangian_grid=forcing_grid.compute_lag_grid_position_field,
            lagrangian_grid_name="sphere",
        )

    timescale = sphere_diameter / far_field_velocity
    t_end = nondim_time * timescale
    foto_timer = 0.0
    foto_timer_limit = timescale / 10
    times, drag_coeffs = [], []

    while flow_sim.time < t_end:
        if foto_timer > foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            drag_force = float(
                np.fabs(
                    np.sum(
                        np.asarray(
                            sphere_flow_interactor.global_lag_grid_forcing_field[0]
                        )
                    )
                )
            )
            drag_coeff = drag_force / drag_force_scale
            times.append(flow_sim.time)
            drag_coeffs.append(drag_coeff)
            if save_flow_data:
                io.save(
                    h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
                sphere_io.save(
                    h5_file_name=f"sphere_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / t_end * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                f"drag coeff: {drag_coeff:.4f}, "
                f"vort divg. L2 norm: "
                f"{flow_sim.get_vorticity_divergence_l2_norm():.4f} "
                "grid deviation L2 error: "
                f"{sphere_flow_interactor.get_grid_deviation_error_l2_norm():.6f}"
            )

        dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)
        sphere_flow_interactor.time_step(dt=dt)
        sphere_flow_interactor()
        flow_sim.time_step(dt=dt, free_stream_velocity=velocity_free_stream)
        foto_timer += dt

    np.savetxt(
        "drag_vs_time.csv",
        np.c_[np.array(times), np.array(drag_coeffs)],
        delimiter=",",
        header="time, drag_coeff",
    )
    return np.array(times), np.array(drag_coeffs)


def flow_past_sphere_fused_case(
    nondim_time=10.0,
    grid_size=(128, 128, 128),
    reynolds=100.0,
    coupling_stiffness=-6e5 / 4,
    coupling_damping=-3.5e2 / 4,
    precision="single",
    window=100,
    save_interval=None,
    mesh=None,
    overlap_chunks=None,
):
    """Same physics, whole coupled loop as one on-device ``lax.scan``
    (models/fsi.py). Validated drag: Cd = 1.305 (64^3) / 1.224 (128^3) at
    Re=100 (doc/validation_sphere_re100_drag_128.csv).

    ``save_interval`` (in nondimensional time t*) snapshots the vorticity
    and velocity fields at scan-window boundaries through the native async
    dump writer - the analogue of the reference's in-loop MPIIO saves
    (flow_past_sphere_case.py:129-139) that never blocks the device queue."""
    import jax
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import (
        RigidBodyFlowInteraction,
        Sphere,
        SphereForcingGrid,
        UnboundedFlowSimulator3D,
        build_rigid_fsi_step,
        init_rigid_fsi_carry,
        scan_steps,
    )
    from sopht_mpi_tpu.utils import get_real_t, logger

    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    x_range = 1.0
    far_field_velocity = 1.0
    sphere_diameter = 0.4 * min(grid_size_z, grid_size_y) / grid_size_x * x_range
    nu = far_field_velocity * sphere_diameter / reynolds
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu,
        real_t=real_t,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        mesh=mesh,
        # comm/compute pipelining of the sharded Poisson transposes
        # (None = default; 1 = the unpipelined control arm)
        overlap_chunks=overlap_chunks,
    )
    sphere = Sphere(
        center=np.array(
            [0.25 * flow_sim.x_range, 0.5 * flow_sim.y_range,
             0.5 * flow_sim.z_range]
        ),
        radius=sphere_diameter / 2.0,
        dtype=real_t,
    )
    forcing_grid = SphereForcingGrid(
        rigid_body=sphere,
        num_forcing_points_along_equator=int(
            1.875 * sphere_diameter / x_range * grid_size_x
        ),
    )
    interactor = RigidBodyFlowInteraction(
        flow_sim=flow_sim,
        rigid_body=sphere,
        forcing_grid=forcing_grid,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )
    step = build_rigid_fsi_step(
        flow_sim,
        interactor,
        dt_prefac=0.5,
        free_stream_fn=lambda t: jnp.asarray(
            [far_field_velocity, 0.0, 0.0], real_t
        ),
    )
    carry = init_rigid_fsi_carry(flow_sim, interactor, step)
    drag_scale = (
        0.5 * far_field_velocity**2 * 0.25 * np.pi * sphere_diameter**2
    )
    timescale = sphere_diameter / far_field_velocity
    t_end = nondim_time * timescale
    snaps = None
    if save_interval is not None:
        from sopht_mpi_tpu.utils import SnapshotWriter

        snaps = SnapshotWriter(
            interval=save_interval * timescale, out_dir="snapshots"
        )
    times, drag_coeffs = [], []
    while float(carry.time) < t_end:
        carry, lag_forces = scan_steps(step, carry, window, donate=True)
        jax.block_until_ready(carry)
        cd = float(np.abs(np.asarray(lag_forces[-1, 0]))) / drag_scale
        times.append(float(carry.time) / timescale)
        drag_coeffs.append(cd)
        logger.info(f"t*={times[-1]:.2f} Cd={cd:.4f}")
        if snaps is not None:
            snaps.maybe_save(
                float(carry.time),
                vorticity=carry.flow_state.primary_field,
                velocity=carry.flow_state.velocity_field,
            )
        # write incrementally: long large-grid runs can be interrupted
        np.savetxt(
            "drag_vs_time.csv", np.c_[times, drag_coeffs], delimiter=","
        )
    if snaps is not None:
        snaps.flush()
        logger.info(
            f"wrote {snaps.n_saved} snapshots to snapshots/ "
            f"(native={snaps.is_native}, failed={snaps.failed()})"
        )
        snaps.close()
    return times, drag_coeffs


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--nondim-time", type=float, default=10.0)
    parser.add_argument("--grid-size-x", type=int, default=128)
    parser.add_argument("--n-devices", type=int, default=1)
    parser.add_argument("--precision", default="single")
    parser.add_argument("--save-flow-data", action="store_true")
    parser.add_argument(
        "--save-interval", type=float, default=None,
        help="snapshot vorticity+velocity every this many t* through the "
        "native async dump writer (fused loop)",
    )
    parser.add_argument(
        "--fused", action="store_true", default=True,
        help="run the whole coupled loop as one on-device lax.scan "
        "(the default; host loops are one dispatch per step)",
    )
    parser.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven eager loop (CPU debugging)",
    )
    args = parser.parse_args()

    from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()


    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu.parallel import create_mesh

        mesh = create_mesh(3, (args.n_devices, 1))
    n = args.grid_size_x
    if args.fused:
        flow_past_sphere_fused_case(
            nondim_time=args.nondim_time,
            grid_size=(n, n, n),
            precision=args.precision,
            save_interval=args.save_interval,
            mesh=mesh,
        )
        raise SystemExit(0)
    flow_past_sphere_case(
        nondim_time=args.nondim_time,
        grid_size=(n, n, n),
        precision=args.precision,
        mesh=mesh,
        save_flow_data=args.save_flow_data,
    )
