"""Flow past a freely-rotating rod, with full checkpoint/restart.

Counterpart of /root/reference/examples/3d_examples/
FlowPastFreelyRotatingRodCase/flow_past_freely_rotating_rod_case.py:
rod clamped in translation but free to rotate about its axis
(GeneralConstraint), strong convolution vorticity filtering
{"order": 5, "type": "convolution"}, and a complete FSI restart: flow
fields + rod dynamic state + IBM position-mismatch field, with a
time-consistency assert on load (reference :199-246).

Run:
    python examples/3d/flow_past_freely_rotating_rod.py --final-time 0.5
    python examples/3d/flow_past_freely_rotating_rod.py --final-time 1.0 --restart
"""

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def flow_past_freely_rotating_rod_case(
    n_elem=16,
    grid_size=(64, 64, 128),
    surface_grid_density_for_largest_element=12,
    cauchy_number=0.2,
    mass_ratio=10.0,
    aspect_ratio=10.0,
    base_length=1.0,
    poisson_ratio=0.5,
    reynolds=100.0,
    coupling_stiffness=-2e5,
    coupling_damping=-1e2,
    rod_start_incline_angle=np.pi / 2,
    precision="single",
    mesh=None,
    final_time=1.0,
    restart_dir="restart_data",
    save_interval=0.25,
    restart_simulation=False,
    fused=False,
    window=50,
    checkpoint_backend="h5",
):
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import (
        AnalyticalLinearDamper,
        BaseSystemCollection,
        CosseratRod,
        CosseratRodFlowInteraction,
        CosseratRodSurfaceForcingGrid,
        FlowForces,
        GeneralConstraint,
        PositionVerlet,
        UnboundedFlowSimulator3D,
        extend_stepper_interface,
    )
    from sopht_mpi_tpu.utils import (
        FieldBinding,
        FieldIO,
        get_real_t,
        load_rod_state,
        logger,
        save_rod_state,
    )

    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    rho_f = 1.0
    u_free_stream = 1.0
    x_range = 5.0 * base_length
    y_range = grid_size_y / grid_size_x * x_range
    z_range = grid_size_z / grid_size_x * x_range
    velocity_free_stream = [u_free_stream, 0.0, 0.0]

    # ---- rod: clamped translation, free axial rotation (reference :84-91) ----
    flow_past_sim = BaseSystemCollection()
    start = np.array([0.08 * x_range, 0.502 * y_range, 0.502 * z_range])
    direction = np.array(
        [np.sin(rod_start_incline_angle), 0.0, -np.cos(rod_start_incline_angle)]
    )
    normal = np.array([0.0, 1.0, 0.0])
    base_diameter = base_length / aspect_ratio
    base_radius = base_diameter / 2.0
    rho_s = mass_ratio * rho_f
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        rho_f * u_free_stream**2 * base_length**3 * base_diameter
    ) / (cauchy_number * moment_of_inertia)

    flow_past_rod = CosseratRod.straight_rod(
        n_elem,
        start,
        direction,
        normal,
        base_length,
        base_radius,
        rho_s,
        youngs_modulus=youngs_modulus,
        shear_modulus=youngs_modulus / (poisson_ratio + 1.0),
    )
    flow_past_sim.append(flow_past_rod)
    flow_past_sim.constrain(flow_past_rod).using(
        GeneralConstraint,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
        translational_constraint_selector=np.array([True, True, True]),
        rotational_constraint_selector=np.array([False, True, True]),
    )
    dl = base_length / n_elem
    rod_dt = 0.01 * dl
    flow_past_sim.dampen(flow_past_rod).using(
        AnalyticalLinearDamper, damping_constant=1e-3, time_step=rod_dt
    )

    # ---- flow (strong convolution filtering, reference :113-114) ----
    kinematic_viscosity = u_free_stream * base_diameter / reynolds
    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=kinematic_viscosity,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        mesh=mesh,
        filter_vorticity=True,
        filter_setting_dict={"order": 5, "type": "convolution"},
    )
    flow_sim.velocity_field = flow_sim.velocity_field + jnp.asarray(
        velocity_free_stream, real_t
    ).reshape(3, 1, 1, 1)

    cosserat_rod_flow_interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=flow_past_rod,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
        forcing_grid_cls=CosseratRodSurfaceForcingGrid,
        surface_grid_density_for_largest_element=(
            surface_grid_density_for_largest_element
        ),
    )
    if not fused:
        # the fused loop computes the flow forces in-trace instead
        flow_past_sim.add_forcing_to(flow_past_rod).using(
            FlowForces, cosserat_rod_flow_interactor
        )

    # ---- checkpoint IO: flow fields + IBM mismatch + rod state ----
    os.makedirs(restart_dir, exist_ok=True)
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
    forcing_grid_io = FieldIO(dim=3, real_dtype=real_t)
    forcing_grid_io.add_as_lagrangian_fields_for_io(
        lagrangian_grid=(
            cosserat_rod_flow_interactor.forcing_grid
        ).compute_lag_grid_position_field,
        lagrangian_grid_name="forcing_grid",
        position_mismatch=FieldBinding(
            cosserat_rod_flow_interactor, "position_mismatch"
        ),
    )

    def save_checkpoint(index):
        io.save(
            h5_file_name=f"{restart_dir}/flow_{index:05d}.h5",
            time=flow_sim.time,
        )
        forcing_grid_io.save(
            h5_file_name=f"{restart_dir}/forcing_grid_{index:05d}.h5",
            time=flow_sim.time,
        )
        save_rod_state(
            flow_past_rod, f"{restart_dir}/rod_{index:05d}.h5", time=flow_sim.time
        )

    def load_latest_checkpoint():
        flow_files = sorted(glob.glob(f"{restart_dir}/flow_*.h5"))
        assert flow_files, "no checkpoint found for restart"
        latest = int(flow_files[-1].split("_")[-1].split(".")[0])
        flow_time = io.load(h5_file_name=f"{restart_dir}/flow_{latest:05d}.h5")
        grid_time = forcing_grid_io.load(
            h5_file_name=f"{restart_dir}/forcing_grid_{latest:05d}.h5"
        )
        rod_time = load_rod_state(
            flow_past_rod, f"{restart_dir}/rod_{latest:05d}.h5"
        )
        # restart consistency (reference :225-229)
        assert flow_time == grid_time == rod_time, (
            f"inconsistent checkpoint times: {flow_time}, {grid_time}, "
            f"{rod_time}"
        )
        flow_sim.time = float(flow_time)
        logger.info(f"restarted from checkpoint {latest} at t={flow_time}")
        return latest

    # ---- time loop ----
    flow_past_sim.finalize()

    if fused:
        # whole coupled step under one jit, scanned in windows; state is
        # synced back to the host objects only at checkpoint boundaries.
        # checkpoint_backend: "h5" keeps the reference's on-disk parity
        # (FieldIO + XDMF, host-gathered); "orbax" checkpoints the carry
        # directly - per-shard async device writes, bit-exact resume
        # (utils/checkpoint.py).
        from sopht_mpi_tpu.models import (
            build_rod_fsi_step,
            init_rod_fsi_carry,
            scan_steps,
        )

        use_orbax = checkpoint_backend == "orbax"
        orbax_ckpt = None
        if use_orbax:
            from sopht_mpi_tpu.utils import CarryCheckpointer

            orbax_ckpt = CarryCheckpointer(
                os.path.join(restart_dir, "orbax")
            )
        checkpoint_index = 0
        if restart_simulation and not use_orbax:
            checkpoint_index = load_latest_checkpoint()
        step = build_rod_fsi_step(
            flow_sim,
            cosserat_rod_flow_interactor,
            flow_past_sim,
            dt_prefac=0.25,
            free_stream_fn=lambda t: jnp.asarray(
                velocity_free_stream, real_t
            ),
            rod_dt=rod_dt,
        )
        carry = init_rod_fsi_carry(
            flow_sim, cosserat_rod_flow_interactor, flow_past_rod
        )
        if restart_simulation and use_orbax:
            checkpoint_index = orbax_ckpt.latest_step()
            assert checkpoint_index is not None, "no orbax checkpoint found"
            carry = orbax_ckpt.restore(template=carry)
            logger.info(
                f"restarted from orbax checkpoint {checkpoint_index} "
                f"at t={float(carry.time):.6f}"
            )

        def sync_from(c):
            flow_sim._set_state(c.flow_state)
            flow_sim.time = float(c.time)
            flow_past_rod.state = c.rod_state
            cosserat_rod_flow_interactor.state = c.vb_state

        def checkpoint(index, c):
            if use_orbax:
                # wait=True: the loop donates the carry to the next scan,
                # which would reuse the buffers orbax is still reading
                orbax_ckpt.save(index, c, wait=True)
            else:
                sync_from(c)
                save_checkpoint(index)

        if not restart_simulation:
            checkpoint_index += 1
            checkpoint(checkpoint_index, carry)
        save_timer = 0.0
        while float(carry.time) < final_time:
            t_before = float(carry.time)
            carry, _ = scan_steps(step, carry, window, donate=True)
            save_timer += float(carry.time) - t_before
            if save_timer >= save_interval:
                save_timer = 0.0
                checkpoint_index += 1
                checkpoint(checkpoint_index, carry)
                logger.info(
                    f"time: {float(carry.time):.3f} "
                    f"({float(carry.time) / final_time * 100:2.1f}%)"
                )
        checkpoint_index += 1
        checkpoint(checkpoint_index, carry)
        sync_from(carry)
        if use_orbax:
            orbax_ckpt.close()
        return flow_past_rod, flow_sim

    timestepper = PositionVerlet()
    do_step, stages_and_updates = extend_stepper_interface(
        timestepper, flow_past_sim
    )

    checkpoint_index = 0
    if restart_simulation:
        checkpoint_index = load_latest_checkpoint()
    save_timer = 0.0

    while flow_sim.time < final_time:
        if save_timer >= save_interval or (
            save_timer == 0 and not restart_simulation
        ):
            save_timer = 0.0
            checkpoint_index += 1
            save_checkpoint(checkpoint_index)
            logger.info(
                f"time: {flow_sim.time:.3f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                "grid dev error: "
                f"{cosserat_rod_flow_interactor.get_grid_deviation_error_l2_norm():.6f}"
            )

        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.25)
        rod_time_steps = int(flow_dt / min(flow_dt, rod_dt))
        local_rod_dt = flow_dt / rod_time_steps
        rod_time = flow_sim.time
        for _ in range(rod_time_steps):
            rod_time = do_step(
                timestepper, stages_and_updates, flow_past_sim,
                rod_time, local_rod_dt,
            )
            cosserat_rod_flow_interactor.time_step(dt=local_rod_dt)
        cosserat_rod_flow_interactor()
        flow_sim.time_step(dt=flow_dt, free_stream_velocity=velocity_free_stream)
        save_timer += flow_dt

    checkpoint_index += 1
    save_checkpoint(checkpoint_index)
    return flow_past_rod, flow_sim


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--final-time", type=float, default=1.0)
    parser.add_argument("--grid-size-x", type=int, default=128)
    parser.add_argument("--n-devices", type=int, default=1)
    parser.add_argument("--precision", default="single")
    parser.add_argument("--restart", action="store_true")
    parser.add_argument(
        "--checkpoint-backend", choices=("h5", "orbax"), default="h5",
        help="h5: reference-parity FieldIO+XDMF (host-gathered); orbax: "
        "per-shard device checkpoints of the carry (fused loop only)",
    )
    parser.add_argument(
        "--fused", action="store_true", default=True,
        help="device-scanned fused loop (the default; host loops are "
        "one dispatch per step)",
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
    nx = args.grid_size_x
    flow_past_freely_rotating_rod_case(
        n_elem=nx // 8,
        grid_size=(nx // 2, nx // 2, nx),
        surface_grid_density_for_largest_element=max(8, nx // 10),
        final_time=args.final_time,
        precision=args.precision,
        mesh=mesh,
        restart_simulation=args.restart,
        fused=args.fused,
        checkpoint_backend=args.checkpoint_backend,
    )
