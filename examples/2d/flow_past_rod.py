"""Flow past a flexible rod: the classical flapping-filament benchmark.

Counterpart of /root/reference/examples/2d_examples/FlowPastRodCase/
flow_past_rod.py (Re=200, nondim bending stiffness 1.5e-3, mass ratio 1.5,
Froude 0.5; rod clamped at one end in a free stream with ramped onset and
an initial cross-stream perturbation).

Run:
    python examples/2d/flow_past_rod.py --final-time 5 --grid-size-x 256
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def flow_past_rod_case(
    nondim_final_time=20.0,
    grid_size=(256, 512),
    reynolds=200.0,
    nondim_bending_stiffness=1.5e-3,
    nondim_mass_ratio=1.5,
    froude=0.5,
    rod_start_incline_angle=0.0,
    coupling_stiffness=-8e4,
    coupling_damping=-30.0,
    precision="single",
    mesh=None,
    save_flow_data=False,
    fused=False,
    window=100,
):
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import (
        AnalyticalLinearDamper,
        BaseSystemCollection,
        CosseratRod,
        CosseratRodElementCentricForcingGrid,
        CosseratRodFlowInteraction,
        FlowForces,
        GravityForces,
        OneEndFixedBC,
        PositionVerlet,
        UnboundedFlowSimulator2D,
        extend_stepper_interface,
    )
    from sopht_mpi_tpu.utils import get_real_t, logger

    grid_size_y, grid_size_x = grid_size
    velocity_free_stream = 1.0
    rho_f = 1.0
    base_length = 1.0
    x_range = 6.0 * base_length
    y_range = grid_size_y / grid_size_x * x_range

    # ---- rod setup (reference flow_past_rod.py:47-103) ----
    flow_past_sim = BaseSystemCollection()
    n_elem = grid_size_x // 8
    start = np.array([base_length, 0.501 * y_range, 0.0])
    direction = np.array(
        [np.cos(rod_start_incline_angle), np.sin(rod_start_incline_angle), 0.0]
    )
    normal = np.array([0.0, 0.0, 1.0])
    base_radius = 0.01
    base_area = np.pi * base_radius**2
    z_axis_width = 1.0
    rod_line_density = nondim_mass_ratio * rho_f * base_length * z_axis_width
    density = rod_line_density / base_area
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        nondim_bending_stiffness
        * (rho_f * velocity_free_stream**2 * base_length**3 * z_axis_width)
        / moment_of_inertia
    )
    poisson_ratio = 0.5
    gravitational_acc = froude * velocity_free_stream**2 / base_length

    flow_past_rod = CosseratRod.straight_rod(
        n_elem,
        start,
        direction,
        normal,
        base_length,
        base_radius,
        density,
        youngs_modulus=youngs_modulus,
        shear_modulus=youngs_modulus / (poisson_ratio + 1.0),
    )
    tip_start_position = np.asarray(
        flow_past_rod.position_collection[(0, 1), -1]
    )
    flow_past_sim.append(flow_past_rod)
    flow_past_sim.constrain(flow_past_rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    flow_past_sim.add_forcing_to(flow_past_rod).using(
        GravityForces, acc_gravity=np.array([gravitational_acc, 0.0, 0.0])
    )
    dl = base_length / n_elem
    rod_dt = 0.01 * dl
    flow_past_sim.dampen(flow_past_rod).using(
        AnalyticalLinearDamper,
        damping_constant=0.5e-3,
        time_step=rod_dt,
    )

    # ---- flow setup ----
    real_t = get_real_t(precision)
    nu = base_length * velocity_free_stream / reynolds
    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        mesh=mesh,
    )

    if fused and save_flow_data:
        raise ValueError("save_flow_data is not supported with fused=True")

    # ---- coupling ----
    cosserat_rod_flow_interactor = CosseratRodFlowInteraction(
        flow_sim=flow_sim,
        cosserat_rod=flow_past_rod,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
        forcing_grid_cls=CosseratRodElementCentricForcingGrid,
    )
    if not fused:
        # the fused loop computes the flow forces in-trace instead
        flow_past_sim.add_forcing_to(flow_past_rod).using(
            FlowForces, cosserat_rod_flow_interactor
        )

    if save_flow_data:
        from sopht_mpi_tpu.utils import CosseratRodIO, FieldBinding, FieldIO

        io = FieldIO(dim=2, real_dtype=real_t)
        origin = np.asarray(
            [
                float(flow_sim.position_field[1].min()),
                float(flow_sim.position_field[0].min()),
            ]
        )
        io.define_eulerian_grid(
            origin=origin,
            dx=flow_sim.dx * np.ones(2),
            grid_size=np.asarray(grid_size),
        )
        io.add_as_eulerian_fields_for_io(
            vorticity=FieldBinding(flow_sim, "vorticity_field"),
            velocity=FieldBinding(flow_sim, "velocity_field"),
        )
        rod_io = CosseratRodIO(
            cosserat_rod=flow_past_rod, real_dtype=real_t, dim=2
        )

    # ---- time loop (reference :185-300) ----
    flow_past_sim.finalize()

    if fused:
        from sopht_mpi_tpu.models import (
            build_rod_fsi_step,
            init_rod_fsi_carry,
            scan_steps,
        )

        timescale = base_length / velocity_free_stream
        final_time = nondim_final_time * timescale

        def free_stream(t):
            # freestream ramp + decaying y-perturbation (reference :289-297)
            ramp = jnp.exp(-t / timescale)
            return jnp.asarray(
                [
                    velocity_free_stream * (1.0 - ramp),
                    0.5 * velocity_free_stream * ramp,
                ],
                real_t,
            )

        step = build_rod_fsi_step(
            flow_sim,
            cosserat_rod_flow_interactor,
            flow_past_sim,
            dt_prefac=0.5,
            free_stream_fn=free_stream,
            rod_dt=rod_dt,
        )
        carry = init_rod_fsi_carry(
            flow_sim, cosserat_rod_flow_interactor, flow_past_rod
        )
        tip_time, tip_position = [], []
        while float(carry.time) < final_time:
            carry, _ = scan_steps(step, carry, window, donate=True)
            tip = (
                np.asarray(carry.rod_state.position[(0, 1), -1])
                - tip_start_position
            ) / base_length
            tip_time.append(float(carry.time) / timescale)
            tip_position.append(tip)
            logger.info(
                f"t*={tip_time[-1]:.2f} tip=({tip[0]:+.3f}, {tip[1]:+.3f}) L"
            )
        np.savetxt(
            "rod_tip_position_vs_time.csv",
            np.column_stack(
                (np.asarray(tip_time), np.asarray(tip_position))
            ),
            delimiter=",",
            header="time, tip_x, tip_y",
        )
        return np.asarray(tip_time), np.asarray(tip_position)

    timestepper = PositionVerlet()
    do_step, stages_and_updates = extend_stepper_interface(
        timestepper, flow_past_sim
    )
    timescale = base_length / velocity_free_stream
    final_time = nondim_final_time * timescale
    ramp_timescale = timescale
    velocity_free_stream_perturb = 0.5 * velocity_free_stream

    foto_timer = 0.0
    foto_timer_limit = final_time / 60
    data_timer = 0.0
    data_timer_limit = 0.1 * timescale
    tip_time, tip_position = [], []

    while flow_sim.time < final_time:
        if foto_timer >= foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                f"grid dev error: "
                f"{cosserat_rod_flow_interactor.get_grid_deviation_error_l2_norm():.8f}"
            )
            if save_flow_data:
                io.save(
                    h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
                rod_io.save(
                    h5_file_name=f"rod_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
        if data_timer >= data_timer_limit or data_timer == 0:
            data_timer = 0.0
            tip_time.append(flow_sim.time / timescale)
            tip_position.append(
                (
                    np.asarray(flow_past_rod.position_collection[(0, 1), -1])
                    - tip_start_position
                )
                / base_length
            )

        flow_dt = flow_sim.compute_stable_timestep(dt_prefac=0.5)

        # substep the rod through the flow timestep (reference :276-284)
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

        ramp_factor = np.exp(-flow_sim.time / ramp_timescale)
        flow_sim.time_step(
            dt=flow_dt,
            free_stream_velocity=[
                velocity_free_stream * (1.0 - ramp_factor),
                velocity_free_stream_perturb * ramp_factor,
            ],
        )
        foto_timer += flow_dt
        data_timer += flow_dt

    np.savetxt(
        "rod_tip_position_vs_time.csv",
        np.column_stack(
            (np.asarray(tip_time), np.asarray(tip_position))
        ),
        delimiter=",",
        header="time, tip_x, tip_y",
    )
    return np.asarray(tip_time), np.asarray(tip_position)




if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--final-time", type=float, default=20.0)
    parser.add_argument("--grid-size-x", type=int, default=512)
    parser.add_argument("--n-devices", type=int, default=1)
    parser.add_argument("--precision", default="single")
    parser.add_argument("--save-flow-data", action="store_true")
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

        mesh = create_mesh(2, (args.n_devices, 1))
    flow_past_rod_case(
        nondim_final_time=args.final_time,
        grid_size=(args.grid_size_x // 2, args.grid_size_x),
        precision=args.precision,
        mesh=mesh,
        save_flow_data=args.save_flow_data,
        fused=args.fused,
    )
