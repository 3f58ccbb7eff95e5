"""Flow past a 3D flexible rod (filament bent by a free stream).

Counterpart of /root/reference/examples/3d_examples/FlowPastRodCase/
flow_past_rod_case.py (rod hanging into the flow, surface forcing grid,
Laplacian vorticity filtering {"order": 1, "type": "multiplicative"},
Cauchy/mass-ratio/Froude/stretch-bending nondimensional setup).

Run:
    python examples/3d/flow_past_rod.py --grid-size-x 64 --final-time 1
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def flow_past_rod_case(
    n_elem=40,
    grid_size=(128, 32, 128),
    surface_grid_density_for_largest_element=16,
    cauchy_number=0.1,
    mass_ratio=100.0,
    froude_number=0.5,
    stretch_bending_ratio=None,
    poisson_ratio=0.5,
    reynolds=100.0,
    coupling_stiffness=-2e5,
    coupling_damping=-1e2,
    rod_start_incline_angle=0.0,
    precision="single",
    mesh=None,
    final_time=2.0,
    save_data=False,
    fused=False,
    window=50,
    sparse_forcing=None,
):
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import (
        AnalyticalLinearDamper,
        BaseSystemCollection,
        CosseratRod,
        CosseratRodFlowInteraction,
        CosseratRodSurfaceForcingGrid,
        FlowForces,
        GravityForces,
        OneEndFixedBC,
        PositionVerlet,
        UnboundedFlowSimulator3D,
        extend_stepper_interface,
    )
    from sopht_mpi_tpu.utils import get_real_t, logger

    grid_size_z, grid_size_y, grid_size_x = grid_size
    real_t = get_real_t(precision)
    rho_f = 1.0
    u_free_stream = 1.0
    base_length = 1.0
    x_range = 1.8 * base_length
    y_range = grid_size_y / grid_size_x * x_range
    z_range = grid_size_z / grid_size_x * x_range
    velocity_free_stream = [u_free_stream, 0.0, 0.0]

    # ---- rod setup (reference flow_past_rod_case.py:50-100) ----
    flow_past_sim = BaseSystemCollection()
    start = np.array([0.2 * x_range, 0.5 * y_range, 0.75 * z_range])
    direction = np.array(
        [np.sin(rod_start_incline_angle), 0.0, -np.cos(rod_start_incline_angle)]
    )
    normal = np.array([0.0, 1.0, 0.0])
    base_diameter = y_range / 5.0
    base_radius = base_diameter / 2.0
    base_area = np.pi * base_radius**2
    rho_s = mass_ratio * rho_f
    moment_of_inertia = np.pi / 4 * base_radius**4
    youngs_modulus = (
        rho_f * u_free_stream**2 * base_length**3 * base_diameter
    ) / (cauchy_number * moment_of_inertia)
    gravitational_acc = froude_number * u_free_stream**2 / base_diameter
    # stretch-to-bending ratio EAL^2/EI. The reference's driver passes the
    # EXPERIMENTAL rod's ratio (~6.2e4 for the 25mm x 0.4mm filament,
    # flow_past_rod_case.py:356-358) - much stiffer axially/in shear than
    # the simulated thick rod's physical ratio, which would otherwise
    # shear-slide under the flow instead of bending.
    if stretch_bending_ratio is None:
        exp_radius, exp_length = 0.2e-3, 25e-3
        exp_area = np.pi * exp_radius**2
        exp_moi = np.pi / 4 * exp_radius**4
        stretch_bending_ratio = exp_area * exp_length**2 / exp_moi
    es_eb = stretch_bending_ratio * moment_of_inertia / (
        base_area * base_length**2
    )

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
    # stretch-to-bending stiffness scaling (reference :86)
    flow_past_rod.params = flow_past_rod.params._replace(
        shear_diag=flow_past_rod.params.shear_diag.at[2].mul(es_eb)
    )
    flow_past_sim.append(flow_past_rod)
    flow_past_sim.constrain(flow_past_rod).using(
        OneEndFixedBC,
        constrained_position_idx=(0,),
        constrained_director_idx=(0,),
    )
    flow_past_sim.add_forcing_to(flow_past_rod).using(
        GravityForces, acc_gravity=np.array([0.0, 0.0, -gravitational_acc])
    )
    dl = base_length / n_elem
    # rod timestep: PyElastica's 0.01*dl heuristic, capped by the axial
    # wave speed of the (stretch-stiffened) rod, c = sqrt(E*es_eb/rho)
    axial_wave_speed = np.sqrt(youngs_modulus * es_eb / rho_s)
    rod_dt = min(0.01 * dl, 0.3 * dl / axial_wave_speed)
    flow_past_sim.dampen(flow_past_rod).using(
        AnalyticalLinearDamper, damping_constant=1e-3, time_step=rod_dt
    )

    # ---- flow setup (vorticity filtering for stability, reference :114-115) ----
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
        filter_setting_dict={"order": 1, "type": "multiplicative"},
    )

    # ---- coupling ----
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
    # fused + save_data: field snapshots ride the native async dump writer
    # at scan-window boundaries (utils/snapshots.py) instead of the host
    # loop's synchronous FieldIO
    if not fused:
        # the fused loop computes the flow forces in-trace instead
        flow_past_sim.add_forcing_to(flow_past_rod).using(
            FlowForces, cosserat_rod_flow_interactor
        )

    if save_data and not fused:
        from sopht_mpi_tpu.utils import CosseratRodIO, FieldBinding, FieldIO

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
            vorticity=FieldBinding(flow_sim, "vorticity_field")
        )
        rod_io = CosseratRodIO(cosserat_rod=flow_past_rod, real_dtype=real_t)

    # ---- time loop ----
    flow_past_sim.finalize()

    if fused:
        import jax.numpy as jnp
        from sopht_mpi_tpu.models import (
            build_rod_fsi_step,
            init_rod_fsi_carry,
            scan_steps,
        )

        # sparse_forcing: None = auto (default since the physics-long
        # sparse-vs-dense validation: max tip deviation 2.0e-5 of rod
        # length over t*=2 at 256x64x256 reference-faithful geometry,
        # doc/validation_rod_sparse_vs_dense.json);
        # True = require it; False = dense reference-shaped path.
        from sopht_mpi_tpu.models import suggest_rod_forcing_window

        # round 5: the sparse window also runs under a mesh (window work
        # replicated per chip, sharded-grid touches via parallel.windows)
        sparse_window = None
        if sparse_forcing is not False:
            sparse_window = suggest_rod_forcing_window(
                cosserat_rod_flow_interactor, flow_past_rod, grid_size
            )
            if sparse_window is None:
                msg = (
                    "sparse forcing window would cover most of the grid "
                    "(rod reach ~ domain size); keeping the dense path"
                )
                if sparse_forcing is True:
                    raise ValueError(msg)
                logger.warning(msg)
            else:
                logger.info(
                    f"sparse forcing window (Wz, Wy, Wx): {sparse_window}"
                )
        def build_step(win):
            return build_rod_fsi_step(
                flow_sim,
                cosserat_rod_flow_interactor,
                flow_past_sim,
                dt_prefac=0.25,
                free_stream_fn=lambda t: jnp.asarray(
                    velocity_free_stream, real_t
                ),
                rod_dt=rod_dt,
                sparse_forcing_window=win,
            )

        step = build_step(sparse_window)
        carry = init_rod_fsi_carry(
            flow_sim, cosserat_rod_flow_interactor, flow_past_rod
        )
        snaps = None
        if save_data:
            from sopht_mpi_tpu.utils import SnapshotWriter

            logger.warning(
                "fused save_data writes async .npy snapshots "
                "(vorticity + rod positions) to snapshots/, NOT the host "
                "loop's FieldIO h5+XDMF set; use --host-loop for h5 output"
            )
            snaps = SnapshotWriter(
                interval=final_time / 50, out_dir="snapshots"
            )
        tip_times, tip_positions = [], []
        window_margin, regrow_attempts = 1.1, 0
        while float(carry.time) < final_time:
            # no donation while a sparse window is active: `carry` must
            # survive the scan so a tripped window can be REPLAYED
            new_carry, diag = scan_steps(
                step, carry, window, donate=sparse_window is None
            )
            if sparse_window is not None and not bool(jnp.all(diag[1])):
                # the tripped window's physics is tainted from the trip
                # step on - self-heal: grow the forcing window (falling
                # back to the dense path when it would cover most of the
                # grid), rebuild the fused step (one recompile), and
                # replay this scan window from the last good carry
                regrow_attempts += 1
                if regrow_attempts > 3:
                    # consecutive trips despite regrowing: window coverage
                    # is not the cause (likely a substep-count overflow)
                    raise RuntimeError(
                        "sparse forcing window still tripping after 3 "
                        "consecutive regrows - likely a substep-count "
                        "overflow, not window coverage; disable "
                        "sparse_forcing or raise max_rod_substeps"
                    )
                window_margin *= 1.3
                prev_window = sparse_window
                sparse_window = suggest_rod_forcing_window(
                    cosserat_rod_flow_interactor, flow_past_rod, grid_size,
                    margin=window_margin,
                )
                if sparse_window is None and sparse_forcing is True:
                    raise RuntimeError(
                        "sparse forcing was REQUIRED (sparse_forcing=True) "
                        "but the regrown window would cover most of the "
                        "grid; rerun without --sparse-forcing to allow the "
                        "dense fallback"
                    )
                if sparse_window == prev_window:
                    # the grown margin produced the SAME (wall-clamped)
                    # window: replaying would trip identically - coverage
                    # cannot improve, so fall back to dense immediately
                    # instead of burning replayed scan windows (and do not
                    # blame substep overflow: the clamp is the cause)
                    if sparse_forcing is True:
                        raise RuntimeError(
                            "sparse forcing window is wall-clamped and "
                            "cannot grow further (window "
                            f"{sparse_window} unchanged at margin "
                            f"{window_margin:.2f}) yet the rod outran it; "
                            "sparse_forcing=True forbids the dense "
                            "fallback - rerun without --sparse-forcing"
                        )
                    logger.warning(
                        "regrown sparse window unchanged (wall-clamped); "
                        "falling back to the dense forcing path"
                    )
                    sparse_window = None
                logger.warning(
                    "sparse forcing window outgrown mid-run; rebuilding "
                    f"with margin {window_margin:.2f} -> window "
                    f"{sparse_window} (None = dense) and replaying from "
                    f"t={float(carry.time):.4f}"
                )
                step = build_step(sparse_window)
                continue
            regrow_attempts = 0  # this window completed: heals succeeded
            carry = new_carry
            if snaps is not None:
                snaps.maybe_save(
                    float(carry.time),
                    vorticity=carry.flow_state.primary_field,
                    rod_position=carry.rod_state.position,
                )
            tip_times.append(float(carry.time))
            tip_positions.append(np.asarray(carry.rod_state.position[:, -1]))
            logger.info(
                f"time: {tip_times[-1]:.2f} "
                f"({tip_times[-1] / final_time * 100:2.1f}%), "
                f"tip: {tip_positions[-1]}"
            )
        if snaps is not None:
            snaps.close()
        return np.asarray(tip_times), np.asarray(tip_positions)

    if sparse_forcing is True:
        raise ValueError("sparse_forcing=True needs the fused loop")
    timestepper = PositionVerlet()
    do_step, stages_and_updates = extend_stepper_interface(
        timestepper, flow_past_sim
    )
    foto_timer = 0.0
    foto_timer_limit = final_time / 50
    tip_times, tip_positions = [], []

    while flow_sim.time < final_time:
        if foto_timer >= foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            tip_times.append(flow_sim.time)
            tip_positions.append(
                np.asarray(flow_past_rod.position_collection[:, -1]).copy()
            )
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                f"vort divg. L2: "
                f"{flow_sim.get_vorticity_divergence_l2_norm():.4f}, "
                "grid dev error: "
                f"{cosserat_rod_flow_interactor.get_grid_deviation_error_l2_norm():.6f}"
            )
            if save_data:
                io.save(
                    h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
                rod_io.save(
                    h5_file_name=f"rod_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
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
        foto_timer += flow_dt

    return np.asarray(tip_times), np.asarray(tip_positions)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--final-time", type=float, default=2.0)
    parser.add_argument("--grid-size-x", type=int, default=128)
    parser.add_argument("--n-elem", type=int, default=None)
    parser.add_argument("--n-devices", type=int, default=1)
    parser.add_argument("--precision", default="single")
    parser.add_argument("--save-data", action="store_true")
    parser.add_argument(
        "--fused", action="store_true", default=True,
        help="device-scanned fused loop (the default; host loops are "
        "one dispatch per step)",
    )
    parser.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven eager loop (CPU debugging)",
    )
    parser.add_argument(
        "--sparse-forcing", dest="sparse_forcing", action="store_true",
        default=None,
        help="require moving-window sparse IBM forcing (fused 3D unsharded "
        "only): spread + forcing curl act on an auto-sized window tracking "
        "the rod's marker support (suggest_rod_forcing_window); if the "
        "support ever outgrows the window the run self-heals (regrow + "
        "replay), erroring only if sparse would have to go dense. DEFAULT "
        "is auto: sparse "
        "when applicable and the window fits, dense otherwise (validated "
        "sparse==dense to 2e-5 tip deviation over t*=2 at 256x64x256, "
        "doc/validation_rod_sparse_vs_dense.json)",
    )
    parser.add_argument(
        "--dense-forcing", dest="sparse_forcing", action="store_false",
        help="force the dense reference-shaped IBM forcing path",
    )
    args = parser.parse_args()

    from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()


    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu.parallel import create_mesh

        mesh = create_mesh(3, (args.n_devices, 1))
    nx = args.grid_size_x
    # reference grid aspect and rod discretization
    # (flow_past_rod_case.py:310-315): nz = nx, ny = nx/4 - the z extent
    # must hold the full unit-length rod (start 0.75*z_range, tip
    # 0.75*z_range - L; z_range < 1.33 L would push the tip through the
    # domain floor)
    flow_past_rod_case(
        n_elem=args.n_elem or 5 * nx // 16,
        grid_size=(nx, nx // 4, nx),
        surface_grid_density_for_largest_element=nx // 8,
        final_time=args.final_time,
        precision=args.precision,
        mesh=mesh,
        save_data=args.save_data,
        fused=args.fused,
        sparse_forcing=args.sparse_forcing,
    )
