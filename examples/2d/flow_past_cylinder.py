"""Flow past a fixed circular cylinder at Re=200 (vortex shedding + drag).

Counterpart of /root/reference/examples/2d_examples/FlowPastCylinderCase/
flow_past_cylinder.py (same physics: velocity scale 1, cylinder radius
0.03, x_range 1, coupling stiffness -5e4 / damping -20, 60 forcing points).

Run (one GPU or CPU):
    python examples/2d/flow_past_cylinder.py --grid-size-x 512 --final-time 200

Multi-device:
    python examples/2d/flow_past_cylinder.py --n-devices 8
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def flow_past_cylinder_boundary_forcing_case(
    nondim_final_time=200.0,
    grid_size=(256, 512),
    reynolds=200.0,
    coupling_stiffness=-5e4,
    coupling_damping=-20.0,
    mesh=None,
    precision="single",
    save_diagnostic=False,
    plot=False,
):
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import (
        CircularCylinderForcingGrid,
        Cylinder,
        RigidBodyFlowInteraction,
        UnboundedFlowSimulator2D,
    )
    from sopht_mpi_tpu.utils import get_real_t, logger

    real_t = get_real_t(precision)

    # Flow parameters (reference flow_past_cylinder.py:31-36)
    velocity_scale = 1.0
    velocity_free_stream = (velocity_scale, 0.0)
    cyl_radius = 0.03
    nu = cyl_radius * velocity_scale / reynolds
    x_range = 1.0

    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        mesh=mesh,
    )

    # Fixed cylinder (reference :50-59)
    x_cm = 2.5 * cyl_radius
    y_cm = 0.5 * flow_sim.grid_size_y / flow_sim.grid_size_x
    num_lag_nodes = 60
    cylinder = Cylinder(center=(x_cm, y_cm), radius=cyl_radius, dtype=real_t)
    forcing_grid = CircularCylinderForcingGrid(cylinder, num_lag_nodes)
    cylinder_flow_interactor = RigidBodyFlowInteraction(
        flow_sim,
        cylinder,
        forcing_grid,
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )

    timescale = cyl_radius / velocity_scale
    final_time = nondim_final_time * timescale
    data_timer = 0.0
    data_timer_limit = 0.25 * timescale
    drag_coeffs_time, drag_coeffs = [], []
    foto_timer = 0.0
    foto_timer_limit = final_time / 50

    while flow_sim.time < final_time:
        if foto_timer >= foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({flow_sim.time / final_time * 100:2.1f}%), "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}, "
                "grid deviation L2 error: "
                f"{cylinder_flow_interactor.get_grid_deviation_error_l2_norm():.8f}"
            )
            if plot:
                _plot_fields(flow_sim, cylinder_flow_interactor, timescale)

        if data_timer >= data_timer_limit or data_timer == 0:
            data_timer = 0.0
            drag_coeffs_time.append(flow_sim.time / timescale)
            F = float(
                jnp.sum(
                    cylinder_flow_interactor.global_lag_grid_forcing_field[0]
                )
            )
            drag_coeff = abs(F) / velocity_scale / velocity_scale / cyl_radius
            drag_coeffs.append(drag_coeff)

        dt = flow_sim.compute_stable_timestep()
        cylinder_flow_interactor.time_step(dt=dt)
        cylinder_flow_interactor()
        flow_sim.time_step(dt=dt, free_stream_velocity=velocity_free_stream)

        foto_timer += dt
        data_timer += dt

    if save_diagnostic:
        np.savetxt(
            "drag_vs_time.csv",
            np.c_[np.array(drag_coeffs_time), np.array(drag_coeffs)],
            delimiter=",",
        )
    if plot:
        # assemble the snapshots into a movie (the reference's post-loop
        # ffmpeg call, flow_past_cylinder.py:172-179; GIF fallback when
        # ffmpeg is absent)
        from sopht_mpi_tpu.utils import compile_video

        out = compile_video("snap_*.png", output="flow.mp4", fps=10)
        if out:
            logger.info(f"wrote {out}")
    return drag_coeffs_time, drag_coeffs


def _plot_fields(flow_sim, interactor, timescale):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from sopht_mpi_tpu.utils import lab_cmap

    fig, ax = plt.subplots(figsize=(8, 4))
    x = np.asarray(flow_sim.position_field[0])
    y = np.asarray(flow_sim.position_field[1])
    ax.contourf(
        x, y, np.asarray(flow_sim.vorticity_field),
        levels=np.linspace(-25, 25, 100), extend="both", cmap=lab_cmap,
    )
    pos = np.asarray(interactor.forcing_grid.compute_lag_grid_position_field())
    ax.scatter(pos[0], pos[1], s=4, color="k")
    ax.set_title(f"Vorticity, time: {flow_sim.time / timescale:.2f}")
    ax.set_aspect("equal")
    fig.savefig(f"snap_{int(flow_sim.time * 100):04d}.png")
    plt.close(fig)


def flow_past_cylinder_fused_case(
    nondim_final_time=200.0,
    grid_size=(256, 512),
    reynolds=200.0,
    coupling_stiffness=-5e4,
    coupling_damping=-20.0,
    precision="single",
    window=500,
    mesh=None,
):
    """Same physics, but the whole coupled loop (CFL dt + IBM + flow step)
    runs as one on-device ``lax.scan`` (models/fsi.py). Validated drag history: Cd oscillates in [1.38, 1.57]
    (doc/validation_cylinder_re200_drag.csv)."""
    import jax
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import (
        CircularCylinderForcingGrid,
        Cylinder,
        RigidBodyFlowInteraction,
        UnboundedFlowSimulator2D,
        build_rigid_fsi_step,
        init_rigid_fsi_carry,
        scan_steps,
    )
    from sopht_mpi_tpu.utils import get_real_t, logger

    real_t = get_real_t(precision)
    velocity_scale = 1.0
    cyl_radius = 0.03
    nu = cyl_radius * velocity_scale / reynolds
    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=1.0,
        kinematic_viscosity=nu,
        flow_type="navier_stokes_with_forcing",
        with_free_stream_flow=True,
        real_t=real_t,
        mesh=mesh,
    )
    cylinder = Cylinder(
        center=(2.5 * cyl_radius, 0.5 * grid_size[0] / grid_size[1]),
        radius=cyl_radius,
        dtype=real_t,
    )
    interactor = RigidBodyFlowInteraction(
        flow_sim,
        cylinder,
        CircularCylinderForcingGrid(cylinder, 60),
        virtual_boundary_stiffness_coeff=coupling_stiffness,
        virtual_boundary_damping_coeff=coupling_damping,
    )
    step = build_rigid_fsi_step(
        flow_sim,
        interactor,
        dt_prefac=1.0,
        free_stream_fn=lambda t: jnp.asarray([velocity_scale, 0.0], real_t),
    )
    carry = init_rigid_fsi_carry(flow_sim, interactor)
    timescale = cyl_radius / velocity_scale
    t_end = nondim_final_time * timescale
    times, drag_coeffs = [], []
    while float(carry.time) < t_end:
        carry, lag_forces = scan_steps(step, carry, window, donate=True)
        jax.block_until_ready(carry)
        cd = float(np.abs(np.asarray(lag_forces[-1, 0]))) / (
            velocity_scale**2 * cyl_radius
        )
        times.append(float(carry.time) / timescale)
        drag_coeffs.append(cd)
        logger.info(f"t*={times[-1]:.1f} Cd={cd:.3f}")
    np.savetxt(
        "drag_vs_time.csv", np.c_[times, drag_coeffs], delimiter=","
    )
    return times, drag_coeffs


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--grid-size-x", type=int, default=512)
    p.add_argument("--final-time", type=float, default=200.0)
    p.add_argument("--reynolds", type=float, default=200.0)
    p.add_argument("--n-devices", type=int, default=1)
    p.add_argument("--plot", action="store_true")
    p.add_argument(
        "--fused", action="store_true", default=True,
        help="run the whole coupled loop as one on-device lax.scan "
        "(the default; host loops are one dispatch per step)",
    )
    p.add_argument(
        "--host-loop", dest="fused", action="store_false",
        help="host-driven eager loop (CPU debugging)",
    )
    args = p.parse_args()

    from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu.parallel import create_mesh

        mesh = create_mesh(2, (args.n_devices, 1))
    grid = (args.grid_size_x // 2, args.grid_size_x)
    if args.fused:
        flow_past_cylinder_fused_case(
            nondim_final_time=args.final_time,
            grid_size=grid,
            reynolds=args.reynolds,
            mesh=mesh,
        )
        raise SystemExit(0)
    flow_past_cylinder_boundary_forcing_case(
        nondim_final_time=args.final_time,
        grid_size=grid,
        reynolds=args.reynolds,
        mesh=mesh,
        save_diagnostic=True,
        plot=args.plot,
    )
