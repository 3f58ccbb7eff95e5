"""Lamb-Oseen vortex: advecting-diffusing vortex vs the analytical solution.

Counterpart of /root/reference/examples/2d_examples/LambOseenVortexCase/
lamb_oseen_vortex.py (same physics: gamma = 4 pi nu t0 so max vorticity
is 1, vortex at (0.3, 0.3), unit free stream in x and y, t: 1.0 -> 1.4).

Run:
    python examples/2d/lamb_oseen_vortex.py            # single chip
    python examples/2d/lamb_oseen_vortex.py --n-devices 8
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def compute_lamb_oseen_vorticity(x, y, x_cm, y_cm, nu, gamma, t):
    return (
        gamma
        / (4 * np.pi * nu * t)
        * np.exp(-((x - x_cm) ** 2 + (y - y_cm) ** 2) / (4 * nu * t))
    )


def compute_lamb_oseen_velocity(x, y, x_cm, y_cm, nu, gamma, t):
    r2 = np.maximum((x - x_cm) ** 2 + (y - y_cm) ** 2, 1e-14)
    r = np.sqrt(r2)
    u_theta = gamma / (2 * np.pi * r) * (1 - np.exp(-r2 / (4 * nu * t)))
    return np.stack([-u_theta * (y - y_cm) / r, u_theta * (x - x_cm) / r])


def lamb_oseen_vortex_flow_case(
    grid_size=(256, 256), precision="single", mesh=None, plot=False,
    fused=False, window=100,
):
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import UnboundedFlowSimulator2D
    from sopht_mpi_tpu.utils import get_real_t, logger

    real_t = get_real_t(precision)
    x_range = 1.0
    nu = 1e-3
    x_cm_start = y_cm_start = 0.3
    t_start, t_end = 1.0, 1.4
    gamma = 4 * np.pi * nu * t_start  # max vorticity = 1 at t_start

    flow_sim = UnboundedFlowSimulator2D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu,
        flow_type="navier_stokes",
        with_free_stream_flow=True,
        real_t=real_t,
        mesh=mesh,
        time=t_start,
    )
    x = np.asarray(flow_sim.position_field[0])
    y = np.asarray(flow_sim.position_field[1])
    flow_sim.vorticity_field = jnp.asarray(
        compute_lamb_oseen_vorticity(
            x, y, x_cm_start, y_cm_start, nu, gamma, t_start
        ),
        real_t,
    )
    velocity_free_stream = np.ones(2)
    flow_sim.velocity_field = jnp.asarray(
        compute_lamb_oseen_velocity(
            x, y, x_cm_start, y_cm_start, nu, gamma, t_start
        )
        + velocity_free_stream[:, None, None],
        real_t,
    )

    if fused and plot:
        raise ValueError(
            "plot is not supported with fused=True (snapshots live in the "
            "host loop)"
        )
    if plot:
        from sopht_mpi_tpu.utils import Plotter2D

        plotter = Plotter2D()

    if fused:
        # device-scanned loop (a host loop pays one dispatch per step);
        # windows overshoot t_end by < window
        # steps, harmless for the error-vs-analytical comparison below
        from sopht_mpi_tpu.models import (
            build_flow_only_step,
            init_flow_only_carry,
            scan_steps,
        )

        step = build_flow_only_step(
            flow_sim,
            free_stream_fn=lambda t: jnp.asarray(
                velocity_free_stream, real_t
            ),
        )
        carry = init_flow_only_carry(flow_sim)
        while float(carry.time) < t_end - 1e-10:
            carry, _ = scan_steps(step, carry, window, donate=True)
            logger.info(f"time: {float(carry.time):.3f}")
        flow_sim._set_state(carry.flow_state)
        flow_sim.time = float(carry.time)

    foto_timer = 0.0
    foto_timer_limit = (t_end - t_start) / 25
    while flow_sim.time < t_end - 1e-10:
        if plot and (foto_timer >= foto_timer_limit or foto_timer == 0):
            foto_timer = 0.0
            plotter.contourf(x, y, np.asarray(flow_sim.vorticity_field))
            plotter.savefig(f"snap_{int(flow_sim.time*100):04d}.png")
            plotter.clearfig()
        if int(flow_sim.time * 100) % 10 == 0:
            logger.info(
                f"time: {flow_sim.time:.2f}, "
                f"max_vort: {flow_sim.get_max_vorticity():.4f}"
            )
        dt = min(flow_sim.compute_stable_timestep(), t_end - flow_sim.time)
        flow_sim.time_step(dt=dt, free_stream_velocity=velocity_free_stream)
        foto_timer += dt

    # final error vs the advected-diffused analytical solution
    t_final = flow_sim.time
    x_cm = x_cm_start + velocity_free_stream[0] * (t_final - t_start)
    y_cm = y_cm_start + velocity_free_stream[1] * (t_final - t_start)
    vort_ref = compute_lamb_oseen_vorticity(x, y, x_cm, y_cm, nu, gamma, t_final)
    error = np.abs(np.asarray(flow_sim.vorticity_field) - vort_ref)
    l2 = np.linalg.norm(error) * flow_sim.dx
    linf = error.max()
    logger.info(f"vorticity L2 error: {l2}")
    logger.info(f"vorticity Linf error: {linf}")
    return l2, linf


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size", type=int, default=256)
    parser.add_argument("--n-devices", type=int, default=1)
    parser.add_argument("--precision", default="single")
    parser.add_argument("--plot", action="store_true")
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
    lamb_oseen_vortex_flow_case(
        grid_size=(args.grid_size, args.grid_size),
        precision=args.precision,
        mesh=mesh,
        plot=args.plot,
        fused=args.fused,
    )
