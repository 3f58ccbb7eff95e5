"""Point source advecting and diffusing in 3D (passive vector transport).

Counterpart of /root/reference/examples/3d_examples/
PointSourceAdvectAndDiffuseCase/point_source_advection_diffusion.py
(passive_vector flow type, diffused-point-source analytical oracle,
source at (0.3, 0.3, 0.3), unit velocity in x/y/z, t: 5.0 -> 5.4).

Run:
    python examples/3d/point_source_advect_diffuse.py --grid-size 64
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np


def compute_diffused_point_source_field(
    x_grid, y_grid, z_grid, cm, nu, point_mag, t
):
    """Green's function of the diffusion equation: M / (4 pi nu t)^1.5 *
    exp(-r^2 / 4 nu t)."""
    r2 = (
        (x_grid - cm[0]) ** 2 + (y_grid - cm[1]) ** 2 + (z_grid - cm[2]) ** 2
    )
    return point_mag / (4 * np.pi * nu * t) ** 1.5 * np.exp(-r2 / (4 * nu * t))


def point_source_advection_diffusion_case(
    grid_size=(64, 64, 64), precision="single", mesh=None, save_data=False,
    fused=False, window=100,
):
    import jax.numpy as jnp
    from sopht_mpi_tpu.models import UnboundedFlowSimulator3D
    from sopht_mpi_tpu.utils import get_real_t, logger

    real_t = get_real_t(precision)
    x_range = 1.0
    nu = 1e-3
    t_start, t_end = 5.0, 5.4
    cm_start = np.array([0.3, 0.3, 0.3])
    point_mag = 4.0 * np.pi * nu * t_start**1.5  # peak magnitude ~ 1

    flow_sim = UnboundedFlowSimulator3D(
        grid_size=grid_size,
        x_range=x_range,
        kinematic_viscosity=nu,
        flow_type="passive_vector",
        real_t=real_t,
        mesh=mesh,
        time=t_start,
    )
    x = np.asarray(flow_sim.position_field[0])
    y = np.asarray(flow_sim.position_field[1])
    z = np.asarray(flow_sim.position_field[2])
    init = compute_diffused_point_source_field(
        x, y, z, cm_start, nu, point_mag, t_start
    )
    flow_sim.primary_vector_field = jnp.asarray(
        np.broadcast_to(init, (3, *grid_size)).copy(), real_t
    )
    velocity_free_stream = 1.0
    flow_sim.velocity_field = velocity_free_stream * jnp.ones_like(
        flow_sim.velocity_field
    )

    if fused and save_data:
        raise ValueError(
            "save_data is not supported with fused=True (snapshot writes "
            "live in the host loop)"
        )
    if save_data:
        from sopht_mpi_tpu.utils import FieldBinding, FieldIO

        io = FieldIO(dim=3, real_dtype=real_t)
        io.define_eulerian_grid(
            origin=np.array([z.min(), y.min(), x.min()]),
            dx=flow_sim.dx * np.ones(3),
            grid_size=np.asarray(grid_size),
        )
        io.add_as_eulerian_fields_for_io(
            vorticity=FieldBinding(flow_sim, "primary_vector_field")
        )

    if fused:
        # device-scanned loop; windows overshoot t_end by < window steps,
        # harmless for the error-vs-analytical comparison below
        from sopht_mpi_tpu.models import (
            build_flow_only_step,
            init_flow_only_carry,
            scan_steps,
        )

        step = build_flow_only_step(flow_sim)
        carry = init_flow_only_carry(flow_sim)
        while float(carry.time) < t_end - 1e-10:
            carry, _ = scan_steps(step, carry, window, donate=True)
            logger.info(f"time: {float(carry.time):.3f}")
        flow_sim._set_state(carry.flow_state)
        flow_sim.time = float(carry.time)

    foto_timer = 0.0
    foto_timer_limit = (t_end - t_start) / 20
    while flow_sim.time < t_end - 1e-10:
        if foto_timer > foto_timer_limit or foto_timer == 0:
            foto_timer = 0.0
            max_vort = float(jnp.max(flow_sim.primary_vector_field))
            logger.info(
                f"time: {flow_sim.time:.2f} "
                f"({(flow_sim.time - t_start) / (t_end - t_start) * 100:2.1f}%), "
                f"max_vort: {max_vort:.4f}"
            )
            if save_data:
                io.save(
                    h5_file_name=f"sopht_{int(flow_sim.time * 100):04d}.h5",
                    time=flow_sim.time,
                )
        dt = min(flow_sim.compute_stable_timestep(), t_end - flow_sim.time)
        flow_sim.time_step(dt=dt)
        foto_timer += dt

    # error vs analytical solution at the final time
    t_final = flow_sim.time
    cm_final = cm_start + velocity_free_stream * (t_final - t_start)
    ref = compute_diffused_point_source_field(
        x, y, z, cm_final, nu, point_mag, t_final
    )
    error = np.abs(np.asarray(flow_sim.primary_vector_field) - ref)
    l2 = np.linalg.norm(error) * flow_sim.dx**1.5
    linf = error.max()
    logger.info(f"vorticity L2 error: {l2}")
    logger.info(f"vorticity Linf error: {linf}")
    return l2, linf


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid-size", type=int, default=128)
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
    args = parser.parse_args()

    from sopht_mpi_tpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()

    mesh = None
    if args.n_devices > 1:
        from sopht_mpi_tpu.parallel import create_mesh

        mesh = create_mesh(3, (args.n_devices, 1))
    point_source_advection_diffusion_case(
        grid_size=(args.grid_size,) * 3,
        precision=args.precision,
        mesh=mesh,
        save_data=args.save_data,
        fused=args.fused,
    )
