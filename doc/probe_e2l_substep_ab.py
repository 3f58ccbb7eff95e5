"""A/B: substep E->L interpolation, windowed separable-matmul vs plain
XLA support gather, over a sweep of window sizes up to the (256, 64, 256)
rod-bench window (181, 64, 181) ~ 2.1M cells, 2560 markers. Sets the
fsi._GATHER_SUBSTEP_WINDOW_CELLS crossover: the mm costs
O(n * window_cells) MACs per call while the gather reads only
n * (2w)^3 cells of the full field. Run on the GPU:
``python doc/probe_e2l_substep_ab.py``."""
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sopht_mpi_tpu.ops.ibm import (  # noqa: E402
    axis_delta_weight_matrices,
    eulerian_to_lagrangian_interpolation_mm,
    nearest_grid_index_and_support,
)
from sopht_mpi_tpu.ops.virtual_boundary import (  # noqa: E402
    VirtualBoundaryForcingParams,
    VirtualBoundaryState,
    compute_interaction_force_on_lag_grid,
)
from sopht_mpi_tpu.utils.device import nvidia_smi_lines  # noqa: E402

nz, ny, nx = 256, 64, 256
n = 2560
dx = 1.8 / nx
params = VirtualBoundaryForcingParams(
    virtual_boundary_stiffness_coeff=-2e5,
    virtual_boundary_damping_coeff=-1e2,
    grid_dim=3, dx=dx, eul_grid_coord_shift=dx / 2, interp_kernel_width=2,
    delta_kind="cosine",
)
state = VirtualBoundaryState(
    position_mismatch=jnp.zeros((3, n), jnp.float32), time=jnp.zeros(())
)
n_xyz = jnp.asarray([nx, ny, nz], jnp.int32)


def make_windowed(window):
    wz, wy, wx = window
    w_xyz = jnp.asarray([wx, wy, wz], jnp.int32)

    def windowed(lagp, vel):
        _, sidx, sdisp = nearest_grid_index_and_support(
            lagp, params.dx, params.eul_grid_coord_shift,
            params.interp_kernel_width)
        mins = sidx.min(axis=(1, 2))
        start = jnp.clip(mins - 2, 0, n_xyz - w_xyz)
        shifted = sidx - start[:, None, None]
        mats = axis_delta_weight_matrices(shifted, sdisp, params.dx, window,
                                          "cosine")
        zero = jnp.zeros((), start.dtype)
        win = jax.lax.dynamic_slice(
            vel, (zero, start[2], start[1], start[0]), (3, wz, wy, wx))
        return eulerian_to_lagrangian_interpolation_mm(win, mats, params.dx)

    return jax.jit(windowed)


def gathered(lagp, vel):
    lagv = jnp.zeros((3, n), jnp.float32)
    out = compute_interaction_force_on_lag_grid(state, vel, lagp, lagv,
                                                params)
    return out.flow_velocity


def ms_per_call(f, lagp, vel, reps=57):
    f(lagp, vel).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(reps):
        r = f(lagp, vel)
    r.block_until_ready()
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    print("; ".join(nvidia_smi_lines()), jax.devices()[0].device_kind,
          flush=True)
    rng = np.random.default_rng(0)
    vel = jnp.asarray(rng.standard_normal((3, nz, ny, nx)), jnp.float32)
    jg = jax.jit(gathered)
    for window in ((181, 64, 181), (128, 64, 128), (96, 48, 96),
                   (64, 32, 64), (32, 32, 32)):
        # markers fill a box whose support fits the window
        span = [(w - 8) * dx for w in window[::-1]]  # x, y, z extents
        pos = np.stack([
            rng.uniform(10 * dx, 10 * dx + s, n) for s in span
        ]).astype(np.float32)
        lagp = jnp.asarray(pos)
        jw = make_windowed(window)
        diff = float(jnp.abs(jw(lagp, vel) - jg(lagp, vel)).max())
        t = [ms_per_call(f, lagp, vel) for f in (jw, jg, jg, jw)]
        cells = int(np.prod(window))
        print(f"window {window} ({cells} cells), {n} markers: window_mm "
              f"{t[0]:.4f}/{t[3]:.4f} ms/call, gather {t[1]:.4f}/{t[2]:.4f} "
              f"ms/call; max diff {diff:.2e}", flush=True)


if __name__ == "__main__":
    main()
