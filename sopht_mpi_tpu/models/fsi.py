"""Fully on-device FSI stepping: the whole coupled loop under one jit.

The reference drives its FSI loop from Python - per flow step it substeps
PyElastica, refreshes the interactor and calls the MPI flow step
(/root/reference/examples/2d_examples/FlowPastRodCase/
flow_past_rod.py:276-300). Here the complete coupled iteration - CFL
timestep control, rod position-Verlet substeps with penalty flow forces,
IBM spreading, and the flow step - is a pure function scanned on device
(``lax.scan``), so a whole simulation window runs as ONE XLA program with
zero host round-trips.

Two builders:
- :func:`build_rigid_fsi_step`  - fixed/prescribed rigid body (cylinder,
  sphere): markers are constants per step.
- :func:`build_rod_fsi_step`    - two-way coupled Cosserat rod with a
  static number of rod substeps per flow step.

plus :func:`scan_steps` to roll any of them out on device.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from sopht_mpi_tpu.ops.virtual_boundary import (
    compute_interaction_force_on_eul_and_lag_grid,
    compute_interaction_force_on_lag_grid,
    virtual_boundary_time_step,
)

# substep_interp="auto" crossover: the windowed separable-matmul E->L
# costs O(n_markers * window_cells) MACs per substep while the plain XLA
# gather reads only n_markers * (2w)^3 cells of the (frozen) full field,
# independent of the window - so large enough windows favor the gather.
# Measured on one NVIDIA H100 80GB HBM3 at a 400 W power limit, 2560
# markers (doc/probe_e2l_substep_ab.py), ms per call, matmul vs gather:
# 2.1M-cell window (the (256, 64, 256) rod bench) 0.81-0.84 vs 0.10;
# 1.05M 0.41 vs 0.10-0.12; 442k 0.21 vs 0.08-0.10; 131k 0.10 vs 0.07-0.08;
# 33k 0.07-0.11 vs 0.09 (a tie within the noise). "auto" takes the gather
# from 100k cells up. The gather path is meshless-only (on a sharded
# field XLA would all-gather the operand per substep).
_GATHER_SUBSTEP_WINDOW_CELLS = 100_000


class RigidFSICarry(NamedTuple):
    flow_state: object
    vb_state: object
    velocity_mismatch: jax.Array  # from the previous step's interaction
    time: jax.Array
    # the Poisson solver's Fourier Green's function rides in the carry so
    # the (2N)^dim/2-sized array stays a traced argument instead of a
    # compiled-in constant; step functions return it unchanged
    greens: jax.Array = None
    # max |u|_1 of flow_state.velocity_field, carried so the CFL dt needs
    # no fresh velocity read
    velocity_l1_max: jax.Array = None
    # sparse-window mm-transfer path: per-axis delta weight matrices
    # (Az, Ay, Ax), each (n_markers, W_axis) - traced arrays (NOT jit
    # closure constants: the derived (n, Wz*Wy) combined matrix is ~100 MB
    # at 256^3 and must never be constant-folded into the program);
    # threaded unchanged through every step
    ibm_mats: tuple = None


class RodFSICarry(NamedTuple):
    flow_state: object
    vb_state: object
    rod_state: object
    time: jax.Array
    greens: jax.Array = None  # see RigidFSICarry.greens
    velocity_l1_max: jax.Array = None  # see RigidFSICarry
    # substep_load_refresh="flow_step" (opt-in approximation): (forces,
    # torques, velocity_mismatch) of the LAST full interaction, applied
    # frozen through the next step's rod substeps. None when the default
    # per-substep refresh (the reference's semantics) is on - None is an
    # empty pytree subtree, so existing carries keep their structure.
    frozen_loads: tuple | None = None


def velocity_l1_max(velocity_field):
    """The CFL control quantity ``max(sum_c |u_c|)``."""
    return jnp.max(jnp.sum(jnp.abs(velocity_field), axis=0))


def _canonicalize_carry_shardings(carry, mesh):
    """Pin every carry leaf that is not already mesh-addressed to the
    replicated ``NamedSharding`` over ``mesh`` - the sharding the step's
    outputs carry for such leaves under GSPMD.

    Without this, the init carry's scalar/marker leaves (vb_state, time,
    greens, ...) sit on ``SingleDeviceSharding`` while the step returns
    them as replicated ``NamedSharding``: the SECOND ``scan_steps`` call
    then sees different input shardings and silently RECOMPILES the whole
    program (measured as a phantom 38x 'per-step' cost on a (1,1) mesh
    before this fix)."""
    if mesh is None:
        return carry
    from jax.sharding import NamedSharding

    from sopht_mpi_tpu.parallel.mesh import replicated_sharding

    rep = replicated_sharding(mesh)

    def pin(leaf):
        if isinstance(leaf, jax.Array) and not isinstance(
            leaf.sharding, NamedSharding
        ):
            return jax.device_put(leaf, rep)
        return leaf

    return jax.tree_util.tree_map(pin, carry)


def _flow_dt_fn(flow_sim, dt_prefac):
    """dt from the carried ``max |u|_1`` - identical arithmetic to
    ``compute_stable_timestep_{2d,3d}`` on the same reduction."""
    from sopht_mpi_tpu.utils.types import get_test_tol

    CFL = flow_sim.CFL
    dx = flow_sim.dx
    nu = flow_sim.kinematic_viscosity
    tol = get_test_tol("single")
    dim = flow_sim.grid_dim
    real_t = flow_sim.real_t

    def flow_dt(l1_max):
        dt_advection = CFL * dx / (l1_max + tol)
        dt_diffusion = 0.9 * dx**2 / (2 * dim) / (nu + tol)
        return (
            jnp.minimum(dt_advection, dt_diffusion).astype(real_t) * dt_prefac
        )

    return flow_dt


def _static_rigid_forcing_window(lag_pos, params, grid_size):
    """Static ``(z0, z1, y0, y1, x0, x1)`` window covering the delta
    support of FIXED markers plus the forcing-curl reach, or None when the
    sparse path would not pay (window covering most of the domain) or
    would change boundary semantics (support + margin touching a wall).
    ``pad = 2``: curl support is delta-support +- 1, and the window's own
    curl ring zeroing then only ever touches cells whose curl is zero."""
    import numpy as np

    w = params.interp_kernel_width
    pos = np.asarray(lag_pos)
    nearest = np.floor(
        (pos - params.eul_grid_coord_shift) / params.dx
    ).astype(int)
    lo = nearest.min(axis=1) - (w - 1)
    hi = nearest.max(axis=1) + w
    pad = 2
    nz, ny, nx = (int(s) for s in grid_size)
    # marker components ordered (x, y, z); grid axes (z, y, x)
    x0, x1 = int(lo[0] - pad), int(hi[0] + pad + 1)
    y0, y1 = int(lo[1] - pad), int(hi[1] + pad + 1)
    z0, z1 = int(lo[2] - pad), int(hi[2] + pad + 1)
    if x0 < 0 or y0 < 0 or z0 < 0 or x1 > nx or y1 > ny or z1 > nz:
        return None  # wall-adjacent support: keep the dense path's clipping
    if (z1 - z0) * (y1 - y0) * (x1 - x0) >= 0.5 * nz * ny * nx:
        return None
    return z0, z1, y0, y1, x0, x1


def build_rigid_fsi_step(
    flow_sim,
    interactor,
    dt_prefac=0.5,
    free_stream_fn: Callable | None = None,
    sparse_forcing: bool | None = None,
):
    """One fused coupled step for a fixed rigid body.

    :param free_stream_fn: optional ``time -> (dim,) velocity`` (jnp-pure);
        defaults to the zero vector.
    :param sparse_forcing: apply the IBM forcing as a static sparse-window
        vorticity update (spread + curl on the support window only, flow
        stepped without the full-field forcing pass). The markers are
        build-time constants for a fixed rigid body, so the window is
        exact. None = auto (3D with an interior window; under a mesh the
        window work runs replicated - the marker math duplicates per
        device instead of the full-field forcing pass). The dense path stays the
        reference-shaped fallback (2D, wall-adjacent bodies). When the sparse path
        engages, the returned step has ``uses_sparse_forcing = True`` and a
        one-time log line records the window; pair it with
        ``init_rigid_fsi_carry(flow_sim, interactor, step)`` (passing the
        step!) so the carry drops the never-read full-field forcing leaf
        (1.6 GB of HBM at 512^3 otherwise held live through the scan).
    :returns: ``step(carry: RigidFSICarry) -> (carry, diagnostics)`` where
        diagnostics is the summed Lagrangian forcing (for e.g. drag).
    """
    params = interactor.params
    flow_step_l1 = flow_sim._step_l1_fn.__wrapped__
    lag_pos = interactor.forcing_grid.compute_lag_grid_position_field()
    lag_vel = interactor.forcing_grid.compute_lag_grid_velocity_field()
    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    dim = flow_sim.grid_dim

    window = None
    if (
        sparse_forcing is not False
        and dim == 3
        and flow_sim.flow_type == "navier_stokes_with_forcing"
        and hasattr(flow_sim, "_step_l1_noforcing_fn")
    ):
        window = _static_rigid_forcing_window(
            lag_pos, params, flow_sim.grid_size
        )
    if sparse_forcing is True and window is None:
        raise ValueError(
            "sparse_forcing=True requested but unsupported here (needs 3D "
            "navier_stokes_with_forcing and an interior window)"
        )
    if window is not None:
        from sopht_mpi_tpu.utils.logging_utils import logger

        logger.info(
            "build_rigid_fsi_step: sparse-window IBM forcing engaged "
            f"(window z{window[0]}:{window[1]} y{window[2]}:{window[3]} "
            f"x{window[4]}:{window[5]}); pass this step to "
            "init_rigid_fsi_carry(..., step=step) to also drop the unused "
            "full-field forcing buffer from the carry"
        )
        sparse_step = _build_rigid_fsi_step_sparse(
            flow_sim, interactor, window, lag_pos, lag_vel, flow_dt,
            free_stream_fn,
        )
        sparse_step.uses_sparse_forcing = True
        return sparse_step

    def step(carry: RigidFSICarry):
        """Reference per-iteration ordering (flow_past_sphere_case.py:
        193-199): integrate the mismatch with the PREVIOUS interaction's
        velocity mismatch, then compute the new interaction, then step
        the flow."""
        flow_state, vb_state, prev_mismatch, time, greens, u_l1, _ = carry
        dt = flow_dt(u_l1)
        vb_state = virtual_boundary_time_step(vb_state, prev_mismatch, dt)
        eul_forcing, interaction = compute_interaction_force_on_eul_and_lag_grid(
            vb_state,
            flow_state.eul_grid_forcing_field,
            flow_state.velocity_field,
            lag_pos,
            lag_vel,
            params,
            reset_eul_grid_forcing_field=True,
        )
        real_t = flow_state.velocity_field.dtype
        fsv = jnp.asarray(
            free_stream_fn(time)
            if free_stream_fn is not None
            else jnp.zeros(dim, real_t),
            real_t,
        )
        flow_state = flow_state._replace(eul_grid_forcing_field=eul_forcing)
        flow_state, new_l1 = flow_step_l1(flow_state, dt, fsv, greens)
        lag_force_sum = jnp.sum(interaction.lag_forcing, axis=1)
        new_carry = RigidFSICarry(
            flow_state, vb_state, interaction.velocity_mismatch, time + dt,
            greens, new_l1 if new_l1 is not None else u_l1,
        )
        return new_carry, lag_force_sum

    return step


def _build_rigid_fsi_step_sparse(
    flow_sim, interactor, window, lag_pos, lag_vel, flow_dt, free_stream_fn
):
    """Sparse-window variant of the rigid FSI step: the IBM spread and the
    forcing curl act on the static support window only, and the flow
    advances through the no-forcing step (mathematically identical - the
    forcing curl commutes into a windowed vorticity add; forcing is zero
    outside the window by construction).

    Both transfer directions run on the separable-matmul path
    (ops/ibm.py axis_delta_weight_matrices + *_mm): for fixed markers the
    per-axis weight matrices are build-time data, carried as traced arrays
    (RigidFSICarry.ibm_mats) so the ~100 MB combined (n, Wz*Wy) matrix is
    computed on device and never becomes a compiled-in constant.

    Under a mesh the window work runs REPLICATED (the reference's
    Lagrangian posture, SURVEY section 7): every device does the identical
    marker math. The path pays no window-sized collective: the E->L
    velocity interpolation
    contracts shard-local field blocks and psums only the (3, n_markers)
    result (parallel.windows.windowed_e2l_mm_sharded; ~55 KB vs the
    ~4.5 MB window all-gather at 256^3), and the windowed vorticity add
    is a collective-free masked local add (add_window_into_field) instead
    of gather-window + dynamic_update_slice. This replaces the dense
    full-field forcing pass."""
    from sopht_mpi_tpu.ops.ibm import (
        axis_delta_weight_matrices,
        eulerian_to_lagrangian_interpolation_mm,
        lagrangian_to_eulerian_spread_mm,
        nearest_grid_index_and_support,
    )
    from sopht_mpi_tpu.ops.stencils_3d import curl_3d
    from sopht_mpi_tpu.ops.virtual_boundary import compute_penalty_force

    params = interactor.params
    flow_step_l1 = flow_sim._step_l1_noforcing_fn.__wrapped__
    z0, z1, y0, y1, x0, x1 = window
    dim = 3
    dx = params.dx
    wshape = (z1 - z0, y1 - y0, x1 - x0)

    mesh = flow_sim.mesh
    start_xyz = jnp.asarray([x0, y0, z0], jnp.int32)
    if mesh is not None:
        from sopht_mpi_tpu.parallel.windows import (
            add_window_into_field,
            windowed_e2l_mm_sharded,
        )

        def _e2l(velocity_field, mats):
            return windowed_e2l_mm_sharded(
                velocity_field, mats, start_xyz, wshape, dx, mesh
            )

        def _windowed_add(field, curl_win):
            return add_window_into_field(field, curl_win, start_xyz, mesh)
    else:

        def _e2l(velocity_field, mats):
            return eulerian_to_lagrangian_interpolation_mm(
                jax.lax.slice(
                    velocity_field, (0, z0, y0, x0), (3, z1, y1, x1)
                ),
                mats,
                dx,
            )

        def _windowed_add(field, curl_win):
            return jax.lax.dynamic_update_slice(
                field,
                jax.lax.slice(field, (0, z0, y0, x0), (3, z1, y1, x1))
                + curl_win,
                (0, z0, y0, x0),
            )

    # build-time (host/eager) A-matrix computation from the constant
    # markers; init_rigid_fsi_carry uploads these into the carry
    import numpy as np

    _, support_idx, support_disp = nearest_grid_index_and_support(
        jnp.asarray(lag_pos), dx, params.eul_grid_coord_shift,
        params.interp_kernel_width,
    )
    shifted_idx = support_idx - jnp.asarray(
        [x0, y0, z0], support_idx.dtype
    ).reshape(3, 1, 1)
    mats_np = tuple(
        np.asarray(m)
        for m in axis_delta_weight_matrices(
            shifted_idx, support_disp, dx, wshape, params.delta_kind
        )
    )

    def step(carry: RigidFSICarry):
        flow_state, vb_state, prev_mismatch, time, greens, u_l1, mats = carry
        if mats is None:
            raise ValueError(
                "sparse rigid FSI step needs the mm weight matrices in the "
                "carry - build the carry with init_rigid_fsi_carry("
                "flow_sim, interactor, step) passing THIS step"
            )
        dt = flow_dt(u_l1)
        vb_state = virtual_boundary_time_step(vb_state, prev_mismatch, dt)
        real_t = flow_state.velocity_field.dtype
        # E->L velocity interpolation: windowed separable matmuls (under a
        # mesh: shard-local block contraction, one (3, n) psum - the
        # marker math downstream runs identically on every chip, the
        # reference's posture)
        flow_velocity = _e2l(flow_state.velocity_field, mats)
        velocity_mismatch = flow_velocity - lag_vel
        lag_forcing = compute_penalty_force(
            vb_state.position_mismatch, velocity_mismatch, params
        )
        # L->E spread into the window, curl, and one windowed vorticity add
        win = jnp.zeros((3,) + wshape, real_t)
        win = lagrangian_to_eulerian_spread_mm(win, lag_forcing, mats)
        pref = jnp.asarray(dt / (2.0 * dx), real_t)
        curl_win = curl_3d(win, pref)
        field = _windowed_add(flow_state.primary_field, curl_win)
        fsv = jnp.asarray(
            free_stream_fn(time)
            if free_stream_fn is not None
            else jnp.zeros(dim, real_t),
            real_t,
        )
        flow_state = flow_state._replace(primary_field=field)
        flow_state, new_l1 = flow_step_l1(flow_state, dt, fsv, greens)
        lag_force_sum = jnp.sum(lag_forcing, axis=1)
        new_carry = RigidFSICarry(
            flow_state, vb_state, velocity_mismatch, time + dt,
            greens, new_l1 if new_l1 is not None else u_l1, mats,
        )
        return new_carry, lag_force_sum

    step.ibm_mats_np = mats_np
    return step


def init_rigid_fsi_carry(flow_sim, interactor, step=None) -> RigidFSICarry:
    """Initial carry matching a fresh interactor (zero mismatch).

    Pass the built ``step`` to let the carry drop what that step never
    reads: the sparse-forcing step ignores the full-field
    ``eul_grid_forcing_field``, so its leaf shrinks to a zero-size
    placeholder (1.6 GB of HBM at 512^3 float32 otherwise held live
    through the scan)."""
    flow_state = flow_sim._get_state()
    if getattr(step, "uses_sparse_forcing", False):
        flow_state = flow_state._replace(
            eul_grid_forcing_field=jnp.zeros(
                (flow_state.eul_grid_forcing_field.shape[0],) + (0,)
                * (flow_state.eul_grid_forcing_field.ndim - 1),
                flow_state.eul_grid_forcing_field.dtype,
            )
        )
    mats_np = getattr(step, "ibm_mats_np", None)
    carry = RigidFSICarry(
        flow_state=flow_state,
        vb_state=interactor.state,
        velocity_mismatch=jnp.zeros_like(interactor.state.position_mismatch),
        time=jnp.asarray(flow_sim.time, flow_sim.real_t),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=velocity_l1_max(flow_sim.velocity_field),
        ibm_mats=(
            None
            if mats_np is None
            else tuple(jnp.asarray(m) for m in mats_np)
        ),
    )
    return _canonicalize_carry_shardings(carry, flow_sim.mesh)


def _sparse_window_tools(flow_sim, params, wshape):
    """The moving-window machinery shared by the sparse rod and sparse
    multi-body FSI paths: for a static ``(Wz, Wy, Wx)`` window tracking a
    body's marker support, returns

    - ``window_mats(lagp) -> (start, axis_mats, ok)`` - dynamic window
      start (component order x, y, z), per-axis mm weight matrices in
      window coordinates, and the validity flag (support >= 2 cells inside
      the window per side, or the window flush with the domain wall there
      so clipping semantics coincide with the dense path's);
    - ``e2l_interp(field, start, mats)`` - the E->L separable-matmul
      interpolation of a grid vector field over the window (meshless:
      ``dynamic_slice`` + mm; under a mesh: shard-local block contraction
      + one (c, n_markers) psum - NO window-sized collective, VERDICT r04
      next #1a - while the rest of the marker math runs REPLICATED per
      chip, the reference's Lagrangian posture: O(markers) per rank at
      any rank count, VirtualBoundaryForcingMPI.py:333-429);
    - ``windowed_add(field, win, start)`` - add a window into the grid
      field (collective-free masked local add under a mesh).
    """
    from sopht_mpi_tpu.ops.ibm import (
        axis_delta_weight_matrices,
        nearest_grid_index_and_support,
    )

    Wz, Wy, Wx = (int(w) for w in wshape)
    nz, ny, nx = flow_sim.grid_size
    if Wz > nz or Wy > ny or Wx > nx:
        raise ValueError(
            f"sparse forcing window {wshape} exceeds the grid "
            f"{flow_sim.grid_size}"
        )
    n_xyz_arr = jnp.asarray([nx, ny, nz], jnp.int32)
    w_xyz_arr = jnp.asarray([Wx, Wy, Wz], jnp.int32)
    mesh = flow_sim.mesh

    def window_mats(lagp):
        _, support_idx, support_disp = nearest_grid_index_and_support(
            lagp, params.dx, params.eul_grid_coord_shift,
            params.interp_kernel_width,
        )
        mins = support_idx.min(axis=(1, 2))  # (3,) components x, y, z
        maxs = support_idx.max(axis=(1, 2))
        start = jnp.clip(mins - 2, 0, n_xyz_arr - w_xyz_arr)
        lo_ok = (start == 0) | (mins - start >= 2)
        hi_ok = (start + w_xyz_arr == n_xyz_arr) | (
            maxs - start <= w_xyz_arr - 3
        )
        ok = jnp.all(lo_ok & hi_ok)
        shifted = support_idx - start[:, None, None]
        mats = axis_delta_weight_matrices(
            shifted, support_disp, params.dx, (Wz, Wy, Wx),
            params.delta_kind,
        )
        return start, mats, ok

    if mesh is not None:
        # under a mesh GSPMD would all-gather the WHOLE field for a
        # traced-start dynamic_slice of a sharded operand; the masked
        # shard_map primitives touch only each shard's overlap, and the
        # E->L side psums only the (c, n_markers) result
        from sopht_mpi_tpu.parallel.windows import (
            add_window_into_field,
            windowed_e2l_mm_sharded,
        )

        def e2l_interp(field, start, mats):
            return windowed_e2l_mm_sharded(
                field, mats, start, (Wz, Wy, Wx), params.dx, mesh
            )

        def windowed_add(field, win, start):
            return add_window_into_field(field, win, start, mesh)

    else:
        from sopht_mpi_tpu.ops.ibm import (
            eulerian_to_lagrangian_interpolation_mm,
        )

        def e2l_interp(field, start, mats):
            zero = jnp.zeros((), start.dtype)
            win = jax.lax.dynamic_slice(
                field, (zero, start[2], start[1], start[0]), (3, Wz, Wy, Wx)
            )
            return eulerian_to_lagrangian_interpolation_mm(
                win, mats, params.dx
            )

        def windowed_add(field, win, start):
            zero = jnp.zeros((), start.dtype)
            starts = (zero, start[2], start[1], start[0])
            return jax.lax.dynamic_update_slice(
                field,
                jax.lax.dynamic_slice(field, starts, (3, Wz, Wy, Wx)) + win,
                starts,
            )

    return window_mats, e2l_interp, windowed_add


def build_rod_fsi_step(
    flow_sim,
    interactor,
    rod_collection,
    rod_substeps: int | None = None,
    dt_prefac=0.5,
    free_stream_fn: Callable | None = None,
    *,
    rod_dt: float | None = None,
    max_rod_substeps: int | None = None,
    sparse_forcing_window: tuple[int, int, int] | None = None,
    substep_load_refresh: str = "every",
    substep_interp: str = "auto",
):
    """One fused coupled step for a two-way coupled Cosserat rod.

    Mirrors the reference loop (flow_past_rod.py:276-300): per flow step,
    the rod takes position-Verlet substeps; then the full penalty
    interaction runs, the summed Lagrangian forcing is spread onto the
    Eulerian forcing field (or its windowed curl adds straight into the
    vorticity on the sparse path) and the flow advances.

    ``substep_load_refresh`` controls what the SUBSTEPS see:

    - ``"every"`` (default, the REFERENCE's semantics): each substep
      recomputes the penalty flow loads at the current rod state from
      the frozen flow velocity - the reference's ``FlowForces`` calls
      ``compute_flow_forces_and_torques`` (a full
      ``compute_interaction_on_lag_grid``) inside every PyElastica
      substep (immersed_body_flow_interaction_mpi.py:168-175); every
      parity oracle in tests/ pins this mode bit-exactly;
    - ``"flow_step"`` (opt-in APPROXIMATION, NOT the reference's
      semantics): the substeps apply the loads of the last full
      interaction, frozen - an O(flow_dt) lag in the forcing term, in
      exchange for removing the O(substeps) per-step marker work
      (~19 substeps/flow step at the (256, 64, 256) rod benchmark; under
      a mesh it also removes the O(substeps) per-step psums). Validate
      the observable you care about before adopting it; pair with
      ``init_rod_fsi_carry(..., step=step)`` so the carry gains the
      zero-initialized frozen-loads leaves.

    Substep control, two modes:

    - static (``rod_substeps=k``): exactly ``k`` substeps per flow step
      (the scan length) - choose ``ceil(expected_flow_dt / rod_dt)``;
    - dynamic (``rod_dt=...``): the reference's per-step count
      ``int(flow_dt / min(flow_dt, rod_dt))`` (flow_past_rod.py:278-279),
      computed in-trace from the CFL flow dt. The scan runs a static
      number of iterations and masks out those beyond the active count;
      the rod work is O(markers), tiny next to the flow step, so the idle
      iterations cost little. The static scan length defaults to
      ``ceil(flow_sim.diffusion_limited_timestep(dt_prefac) / rod_dt) + 2``
      - an upper bound on the demand, so the in-trace count can NEVER
      clamp (clamping would make sub_dt exceed rod_dt and can destabilize
      stiff rods); ``max_rod_substeps`` overrides it at your own risk.

    The rod must be the only system in ``rod_collection``, already
    ``finalize()``-d, with the ``FlowForces`` coupling NOT registered (the
    flow forces are computed in-trace here).

    ``sparse_forcing_window`` (opt-in, 3D; meshless or sharded): static
    ``(Wz, Wy, Wx)`` cell counts - the IBM spread + forcing curl then act
    on a MOVING window of that size tracking the marker support. Under a
    mesh the window work runs replicated per chip and only the two
    sharded-grid touches (velocity-window gather, windowed vorticity add)
    go through :mod:`sopht_mpi_tpu.parallel.windows`
    (:func:`suggest_rod_forcing_window` sizes it from the current rod
    extent). The flow advances through the no-forcing step. Because the
    markers move, the step's diagnostic becomes ``(lag_force_sum,
    window_ok)``: ``window_ok`` is False on any step whose support did not
    fit the window (forcing then clipped - enlarge the window). Check it
    at scan-window boundaries.

    ``substep_interp`` picks how the SUBSTEPS' E->L velocity
    interpolation runs on the sparse path (the flow velocity is frozen
    during the substeps, so this is a pure perf choice - both produce the
    delta-kernel weights at the current rod positions, identical modulo
    float summation order): ``"window_mm"`` = the windowed separable
    matmul (O(n * window_cells) per substep; the only option under a
    mesh, where it is the collective-lean shard-local contraction);
    ``"gather"`` = plain XLA gather of each marker's (2w)^dim support
    from the full field (window-size independent; meshless only);
    ``"auto"`` (default) = gather when meshless and the window has >=
    ``_GATHER_SUBSTEP_WINDOW_CELLS`` cells. The post-substep spread is
    always the windowed mm (ibm.py axis_delta_weight_matrices).
    """
    if substep_interp not in ("auto", "window_mm", "gather"):
        raise ValueError(
            "substep_interp must be 'auto', 'window_mm' or 'gather', got "
            f"{substep_interp!r}"
        )
    if substep_load_refresh not in ("every", "flow_step"):
        raise ValueError(
            "substep_load_refresh must be 'every' or 'flow_step', got "
            f"{substep_load_refresh!r}"
        )
    frozen_mode = substep_load_refresh == "flow_step"
    dynamic = rod_substeps is None
    if dynamic and rod_dt is None:
        raise ValueError(
            "pass either rod_substeps (static) or rod_dt (dynamic)"
        )
    if not dynamic and (rod_dt is not None or max_rod_substeps is not None):
        raise ValueError(
            "rod_substeps (static mode) conflicts with rod_dt/"
            "max_rod_substeps (dynamic mode) - pass one or the other"
        )
    if dynamic and max_rod_substeps is None:
        import math

        max_rod_substeps = (
            math.ceil(flow_sim.diffusion_limited_timestep(dt_prefac) / rod_dt)
            + 2
        )
    assert rod_collection._finalized
    assert len(rod_collection._systems) == 1
    rod = rod_collection._systems[0]
    rod_step = rod_collection._step_fns[0].__wrapped__
    grid = interactor.forcing_grid
    params = interactor.params
    flow_step_l1 = flow_sim._step_l1_fn.__wrapped__
    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    dim = flow_sim.grid_dim

    sparse = sparse_forcing_window is not None
    if sparse:
        if dim != 3 or not hasattr(flow_sim, "_step_l1_noforcing_fn"):
            raise ValueError(
                "sparse_forcing_window needs a 3D "
                "navier_stokes_with_forcing simulator"
            )
        Wz, Wy, Wx = (int(w) for w in sparse_forcing_window)
        flow_step_l1 = flow_sim._step_l1_noforcing_fn.__wrapped__
        if substep_interp == "gather" and flow_sim.mesh is not None:
            raise ValueError(
                "substep_interp='gather' needs an unsharded simulator "
                "(XLA would all-gather the sharded velocity field per "
                "substep gather); use 'window_mm' or 'auto' under a mesh"
            )
        gather_substeps = substep_interp == "gather" or (
            substep_interp == "auto"
            and flow_sim.mesh is None
            and Wz * Wy * Wx >= _GATHER_SUBSTEP_WINDOW_CELLS
        )
    else:
        gather_substeps = False

    def rod_flow_loads(rod_state, vb_state, velocity_field):
        interaction = compute_interaction_force_on_lag_grid(
            vb_state,
            velocity_field,
            grid.lag_positions(rod_state),
            grid.lag_velocities(rod_state),
            params,
        )
        forces, torques = grid.body_loads(rod_state, interaction.lag_forcing)
        return forces, torques, interaction.velocity_mismatch

    if sparse:
        from sopht_mpi_tpu.ops.virtual_boundary import compute_penalty_force

        window_mats, e2l_interp, windowed_add = _sparse_window_tools(
            flow_sim, params, (Wz, Wy, Wx)
        )

        def rod_flow_loads_windowed(rod_state, vb_state, velocity_field):
            """Same loads as rod_flow_loads, but the E->L velocity gather
            reads only the moving support window via the separable-matmul
            path (the other half of the large-marker-count cost)."""
            lagp = grid.lag_positions(rod_state)
            start, mats, ok = window_mats(lagp)
            flow_velocity = e2l_interp(velocity_field, start, mats)
            mismatch = flow_velocity - grid.lag_velocities(rod_state)
            lag_forcing = compute_penalty_force(
                vb_state.position_mismatch, mismatch, params
            )
            forces, torques = grid.body_loads(rod_state, lag_forcing)
            return forces, torques, mismatch, ok

    def step(carry: RodFSICarry):
        (flow_state, vb_state, rod_state, time, greens, u_l1,
         frozen) = carry
        if frozen_mode and frozen is None:
            raise ValueError(
                "substep_load_refresh='flow_step' needs the frozen-loads "
                "carry leaves - build the carry with init_rod_fsi_carry("
                "flow_sim, interactor, rod, step) passing THIS step"
            )
        dt = flow_dt(u_l1)
        real_t = flow_state.velocity_field.dtype
        if dynamic:
            # reference: int(flow_dt / min(flow_dt, rod_dt)), >= 1
            n_raw = jnp.floor(dt / jnp.minimum(dt, rod_dt)).astype(jnp.int32)
            # The scan length is static, so a demand beyond max_rod_substeps
            # must clamp - making sub_dt exceed rod_dt, which can
            # destabilize the rod. Choose max_rod_substeps with margin over
            # ceil(max expected flow_dt / rod_dt). (An in-trace warning via
            # jax.debug.print would add a host callback to every step.)
            n_sub = jnp.clip(n_raw, 1, max_rod_substeps)
            scan_length = max_rod_substeps
        else:
            n_sub = jnp.asarray(rod_substeps, jnp.int32)
            scan_length = rod_substeps
        sub_dt = dt / n_sub.astype(dt.dtype)

        def substep(c, i):
            def active(c):
                rod_state, vb_state, t, ok = c
                if frozen_mode:
                    # opt-in approximation: substeps apply the LAST full
                    # interaction's loads, frozen (O(flow_dt) forcing lag)
                    forces, torques, mismatch = frozen
                elif sparse and not gather_substeps:
                    forces, torques, mismatch, sub_ok = (
                        rod_flow_loads_windowed(
                            rod_state, vb_state, flow_state.velocity_field
                        )
                    )
                    ok = ok & sub_ok
                else:
                    forces, torques, mismatch = rod_flow_loads(
                        rod_state, vb_state, flow_state.velocity_field
                    )
                rod_state = rod_step(
                    rod_state,
                    t.astype(rod_state.position.dtype),
                    sub_dt.astype(rod_state.position.dtype),
                    forces.astype(rod_state.position.dtype),
                    torques.astype(rod_state.position.dtype),
                )
                vb_state = virtual_boundary_time_step(
                    vb_state, mismatch, sub_dt
                )
                return (rod_state, vb_state, t + sub_dt, ok)

            c = jax.lax.cond(i < n_sub, active, lambda c: c, c) \
                if dynamic else active(c)
            return c, None

        (rod_state, vb_state, _, substeps_ok), _ = jax.lax.scan(
            substep,
            (rod_state, vb_state, time, jnp.asarray(True)),
            jnp.arange(scan_length, dtype=jnp.int32),
        )

        lagp = grid.lag_positions(rod_state)
        if sparse:
            from sopht_mpi_tpu.ops.ibm import (
                lagrangian_to_eulerian_spread_mm,
            )
            from sopht_mpi_tpu.ops.stencils_3d import curl_3d

            # windowed mm interaction at the POST-substep state (the last
            # substep's gather ran at the pre-substep positions, so the
            # window/weight math here is a genuine recompute - O(n * W)
            # one-hot builds, small next to the windowed transfer itself)
            start, mats, window_ok = window_mats(lagp)
            window_ok = window_ok & substeps_ok
            flow_velocity = e2l_interp(
                flow_state.velocity_field, start, mats
            )
            velocity_mismatch = (
                flow_velocity - grid.lag_velocities(rod_state)
            )
            lag_forcing = compute_penalty_force(
                vb_state.position_mismatch, velocity_mismatch, params
            )
            if frozen_mode:
                nf, nt = grid.body_loads(rod_state, lag_forcing)
                frozen = (nf, nt, velocity_mismatch)
            win = jnp.zeros((3, Wz, Wy, Wx), real_t)
            win = lagrangian_to_eulerian_spread_mm(win, lag_forcing, mats)
            curl_win = curl_3d(win, jnp.asarray(dt / (2.0 * params.dx), real_t))
            flow_state = flow_state._replace(
                primary_field=windowed_add(
                    flow_state.primary_field, curl_win, start
                )
            )
        else:
            eul_forcing, interaction = compute_interaction_force_on_eul_and_lag_grid(
                vb_state,
                flow_state.eul_grid_forcing_field,
                flow_state.velocity_field,
                lagp,
                grid.lag_velocities(rod_state),
                params,
                reset_eul_grid_forcing_field=True,
            )
            lag_forcing = interaction.lag_forcing
            if frozen_mode:
                nf, nt = grid.body_loads(rod_state, lag_forcing)
                frozen = (nf, nt, interaction.velocity_mismatch)
            flow_state = flow_state._replace(
                eul_grid_forcing_field=eul_forcing
            )
        fsv = (
            free_stream_fn(time)
            if free_stream_fn is not None
            else jnp.zeros(dim, real_t)
        )
        flow_state, new_l1 = flow_step_l1(
            flow_state, dt, jnp.asarray(fsv, real_t), greens
        )
        lag_force_sum = jnp.sum(lag_forcing, axis=1)
        return (
            RodFSICarry(
                flow_state, vb_state, rod_state, time + dt, greens,
                new_l1 if new_l1 is not None else u_l1,
                frozen if frozen_mode else None,
            ),
            (lag_force_sum, window_ok) if sparse else lag_force_sum,
        )

    step.uses_frozen_loads = frozen_mode
    if frozen_mode:
        def _frozen_loads_template(rod_state, vb_state, velocity_field):
            # exactly the shapes/dtypes the step's final interaction
            # stores as frozen loads (init_rod_fsi_carry eval_shapes this
            # to build the zero-initialized leaves - the reference's
            # FlowForces start at zero)
            if sparse:
                f, t, m, _ = rod_flow_loads_windowed(
                    rod_state, vb_state, velocity_field
                )
            else:
                f, t, m = rod_flow_loads(
                    rod_state, vb_state, velocity_field
                )
            return f, t, m

        step._frozen_loads_template = _frozen_loads_template
    return step


class RodBody(NamedTuple):
    """Multi-body spec: a two-way coupled Cosserat rod.

    ``rod_collection`` must be finalized and contain exactly this one rod
    (use one collection per rod; several rods = several RodBody entries).
    The ``FlowForces`` coupling must NOT be registered - flow loads are
    computed in-trace."""

    interactor: object  # CosseratRodFlowInteraction
    rod_collection: object  # BaseSystemCollection with one finalized rod


class DynamicRigidBody(NamedTuple):
    """Multi-body spec: a two-way coupled rigid body with dynamics.

    ``rigid_body`` must carry ``mass``/``inertia_body`` (constructed with a
    ``density``). ``load_fn(state, time) -> (force (3,), torque (3,))``
    adds user loads (gravity/buoyancy) on top of the flow loads."""

    interactor: object  # RigidBodyFlowInteraction
    rigid_body: object
    load_fn: Callable | None = None


class FixedRigidBody(NamedTuple):
    """Multi-body spec: a fixed (or externally prescribed constant-state)
    rigid body; markers are build-time constants."""

    interactor: object  # RigidBodyFlowInteraction


class MultiBodyFSICarry(NamedTuple):
    flow_state: object
    body_states: tuple  # per body: RodState | RigidBodyState | None (fixed)
    vb_states: tuple  # per body VirtualBoundaryState
    prev_mismatches: tuple  # per body; consumed by FixedRigidBody entries
    time: jax.Array
    greens: jax.Array = None  # see RigidFSICarry.greens
    velocity_l1_max: jax.Array = None  # see RigidFSICarry
    # substep_load_refresh="flow_step" (opt-in approximation; see
    # RodFSICarry.frozen_loads): per-body (forces, torques, mismatch) of
    # the last full interaction (None entries for fixed bodies); None
    # when the default per-substep refresh is on
    frozen_loads: tuple | None = None


def build_multi_body_fsi_step(
    flow_sim,
    bodies,
    dt_prefac=0.5,
    free_stream_fn: Callable | None = None,
    substeps: int | None = None,
    *,
    sub_dt: float | None = None,
    max_substeps: int | None = None,
    sparse_forcing: bool | None = None,
    substep_load_refresh: str = "every",
    substep_interp: str = "auto",
):
    """One fused coupled step for ANY mix of immersed bodies: Cosserat
    rods, dynamic rigid bodies, fixed rigid bodies (BASELINE config 5,
    "3D mixed soft/rigid bodies").

    Mirrors the reference's composed driver loops, where N interactors
    each accumulate onto the shared ``eul_grid_forcing_field`` before the
    flow step (the stacked-interactor pattern of
    /root/reference/examples/3d_examples/FlowPastRodCase/
    flow_past_rod_case.py:129-152 and flow_past_cylinder.py:149-155):

    - per flow step, ALL substepped bodies (rods + dynamic rigid) take the
      same ``n_sub`` substeps - each substep computes penalty flow loads
      from the frozen flow velocity at the current body state, advances the
      body (rod position-Verlet / rigid position-Verlet) and integrates
      that body's IBM position mismatch - exactly PyElastica stepping the
      whole system collection together;
    - fixed bodies integrate their mismatch once per flow step with the
      PREVIOUS interaction's velocity mismatch (the
      ``interactor.time_step(dt); interactor()`` ordering of the reference
      examples and :func:`build_rigid_fsi_step`);
    - every body's penalty forcing then spreads onto ONE shared Eulerian
      forcing field (reset once, accumulated across bodies), and the flow
      advances.

    NOTE: the mismatch-integrate / interact / flow-step ordering contract
    above is implemented independently here and in
    :func:`build_rigid_fsi_step` / :func:`build_rod_fsi_step` (whose carry
    types and sparse-window fast paths are public API and do not transfer
    1:1); any change to the ordering must be applied to all three, and the
    bit-parity oracles (test_fsi_scan.py::
    test_multi_body_single_fixed_matches_rigid_builder and
    ::test_multi_body_rod_plus_cylinder_matches_host_loop) are the guard.

    Substep control matches :func:`build_rod_fsi_step`: static
    (``substeps=k``) or dynamic (``sub_dt=...`` + optional
    ``max_substeps``); with no substepped bodies both may be omitted.
    ``substep_interp`` also matches :func:`build_rod_fsi_step`, applied
    per body ("auto" flips each body independently by ITS window size -
    typically the rods' reach windows gather while compact rigid-body
    windows keep the mm).

    ``sparse_forcing`` (round 5): per-BODY sparse IBM forcing windows.
    None = auto - on a 3D ``navier_stokes_with_forcing`` simulator
    (meshless or sharded), when EVERY body gets a support window under
    70% of the grid (:func:`suggest_rod_forcing_window` /
    :func:`suggest_rigid_forcing_window`), each body's spread + forcing
    curl act on its own moving window and the windowed curls add straight
    into the vorticity (curl is linear - overlapping windows compose
    exactly); the flow then advances through the no-forcing step. True
    requires it (raises if unsupported); False forces the dense
    reference-shaped shared-forcing-field path. When sparse engages, the
    step gets ``uses_sparse_forcing = True`` (pair with
    ``init_multi_body_fsi_carry(flow_sim, bodies, step)`` to drop the
    unused full-field forcing leaf) and the diagnostics become
    ``(lag_force_sums, windows_ok)``; check ``windows_ok`` at scan-window
    boundaries as with the rod builder.

    :returns: ``step(carry: MultiBodyFSICarry) -> (carry, lag_force_sums)``
        with ``lag_force_sums`` a per-body tuple of (grid_dim,) summed
        Lagrangian forcing (see ``sparse_forcing`` for the sparse-path
        diagnostics shape).
    """
    from sopht_mpi_tpu.models.rigid_body import (
        rigid_body_position_verlet_step,
    )

    bodies = tuple(bodies)
    if not bodies:
        raise ValueError("bodies must be non-empty")
    if substep_interp not in ("auto", "window_mm", "gather"):
        raise ValueError(
            "substep_interp must be 'auto', 'window_mm' or 'gather', got "
            f"{substep_interp!r}"
        )
    if substep_load_refresh not in ("every", "flow_step"):
        raise ValueError(
            "substep_load_refresh must be 'every' or 'flow_step', got "
            f"{substep_load_refresh!r}"
        )
    frozen_mode = substep_load_refresh == "flow_step"
    substepped = [
        isinstance(b, (RodBody, DynamicRigidBody)) for b in bodies
    ]
    any_sub = any(substepped)
    dynamic = substeps is None and sub_dt is not None
    if any_sub and substeps is None and sub_dt is None:
        substeps = 1
    if substeps is not None and (sub_dt is not None or max_substeps is not None):
        raise ValueError(
            "substeps (static mode) conflicts with sub_dt/max_substeps "
            "(dynamic mode) - pass one or the other"
        )
    if dynamic and max_substeps is None:
        import math

        max_substeps = (
            math.ceil(
                flow_sim.diffusion_limited_timestep(dt_prefac) / sub_dt
            )
            + 2
        )

    rod_steps = {}
    for i, spec in enumerate(bodies):
        if isinstance(spec, RodBody):
            assert spec.rod_collection._finalized
            assert len(spec.rod_collection._systems) == 1, (
                "one rod per RodBody/collection; use several RodBody "
                "entries for several rods"
            )
            rod_steps[i] = spec.rod_collection._step_fns[0].__wrapped__
        elif isinstance(spec, DynamicRigidBody):
            if not hasattr(spec.rigid_body, "mass"):
                raise ValueError(
                    "DynamicRigidBody needs a rigid body constructed with "
                    "a density (mass/inertia_body)"
                )

    flow_step_l1 = flow_sim._step_l1_fn.__wrapped__
    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    dim = flow_sim.grid_dim
    # fixed bodies: markers are constants
    fixed_lag = {
        i: (
            spec.interactor.forcing_grid.compute_lag_grid_position_field(),
            spec.interactor.forcing_grid.compute_lag_grid_velocity_field(),
        )
        for i, spec in enumerate(bodies)
        if isinstance(spec, FixedRigidBody)
    }

    # ---- per-body sparse forcing windows (round 5; BASELINE config 5
    # perf): curl is linear, so each body's windowed forcing-curl adds
    # into the vorticity independently - overlapping windows compose
    # exactly - and the flow advances through the no-forcing step ----
    body_windows = None
    if (
        sparse_forcing is not False
        and dim == 3
        and hasattr(flow_sim, "_step_l1_noforcing_fn")
    ):
        wins = []
        for spec in bodies:
            if isinstance(spec, RodBody):
                wins.append(
                    suggest_rod_forcing_window(
                        spec.interactor,
                        spec.rod_collection._systems[0],
                        flow_sim.grid_size,
                    )
                )
            else:
                wins.append(
                    suggest_rigid_forcing_window(
                        spec.interactor, flow_sim.grid_size
                    )
                )
        if all(w is not None for w in wins):
            body_windows = tuple(wins)
    if sparse_forcing is True and body_windows is None:
        raise ValueError(
            "sparse_forcing=True requested but unsupported here (needs a "
            "3D navier_stokes_with_forcing simulator and per-body support "
            "windows each under 70% of the grid)"
        )
    sparse = body_windows is not None
    if substep_interp == "gather" and sparse and flow_sim.mesh is not None:
        raise ValueError(
            "substep_interp='gather' needs an unsharded simulator "
            "(XLA would all-gather the sharded velocity field per "
            "substep gather); use 'window_mm' or 'auto' under a mesh"
        )
    # per-BODY substep E->L choice (same crossover as build_rod_fsi_step:
    # a small rigid-body window keeps the mm, a rod-reach window flips to
    # the gather); spread stays windowed-mm either way
    gather_sub = tuple(
        sparse
        and (
            substep_interp == "gather"
            or (
                substep_interp == "auto"
                and flow_sim.mesh is None
                and body_windows[i][0] * body_windows[i][1]
                * body_windows[i][2] >= _GATHER_SUBSTEP_WINDOW_CELLS
            )
        )
        for i in range(len(bodies))
    )
    if sparse:
        from sopht_mpi_tpu.ops.ibm import lagrangian_to_eulerian_spread_mm
        from sopht_mpi_tpu.ops.stencils_3d import curl_3d
        from sopht_mpi_tpu.ops.virtual_boundary import compute_penalty_force
        from sopht_mpi_tpu.utils.logging_utils import logger

        flow_step_l1 = flow_sim._step_l1_noforcing_fn.__wrapped__
        body_tools = tuple(
            _sparse_window_tools(flow_sim, spec.interactor.params, w)
            for spec, w in zip(bodies, body_windows)
        )
        logger.info(
            "build_multi_body_fsi_step: per-body sparse-window IBM "
            f"forcing engaged (windows {body_windows}); pass this step to "
            "init_multi_body_fsi_carry(..., step=step) to drop the unused "
            "full-field forcing buffer from the carry"
        )

        def windowed_interaction(i, vb, velocity_field, pos, vel):
            """Body i's penalty interaction through its moving window:
            (lag_forcing, velocity_mismatch, start, mats, ok)."""
            window_mats, e2l_interp, _ = body_tools[i]
            params_i = bodies[i].interactor.params
            start, mats, ok = window_mats(pos)
            flow_velocity = e2l_interp(velocity_field, start, mats)
            mismatch = flow_velocity - vel
            lag_forcing = compute_penalty_force(
                vb.position_mismatch, mismatch, params_i
            )
            return lag_forcing, mismatch, start, mats, ok

    def body_substep(i, spec, state, vb, velocity_field, t, dt_sub,
                     frozen_i=None):
        """One substep of body i; returns (state, vb, window_ok)."""
        grid = spec.interactor.forcing_grid
        params = spec.interactor.params
        if frozen_mode:
            # opt-in approximation: the last full interaction's loads,
            # frozen through the substeps (O(flow_dt) forcing lag)
            forces, torques, mismatch = frozen_i
            ok = jnp.asarray(True)
        elif sparse and not gather_sub[i]:
            lag_forcing, mismatch, _, _, ok = windowed_interaction(
                i, vb, velocity_field,
                grid.lag_positions(state), grid.lag_velocities(state),
            )
            forces, torques = grid.body_loads(state, lag_forcing)
        else:
            interaction = compute_interaction_force_on_lag_grid(
                vb, velocity_field, grid.lag_positions(state),
                grid.lag_velocities(state), params,
            )
            lag_forcing = interaction.lag_forcing
            mismatch = interaction.velocity_mismatch
            ok = jnp.asarray(True)
            forces, torques = grid.body_loads(state, lag_forcing)
        if isinstance(spec, RodBody):
            pdtype = state.position.dtype
            state = rod_steps[i](
                state,
                t.astype(pdtype),
                dt_sub.astype(pdtype),
                forces.astype(pdtype),
                torques.astype(pdtype),
            )
        else:  # DynamicRigidBody
            force = jnp.reshape(forces, (3,))
            torque = jnp.reshape(torques, (3,))
            if spec.load_fn is not None:
                f_extra, t_extra = spec.load_fn(state, t)
                force = force + jnp.reshape(
                    jnp.asarray(f_extra, force.dtype), (3,)
                )
                torque = torque + jnp.reshape(
                    jnp.asarray(t_extra, torque.dtype), (3,)
                )
            pdtype = state.position.dtype
            state = rigid_body_position_verlet_step(
                state,
                dt_sub.astype(pdtype),
                force.astype(pdtype),
                torque.astype(pdtype),
                spec.rigid_body.mass,
                jnp.asarray(spec.rigid_body.inertia_body, pdtype),
            )
        vb = virtual_boundary_time_step(vb, mismatch, dt_sub)
        return state, vb, ok

    def step(carry: MultiBodyFSICarry):
        (flow_state, body_states, vb_states, prev_mis, time, greens,
         u_l1, frozen) = carry
        if frozen_mode and frozen is None:
            raise ValueError(
                "substep_load_refresh='flow_step' needs the frozen-loads "
                "carry leaves - build the carry with "
                "init_multi_body_fsi_carry(flow_sim, bodies, step) "
                "passing THIS step"
            )
        dt = flow_dt(u_l1)
        real_t = flow_state.velocity_field.dtype

        windows_ok = jnp.asarray(True)
        if any_sub:
            if dynamic:
                n_raw = jnp.floor(
                    dt / jnp.minimum(dt, sub_dt)
                ).astype(jnp.int32)
                n_sub = jnp.clip(n_raw, 1, max_substeps)
                scan_length = max_substeps
            else:
                n_sub = jnp.asarray(substeps, jnp.int32)
                scan_length = substeps
            dt_sub = dt / n_sub.astype(dt.dtype)

            def substep(c, i_sub):
                def active(c):
                    states, vbs, t, ok = c
                    new_states, new_vbs = [], []
                    for i, spec in enumerate(bodies):
                        if substepped[i]:
                            s, vb, sub_ok = body_substep(
                                i, spec, states[i], vbs[i],
                                flow_state.velocity_field, t, dt_sub,
                                frozen[i] if frozen_mode else None,
                            )
                            ok = ok & sub_ok
                        else:
                            s, vb = states[i], vbs[i]
                        new_states.append(s)
                        new_vbs.append(vb)
                    return (tuple(new_states), tuple(new_vbs), t + dt_sub, ok)

                c = (
                    jax.lax.cond(i_sub < n_sub, active, lambda c: c, c)
                    if dynamic
                    else active(c)
                )
                return c, None

            (body_states, vb_states, _, windows_ok), _ = jax.lax.scan(
                substep,
                (body_states, vb_states, time, windows_ok),
                jnp.arange(scan_length, dtype=jnp.int32),
            )

        # fixed bodies integrate mismatch once with the previous mismatch,
        # then EVERY body spreads its penalty forcing: onto the shared
        # forcing field (dense), or - sparse - as a windowed forcing-curl
        # added straight into the vorticity (curl is linear; overlapping
        # body windows compose exactly)
        new_vbs, new_prev, lag_sums = [], [], []
        new_frozen = []
        if sparse:
            field = flow_state.primary_field
        else:
            eul_forcing = jnp.zeros_like(flow_state.eul_grid_forcing_field)
        for i, spec in enumerate(bodies):
            vb = vb_states[i]
            params = spec.interactor.params
            grid = spec.interactor.forcing_grid
            if isinstance(spec, FixedRigidBody):
                vb = virtual_boundary_time_step(vb, prev_mis[i], dt)
                pos, vel = fixed_lag[i]
            else:
                pos = grid.lag_positions(body_states[i])
                vel = grid.lag_velocities(body_states[i])
            if sparse:
                lag_forcing, mismatch, start, mats, ok_i = (
                    windowed_interaction(
                        i, vb, flow_state.velocity_field, pos, vel
                    )
                )
                windows_ok = windows_ok & ok_i
                wz, wy, wx = body_windows[i]
                win = jnp.zeros((3, wz, wy, wx), real_t)
                win = lagrangian_to_eulerian_spread_mm(win, lag_forcing, mats)
                curl_win = curl_3d(
                    win, jnp.asarray(dt / (2.0 * params.dx), real_t)
                )
                field = body_tools[i][2](field, curl_win, start)
            else:
                eul_forcing, interaction = (
                    compute_interaction_force_on_eul_and_lag_grid(
                        vb, eul_forcing, flow_state.velocity_field, pos, vel,
                        params,
                    )
                )
                lag_forcing = interaction.lag_forcing
                mismatch = interaction.velocity_mismatch
            new_vbs.append(vb)
            # cast to the carried dtype: float64 rod kinematics feeding a
            # float32 flow must not promote the carry leaf mid-scan
            new_prev.append(mismatch.astype(prev_mis[i].dtype))
            lag_sums.append(jnp.sum(lag_forcing, axis=1))
            if frozen_mode and substepped[i]:
                nf, nt = grid.body_loads(body_states[i], lag_forcing)
                new_frozen.append((nf, nt, mismatch))
            else:
                new_frozen.append(None)

        fsv = jnp.asarray(
            free_stream_fn(time)
            if free_stream_fn is not None
            else jnp.zeros(dim, real_t),
            real_t,
        )
        if sparse:
            flow_state = flow_state._replace(primary_field=field)
        else:
            flow_state = flow_state._replace(
                eul_grid_forcing_field=eul_forcing
            )
        flow_state, new_l1 = flow_step_l1(flow_state, dt, fsv, greens)
        new_carry = MultiBodyFSICarry(
            flow_state,
            body_states,
            tuple(new_vbs),
            tuple(new_prev),
            time + dt,
            greens,
            new_l1 if new_l1 is not None else u_l1,
            tuple(new_frozen) if frozen_mode else None,
        )
        diag = tuple(lag_sums)
        return new_carry, (diag, windows_ok) if sparse else diag

    step.uses_sparse_forcing = sparse
    step.uses_frozen_loads = frozen_mode
    if frozen_mode:
        def _frozen_loads_template(body_states, vb_states, velocity_field):
            # shapes/dtypes of the per-body frozen loads the step stores
            # (init_multi_body_fsi_carry eval_shapes this for the zero
            # init; fixed bodies carry None)
            out = []
            for i, spec in enumerate(bodies):
                if not substepped[i]:
                    out.append(None)
                    continue
                grid = spec.interactor.forcing_grid
                params = spec.interactor.params
                pos = grid.lag_positions(body_states[i])
                vel = grid.lag_velocities(body_states[i])
                if sparse:
                    lag_forcing, mismatch, _, _, _ = windowed_interaction(
                        i, vb_states[i], velocity_field, pos, vel
                    )
                else:
                    interaction = compute_interaction_force_on_lag_grid(
                        vb_states[i], velocity_field, pos, vel, params
                    )
                    lag_forcing = interaction.lag_forcing
                    mismatch = interaction.velocity_mismatch
                nf, nt = grid.body_loads(body_states[i], lag_forcing)
                out.append((nf, nt, mismatch))
            return tuple(out)

        step._frozen_loads_template = _frozen_loads_template
    return step


def init_multi_body_fsi_carry(flow_sim, bodies, step=None) -> MultiBodyFSICarry:
    """Initial carry for :func:`build_multi_body_fsi_step` (fresh
    interactors, zero mismatch).

    Pass the built ``step`` to let the carry drop what that step never
    reads: the per-body sparse-forcing step ignores the full-field
    ``eul_grid_forcing_field``, so its leaf shrinks to a zero-size
    placeholder (as :func:`init_rigid_fsi_carry` does)."""
    body_states, vb_states, prev = [], [], []
    for spec in bodies:
        if isinstance(spec, RodBody):
            body_states.append(spec.rod_collection._systems[0].state)
        elif isinstance(spec, DynamicRigidBody):
            body_states.append(spec.rigid_body.state)
        else:
            body_states.append(None)
        vb_states.append(spec.interactor.state)
        prev.append(
            jnp.zeros_like(spec.interactor.state.position_mismatch)
        )
    flow_state = flow_sim._get_state()
    if getattr(step, "uses_sparse_forcing", False):
        flow_state = flow_state._replace(
            eul_grid_forcing_field=jnp.zeros(
                (flow_state.eul_grid_forcing_field.shape[0],) + (0,)
                * (flow_state.eul_grid_forcing_field.ndim - 1),
                flow_state.eul_grid_forcing_field.dtype,
            )
        )
    frozen = None
    if getattr(step, "uses_frozen_loads", False):
        tmpl = jax.eval_shape(
            step._frozen_loads_template,
            tuple(body_states), tuple(vb_states), flow_sim.velocity_field,
        )
        frozen = jax.tree_util.tree_map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype), tmpl
        )
    carry = MultiBodyFSICarry(
        flow_state=flow_state,
        body_states=tuple(body_states),
        vb_states=tuple(vb_states),
        prev_mismatches=tuple(prev),
        time=jnp.asarray(flow_sim.time, flow_sim.real_t),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=velocity_l1_max(flow_sim.velocity_field),
        frozen_loads=frozen,
    )
    return _canonicalize_carry_shardings(carry, flow_sim.mesh)


def suggest_rod_forcing_window(
    interactor, rod, grid_size, margin=1.1, max_grid_fraction=0.7
):
    """Static ``(Wz, Wy, Wx)`` window cells for
    ``build_rod_fsi_step(sparse_forcing_window=...)``, sized from the
    rod's REACHABLE envelope: an (almost) inextensible rod of length L and
    radius r always fits a per-axis box of ``L + 2r`` no matter how it
    bends or reorients, so the window (that envelope times ``margin`` for
    residual stretch, plus the delta-support/curl margins) provably covers
    the instantaneous marker support for the whole run - the earlier
    current-extent heuristic was outgrown mid-run by a flapping rod whose
    perpendicular bounding box grows from ~one diameter to ~L as it bends
    (measured in the round-3 physics-long validation).

    Returns ``None`` when the windowed volume would exceed
    ``max_grid_fraction`` of the grid - the dense path is then the better
    choice (callers pass ``sparse_forcing_window=None`` through).
    """
    import numpy as np

    params = interactor.params
    lengths = np.asarray(rod.params.rest_lengths)
    radius = float(np.asarray(rod.params.radius).max())
    reach = float(lengths.sum()) + 2.0 * radius
    cells = int(np.ceil(margin * reach / params.dx))
    w = cells + 2 * params.interp_kernel_width + 6
    nz, ny, nx = (int(v) for v in grid_size)
    win = (min(w, nz), min(w, ny), min(w, nx))
    if np.prod(win) > max_grid_fraction * nz * ny * nx:
        return None
    return win


def suggest_rigid_forcing_window(
    interactor, grid_size, margin=1.1, max_grid_fraction=0.7
):
    """Static ``(Wz, Wy, Wx)`` window cells for a (possibly moving) rigid
    body's sparse IBM forcing, sized from its ROTATION-SAFE envelope: the
    markers always fit a per-axis box of the body's circumscribing
    diameter no matter how it rotates, and the window START tracks
    translation in-trace (the multi-body sparse path / window_mats).
    Returns None when the windowed volume would exceed
    ``max_grid_fraction`` of the grid - the dense path is then better."""
    import numpy as np

    params = interactor.params
    pos = np.asarray(interactor.forcing_grid.compute_lag_grid_position_field())
    centroid = pos.mean(axis=1, keepdims=True)
    diameter = 2.0 * float(np.linalg.norm(pos - centroid, axis=0).max())
    cells = int(np.ceil(margin * diameter / params.dx))
    w = cells + 2 * params.interp_kernel_width + 6
    nz, ny, nx = (int(v) for v in grid_size)
    win = (min(w, nz), min(w, ny), min(w, nx))
    if np.prod(win) > max_grid_fraction * nz * ny * nx:
        return None
    return win


def init_rod_fsi_carry(flow_sim, interactor, rod, step=None) -> RodFSICarry:
    """Initial carry for :func:`build_rod_fsi_step`. Pass the built
    ``step`` when it uses ``substep_load_refresh='flow_step'``: the carry
    then gains zero-initialized frozen-loads leaves (the reference's
    FlowForces start at zero before the first interaction)."""
    frozen = None
    if getattr(step, "uses_frozen_loads", False):
        tmpl = jax.eval_shape(
            step._frozen_loads_template,
            rod.state, interactor.state, flow_sim.velocity_field,
        )
        frozen = jax.tree_util.tree_map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype), tmpl
        )
    carry = RodFSICarry(
        flow_state=flow_sim._get_state(),
        vb_state=interactor.state,
        rod_state=rod.state,
        time=jnp.asarray(flow_sim.time, flow_sim.real_t),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=velocity_l1_max(flow_sim.velocity_field),
        frozen_loads=frozen,
    )
    return _canonicalize_carry_shardings(carry, flow_sim.mesh)


class FlowOnlyCarry(NamedTuple):
    flow_state: object
    time: jax.Array
    greens: object
    velocity_l1_max: jax.Array = None  # see RigidFSICarry


def build_flow_only_step(
    flow_sim,
    dt_prefac=1.0,
    free_stream_fn: Callable | None = None,
):
    """One fused flow-only step (CFL dt control + flow step) for the
    non-FSI cases (Lamb-Oseen, passive transport): a host-driven loop pays
    one dispatch per step, so even pure flow runs should scan on device. Compose with :func:`scan_steps` using
    :func:`init_flow_only_carry`."""
    flow_step_l1 = flow_sim._step_l1_fn.__wrapped__
    flow_dt = _flow_dt_fn(flow_sim, dt_prefac)
    dim = flow_sim.grid_dim

    def step(carry: FlowOnlyCarry):
        flow_state, time, greens, u_l1 = carry
        real_t = flow_state.velocity_field.dtype
        dt = flow_dt(u_l1)
        fsv = (
            free_stream_fn(time)
            if free_stream_fn is not None
            else jnp.zeros(dim, real_t)
        )
        flow_state, new_l1 = flow_step_l1(
            flow_state, dt, jnp.asarray(fsv, real_t), greens
        )
        # passive flow types leave the velocity untouched -> keep the max
        return (
            FlowOnlyCarry(
                flow_state, time + dt, greens,
                new_l1 if new_l1 is not None else u_l1,
            ),
            dt,
        )

    return step


def init_flow_only_carry(flow_sim) -> FlowOnlyCarry:
    carry = FlowOnlyCarry(
        flow_state=flow_sim._get_state(),
        time=jnp.asarray(flow_sim.time, flow_sim.real_t),
        greens=flow_sim._poisson_greens,
        velocity_l1_max=velocity_l1_max(flow_sim.velocity_field),
    )
    return _canonicalize_carry_shardings(carry, flow_sim.mesh)


def scan_steps(step_fn, carry, n_steps: int, *, donate: bool = False):
    """Roll ``n_steps`` coupled steps on device; returns
    (final carry, stacked per-step diagnostics).

    ``donate=True`` donates the carry's field buffers; the Fourier Green's
    function riding in the carry is EXCLUDED from donation (it is threaded
    through every step unchanged and is the same buffer the flow solver
    holds - donating it would invalidate any later host-side
    ``flow_sim.time_step`` / ``solver.solve`` call far from the donation
    site). Without donation the in and out carries coexist across the jit
    boundary, an extra ~7 GB of HBM at 512^3."""
    if not donate:
        return _scan_steps(step_fn, carry, n_steps)
    greens = carry.greens
    final, diag = _scan_steps_donated(
        step_fn, carry._replace(greens=None), greens, n_steps
    )
    return final._replace(greens=greens), diag


@functools.partial(jax.jit, static_argnums=(0, 2))
def _scan_steps(step_fn, carry, n_steps: int):
    return jax.lax.scan(lambda c, _: step_fn(c), carry, None, length=n_steps)


@functools.partial(jax.jit, static_argnums=(0, 3), donate_argnums=1)
def _scan_steps_donated(step_fn, carry_sans_greens, greens, n_steps: int):
    carry = carry_sans_greens._replace(greens=greens)
    final, diag = jax.lax.scan(
        lambda c, _: step_fn(c), carry, None, length=n_steps
    )
    # greens is carried through unchanged; drop it from the outputs so the
    # caller re-attaches the original (un-donated) buffer.
    return final._replace(greens=None), diag
