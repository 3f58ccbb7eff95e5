"""Penalty immersed-boundary ("virtual boundary") forcing.

JAX counterpart of ``VirtualBoundaryForcingMPI``
(/root/reference/sopht_mpi/numeric/immersed_boundary_ops/
VirtualBoundaryForcingMPI.py:21-459), after Goldstein 1993 JCP. The penalty
force on the markers is

    lag_forcing = k * position_mismatch + c * velocity_mismatch,
    mismatch = flow - body,

with the stiffness/damping coefficients passed NEGATIVE by convention
(Goldstein's alpha, beta < 0; see the reference examples,
flow_past_cylinder.py:16-17 ``coupling_stiffness=-5e4, coupling_damping=-20``)
so the forcing decelerates the flow toward the body; the force ON the body
is ``-sum(lag_forcing)`` (Newton's third law, applied in the forcing grids).

Design: markers are replicated across devices, so the reference's
master-rank buffers, marker->rank remapping and gather/scatter machinery
(:179-276) vanish. The state is a small pytree and every method is a pure
function - the whole interaction step jits and scans.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sopht_mpi_tpu.ops.ibm import (
    INTERP_KERNEL_WIDTH,
    eulerian_to_lagrangian_interpolation,
    interpolation_weights,
    lagrangian_to_eulerian_spread,
    nearest_grid_index_and_support,
)


class VirtualBoundaryState(NamedTuple):
    """Mutable-through-replacement forcing state (pytree).

    ``position_mismatch`` integrates the flow-body velocity mismatch
    (Euler forward, reference :452-459)."""

    position_mismatch: jax.Array  # (grid_dim, n)
    time: jax.Array  # scalar


class LagGridInteraction(NamedTuple):
    """Per-call results of the penalty force computation."""

    lag_forcing: jax.Array  # (grid_dim, n)
    velocity_mismatch: jax.Array  # (grid_dim, n)
    flow_velocity: jax.Array  # (grid_dim, n)


@dataclass(frozen=True)
class VirtualBoundaryForcingParams:
    """Static configuration (hashable; safe as a jit closure).

    :param virtual_boundary_stiffness_coeff: penalty stiffness (negative).
    :param virtual_boundary_damping_coeff: penalty damping (negative).
    :param grid_dim: 2 or 3.
    :param dx: Eulerian grid spacing.
    :param eul_grid_coord_shift: grid-start offset (default dx/2,
        reference :84-88).
    :param interp_kernel_width: delta support half-width (must be 2).
    :param delta_kind: "cosine" (reference default) or "peskin".
    """

    virtual_boundary_stiffness_coeff: float
    virtual_boundary_damping_coeff: float
    grid_dim: int
    dx: float
    eul_grid_coord_shift: float | None = None
    interp_kernel_width: int = INTERP_KERNEL_WIDTH
    delta_kind: str = "cosine"

    def __post_init__(self):
        if self.grid_dim not in (2, 3):
            raise ValueError(
                "Invalid grid dimensions for virtual boundary forcing!"
            )
        if self.eul_grid_coord_shift is None:
            object.__setattr__(self, "eul_grid_coord_shift", self.dx / 2.0)


def init_virtual_boundary_state(
    num_lag_nodes: int, grid_dim: int, dtype=jnp.float32, start_time=0.0
) -> VirtualBoundaryState:
    return VirtualBoundaryState(
        position_mismatch=jnp.zeros((grid_dim, num_lag_nodes), dtype=dtype),
        time=jnp.asarray(start_time, dtype=dtype),
    )


def compute_interaction_force_on_lag_grid(
    state: VirtualBoundaryState,
    eul_grid_velocity_field,
    lag_grid_position_field,
    lag_grid_velocity_field,
    params: VirtualBoundaryForcingParams,
) -> LagGridInteraction:
    """Penalty force on the Lagrangian markers (reference :333-406):
    grid support -> delta weights -> interpolate flow velocity ->
    velocity mismatch -> ``k dx_mismatch + c dv``."""
    _, support_idx, support_disp = nearest_grid_index_and_support(
        lag_grid_position_field,
        params.dx,
        params.eul_grid_coord_shift,
        params.interp_kernel_width,
    )
    weights = interpolation_weights(support_disp, params.dx, params.delta_kind)
    flow_velocity = eulerian_to_lagrangian_interpolation(
        eul_grid_velocity_field, weights, support_idx, params.dx
    )
    velocity_mismatch = flow_velocity - lag_grid_velocity_field
    lag_forcing = compute_penalty_force(
        state.position_mismatch, velocity_mismatch, params
    )
    return LagGridInteraction(lag_forcing, velocity_mismatch, flow_velocity)


def compute_penalty_force(position_mismatch, velocity_mismatch, params):
    """The penalty force law ``k dx_mismatch + c dv`` (reference
    :399-406) - the single definition shared by the dense and
    sparse-window interaction paths."""
    return (
        params.virtual_boundary_stiffness_coeff * position_mismatch
        + params.virtual_boundary_damping_coeff * velocity_mismatch
    )


def compute_interaction_force_on_eul_and_lag_grid(
    state: VirtualBoundaryState,
    eul_grid_forcing_field,
    eul_grid_velocity_field,
    lag_grid_position_field,
    lag_grid_velocity_field,
    params: VirtualBoundaryForcingParams,
    reset_eul_grid_forcing_field: bool = False,
):
    """Full interaction: penalty force on markers plus its spreading onto
    the Eulerian forcing field (reference :408-450).

    :returns: (updated eul_grid_forcing_field, LagGridInteraction).
    """
    if reset_eul_grid_forcing_field:
        eul_grid_forcing_field = jnp.zeros_like(eul_grid_forcing_field)
    _, support_idx, support_disp = nearest_grid_index_and_support(
        lag_grid_position_field,
        params.dx,
        params.eul_grid_coord_shift,
        params.interp_kernel_width,
    )
    weights = interpolation_weights(support_disp, params.dx, params.delta_kind)
    flow_velocity = eulerian_to_lagrangian_interpolation(
        eul_grid_velocity_field, weights, support_idx, params.dx
    )
    velocity_mismatch = flow_velocity - lag_grid_velocity_field
    lag_forcing = compute_penalty_force(
        state.position_mismatch, velocity_mismatch, params
    )
    eul_grid_forcing_field = lagrangian_to_eulerian_spread(
        eul_grid_forcing_field, lag_forcing, weights, support_idx
    )
    return eul_grid_forcing_field, LagGridInteraction(
        lag_forcing, velocity_mismatch, flow_velocity
    )


def virtual_boundary_time_step(
    state: VirtualBoundaryState, velocity_mismatch, dt
) -> VirtualBoundaryState:
    """Euler-forward update of the position mismatch (reference :452-459).

    The mismatch increment is cast to the state dtype at the boundary:
    float64 rod kinematics feeding a float32 flow (the reference's mixed
    precision contract) must not promote the carried state, which would
    change pytree leaf types mid-trace (e.g. across lax.cond branches).
    """
    pm = state.position_mismatch
    return VirtualBoundaryState(
        position_mismatch=pm + (dt * velocity_mismatch).astype(pm.dtype),
        time=state.time + jnp.asarray(dt, state.time.dtype),
    )
