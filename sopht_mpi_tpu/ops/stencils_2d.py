"""2D Eulerian grid stencil ops (functional, global-array).

Capability parity with /root/reference/sopht_mpi/numeric/eulerian_grid_ops/
stencil_ops_2d/ (diffusion flux/timestep, conservative ENO3 advection
flux/timestep, outplane curl, vorticity update from velocity forcing,
boundary penalisation, Brinkmann penalisation, char func from level set).

Design differences from the reference (deliberate):
- Fields are ghost-free global arrays; what the reference achieves with halo
  exchange + interior/boundary kernel splits + PROC_NULL wall logic
  (e.g. diffusion_flux_mpi_2d.py:33-140) is here a single shifted-slice jnp
  expression with an explicit zero band at the physical walls. XLA partitions
  it over the device mesh and inserts the halo collectives.
- Ops are pure functions returning new arrays (functional state), composed
  and fused under one jit.

Conventions: scalar fields (ny, nx); vector fields (2, ny, nx) with
component 0 = x, 1 = y (the reference's VectorField order).
"""

from __future__ import annotations

import jax.numpy as jnp

from sopht_mpi_tpu.ops._stencil_utils import (
    axslice,
    eno3_divergence_interior,
    laplacian_interior,
    central_diff_interior,
    pad_all,
)

# kernel supports, for parity with the reference's ghost-size checks
# (diffusion_flux_mpi_2d.py:19, advection_flux_mpi_2d.py:14)
DIFFUSION_KERNEL_SUPPORT = 1
ADVECTION_ENO3_KERNEL_SUPPORT = 2
CURL_KERNEL_SUPPORT = 1


def diffusion_flux_2d(field, prefactor):
    """``flux = prefactor * discrete_laplacian(field)`` with a zero band of
    width 1 at the physical walls (reference boundary_width=1,
    diffusion_flux_mpi_2d.py:119-140)."""
    return pad_all(prefactor * laplacian_interior(field), 1)


def diffusion_timestep_2d(field, nu_dt_by_dx2):
    """Euler-forward diffusion: ``field += flux``."""
    return field + diffusion_flux_2d(field, nu_dt_by_dx2)


def advection_flux_conservative_eno3_2d(field, velocity, inv_dx):
    """Conservative ENO3 advective flux:
    ``inv_dx * (d(u_x q)/dx + d(u_y q)/dy)`` (undivided differences).

    Matches the reference call convention where the advection timestep passes
    ``inv_dx = -dt/dx`` and adds the result to the field
    (advection_timestep_mpi_2d.py:12, flow_simulators_mpi_2d.py:260-266).
    """
    div = eno3_divergence_interior(field, velocity[1], axis=0)
    div = div + eno3_divergence_interior(field, velocity[0], axis=1)
    return inv_dx * div


def advection_timestep_eno3_2d(field, velocity, dt_by_dx):
    """Euler-forward conservative ENO3 advection."""
    return field + advection_flux_conservative_eno3_2d(field, velocity, -dt_by_dx)


def outplane_field_curl_2d(field, prefactor):
    """Velocity from out-of-plane scalar field (e.g. streamfunction):
    ``(u, v) = curl(psi z_hat) = (d(psi)/dy, -d(psi)/dx)`` via central
    differences (``prefactor = 0.5/dx``), zeroed in a width-1 band at the
    physical walls (outplane_field_curl_mpi_2d.py:123-139).

    Returns a vector field (2, ny, nx).
    """
    u = prefactor * central_diff_interior(field, axis=0)
    v = -prefactor * central_diff_interior(field, axis=1)
    return pad_all(jnp.stack([u, v]), 1, start_axis=1)


def update_vorticity_from_velocity_forcing_2d(vorticity, velocity_forcing, prefactor):
    """``vorticity += prefactor * curl_z(velocity_forcing)`` on the interior
    (``prefactor = dt/(2 dx)``; boundary ring left unchanged).

    Reference: update_vorticity_from_velocity_forcing_mpi_2d.py:8 plus the
    sopht serial kernel it wraps.
    """
    curl_z = central_diff_interior(
        velocity_forcing[1], axis=1
    ) - central_diff_interior(velocity_forcing[0], axis=0)
    return vorticity + pad_all(prefactor * curl_z, 1)


def penalise_field_boundary_2d(field, width: int):
    """Sponge-penalise the field toward zero at the physical domain boundary
    over ``width`` cells: clamp the band to its inner-edge value, then ramp
    with ``sin(pi/2 * j / width)`` (j = distance from the wall in cells).

    Exactly the reference semantics on a uniform grid
    (penalise_field_boundary_mpi_2d.py:44-171: clamp to the cell at band edge
    then multiply by ``sin(sine_prefactor * (x - x_start))``), applied along
    x first, then y. ``width=0`` is a no-op (:24-28).
    """
    if width == 0:
        return field
    dtype = field.dtype
    ramp = jnp.sin(
        0.5 * jnp.pi * jnp.arange(width, dtype=dtype) / width
    )
    # along x (last axis), then y (first axis) - reference order
    for ax in (1, 0):
        shape = [1, 1]
        shape[ax] = width
        r = ramp.reshape(shape)
        edge_lo = axslice(field, width - 1, width, ax)
        edge_hi = axslice(field, -width, -width + 1 if width > 1 else None, ax)
        mid = axslice(field, width, -width, ax)
        lo = edge_lo * r
        hi = edge_hi * jnp.flip(r, axis=ax)
        field = jnp.concatenate([lo, mid, hi], axis=ax)
    return field


def brinkmann_penalise_2d(velocity, penalty_factor, char_field, penalty_velocity):
    """Implicit Brinkmann penalisation of a vector field toward
    ``penalty_velocity`` inside the body (``char_field`` in [0, 1]):
    ``u = (u + k chi u_body) / (1 + k chi)``.

    Reference re-exports the sopht elementwise kernel
    (brinkmann_penalise_mpi_2d.py:7); no communication, kernel_support 0.
    """
    denom = 1.0 + penalty_factor * char_field
    return (velocity + penalty_factor * char_field * penalty_velocity) / denom


def char_func_from_level_set_via_sine_heaviside_2d(level_set, blend_width):
    """Smooth characteristic function from a signed-distance level set
    (positive inside the body), blended over ``blend_width``:
    ``H = 0.5 (1 + phi/w + sin(pi phi/w)/pi)`` clipped to [0, 1].

    Reference re-exports the sopht kernel (char_func_from_level_set_mpi_2d.py:8).
    """
    phi = level_set / blend_width
    h = 0.5 * (1.0 + phi + jnp.sin(jnp.pi * phi) / jnp.pi)
    return jnp.clip(h, 0.0, 1.0)
