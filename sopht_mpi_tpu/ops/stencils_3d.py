"""3D Eulerian grid stencil ops (functional, global-array).

Capability parity with /root/reference/sopht_mpi/numeric/eulerian_grid_ops/
stencil_ops_3d/ (diffusion, conservative ENO3 advection, curl, divergence,
vorticity update from velocity forcing / penalised velocity, boundary
penalisation, Brinkmann penalisation, char func, Laplacian filter).

Conventions: scalar fields (nz, ny, nx); vector fields (3, nz, ny, nx) with
components (x, y, z) - the reference's VectorField order. Grid axes are
ordered (z, y, x), so vector component c varies along grid axis (2 - c).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sopht_mpi_tpu.ops._stencil_utils import (
    axslice,
    central_diff_interior,
    eno3_divergence_interior,
    laplacian_interior,
    pad_all,
    pad_axis,
)

DIFFUSION_KERNEL_SUPPORT = 1
ADVECTION_ENO3_KERNEL_SUPPORT = 2
CURL_KERNEL_SUPPORT = 1
DIVERGENCE_KERNEL_SUPPORT = 1
LAPLACIAN_FILTER_KERNEL_SUPPORT = 1

_X, _Y, _Z = 0, 1, 2  # vector component indices
_ZAX, _YAX, _XAX = 0, 1, 2  # grid axes of a scalar field


def diffusion_flux_3d(field, prefactor):
    """``flux = prefactor * discrete_laplacian(field)``, zero band width 1 at
    walls (diffusion_flux_mpi_3d.py:162)."""
    return pad_all(prefactor * laplacian_interior(field), 1)


def diffusion_timestep_3d(field, nu_dt_by_dx2):
    return field + diffusion_flux_3d(field, nu_dt_by_dx2)


def diffusion_timestep_vector_3d(vector_field, nu_dt_by_dx2):
    """Vector field_type variant (diffusion_timestep_mpi_3d.py:61-63)."""
    return vector_field + pad_all(
        nu_dt_by_dx2 * laplacian_interior(vector_field, ndim_offset=1),
        1,
        start_axis=1,
    )


def advection_flux_conservative_eno3_3d(field, velocity, inv_dx):
    """Conservative ENO3 advective flux sum over the three axes."""
    div = eno3_divergence_interior(field, velocity[_Z], axis=_ZAX)
    div = div + eno3_divergence_interior(field, velocity[_Y], axis=_YAX)
    div = div + eno3_divergence_interior(field, velocity[_X], axis=_XAX)
    return inv_dx * div


def advection_timestep_eno3_3d(field, velocity, dt_by_dx):
    return field + advection_flux_conservative_eno3_3d(field, velocity, -dt_by_dx)


def advection_timestep_eno3_vector_3d(vector_field, velocity, dt_by_dx):
    """Vector field_type variant: advect each component with the same
    velocity (advection_timestep_mpi_3d.py)."""
    return jax.vmap(lambda f: advection_timestep_eno3_3d(f, velocity, dt_by_dx))(
        vector_field
    )


def curl_3d(field, prefactor):
    """``curl = prefactor * 2 * nabla x field`` via central differences with
    ``prefactor = 0.5/dx``; zero band width 1 at walls
    (curl_mpi_3d.py:10, :164).

    ``field`` is a vector field (3, nz, ny, nx); returns the same shape.
    """
    d = lambda comp, ax: central_diff_interior(field[comp], axis=ax)
    curl_x = d(_Z, _YAX) - d(_Y, _ZAX)
    curl_y = d(_X, _ZAX) - d(_Z, _XAX)
    curl_z = d(_Y, _XAX) - d(_X, _YAX)
    return pad_all(prefactor * jnp.stack([curl_x, curl_y, curl_z]), 1, start_axis=1)


def divergence_3d(field, inv_dx):
    """Central-difference divergence of a vector field
    (divergence_mpi_3d.py:10); zero band width 1 at walls."""
    div = (
        central_diff_interior(field[_X], axis=_XAX)
        + central_diff_interior(field[_Y], axis=_YAX)
        + central_diff_interior(field[_Z], axis=_ZAX)
    )
    return pad_all(0.5 * inv_dx * div, 1)


def update_vorticity_from_velocity_forcing_3d(
    vorticity, velocity_forcing, prefactor
):
    """``vorticity += prefactor * 2 * curl(velocity_forcing)`` on the interior
    with ``prefactor = dt/(2 dx)``; boundary ring left unchanged
    (update_vorticity_from_velocity_forcing_mpi_3d.py:9)."""
    return vorticity + curl_3d(velocity_forcing, prefactor)


def update_vorticity_from_penalised_velocity_3d(
    vorticity, penalised_velocity, velocity, prefactor
):
    """``vorticity += prefactor * 2 * curl(penalised_velocity - velocity)``
    (update_vorticity_from_velocity_forcing_mpi_3d.py:181-219)."""
    return vorticity + curl_3d(penalised_velocity - velocity, prefactor)


def penalise_field_boundary_3d(field, width: int):
    """Sponge-penalise toward the walls over ``width`` cells; see the 2D
    variant for semantics (penalise_field_boundary_mpi_3d.py). Applied along
    x, then y, then z."""
    if width == 0:
        return field
    ramp = jnp.sin(0.5 * jnp.pi * jnp.arange(width, dtype=field.dtype) / width)
    for ax in (_XAX, _YAX, _ZAX):
        shape = [1, 1, 1]
        shape[ax] = width
        r = ramp.reshape(shape)
        edge_lo = axslice(field, width - 1, width, ax)
        edge_hi = axslice(field, -width, -width + 1 if width > 1 else None, ax)
        mid = axslice(field, width, -width, ax)
        field = jnp.concatenate(
            [edge_lo * r, mid, edge_hi * jnp.flip(r, axis=ax)], axis=ax
        )
    return field


def penalise_field_boundary_vector_3d(vector_field, width: int):
    return jax.vmap(lambda f: penalise_field_boundary_3d(f, width))(vector_field)


def brinkmann_penalise_3d(velocity, penalty_factor, char_field, penalty_velocity):
    """Implicit Brinkmann penalisation (brinkmann_penalise_mpi_3d.py:7)."""
    denom = 1.0 + penalty_factor * char_field
    return (velocity + penalty_factor * char_field * penalty_velocity) / denom


def char_func_from_level_set_via_sine_heaviside_3d(level_set, blend_width):
    """Smooth characteristic function from a signed-distance level set
    (char_func_from_level_set_mpi_3d.py:8)."""
    phi = level_set / blend_width
    h = 0.5 * (1.0 + phi + jnp.sin(jnp.pi * phi) / jnp.pi)
    return jnp.clip(h, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Laplacian (vorticity-stabilisation) filter
# Jeanmart & Winckelmans 2007; Lorieul 2018. Reference:
# laplacian_filter_mpi_3d.py:14-421.
# ---------------------------------------------------------------------------


def _highpass_1d(field, axis: int):
    """Directional high-pass ``0.25 (2 f[i] - f[i+1] - f[i-1])`` along one
    axis, then zero a width-1 band at every physical wall (the reference's
    per-pass ``_clear_val_at_physical_domain_boundary``)."""
    inner = 0.25 * (
        2.0 * axslice(field, 1, -1, axis)
        - axslice(field, 2, None, axis)
        - axslice(field, 0, -2, axis)
    )
    out = pad_axis(inner, 1, 1, axis)
    # zero band width 1 on all faces
    interior = out[1:-1, 1:-1, 1:-1]
    return pad_all(interior, 1)


def laplacian_filter_3d(field, filter_order: int, filter_type: str):
    """Apply the Laplacian vorticity filter to a scalar field.

    multiplicative: ``field -= (H_z H_y H_x)^order field``
    convolution:    sequentially per axis a: ``field -= H_a^order field``
    where ``H_a`` is the directional high-pass (reference
    laplacian_filter_mpi_3d.py:267-385).
    """
    if filter_order < 0 or not isinstance(filter_order, int):
        raise ValueError("Invalid filter order")
    if filter_order == 0:
        return field
    if filter_type == "multiplicative":
        buf = field
        for _ in range(filter_order):
            buf = _highpass_1d(buf, _XAX)
            buf = _highpass_1d(buf, _YAX)
            buf = _highpass_1d(buf, _ZAX)
        return field - buf
    elif filter_type == "convolution":
        for axis in (_XAX, _YAX, _ZAX):
            buf = field
            for _ in range(filter_order):
                buf = _highpass_1d(buf, axis)
            field = field - buf
        return field
    raise ValueError("Invalid filter type")


def laplacian_filter_vector_3d(vector_field, filter_order: int, filter_type: str):
    return jax.vmap(
        lambda f: laplacian_filter_3d(f, filter_order, filter_type)
    )(vector_field)
