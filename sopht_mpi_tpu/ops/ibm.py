"""Eulerian <-> Lagrangian grid transfer ops for the immersed boundary method.

JAX counterpart of the reference's
``EulerianLagrangianGridCommunicatorMPI2D/3D``
(/root/reference/sopht_mpi/numeric/immersed_boundary_ops/
EulerianLagrangianGridCommunicatorMPI2D.py, ...MPI3D.py): nearest-index +
support computation, cosine / Peskin-2002 delta-function weights,
Eulerian-to-Lagrangian gather interpolation, and Lagrangian-to-Eulerian
scatter-add spreading.

Design: Lagrangian markers are REPLICATED across devices
(num markers << num grid cells), so the reference's entire
marker-to-rank remapping machinery (MPILagrangianFieldCommunicator, dynamic
buffer reallocation, ghost-sum reverse halo reduction -
EulerianLagrangianGridCommunicatorMPI2D.py:521-652) has no analogue here:
interpolation is a gather from the sharded grid and spreading is a
scatter-add onto it, both expressed as jnp indexing that XLA partitions.

Conventions: ``interp_kernel_width = 2`` (both delta functions require it,
reference :399-401, :443-445). Grid axes ordered (z?, y, x); marker arrays
``(grid_dim, n)`` with components (x, y[, z]).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


INTERP_KERNEL_WIDTH = 2

# The separable-matmul transfer einsums and the weight-matrix build MUST
# run at full float32: given no precision, a GPU may run an f32 matmul in
# TF32 (a 10-bit mantissa), which costs ~3 decimal digits in the delta
# weights.
_MM_PRECISION = jax.lax.Precision.HIGHEST


def nearest_grid_index_and_support(
    lag_positions, dx, eul_grid_coord_shift, interp_kernel_width=INTERP_KERNEL_WIDTH
):
    """Nearest Eulerian index and support-point displacements per marker.

    Reference semantics
    (EulerianLagrangianGridCommunicatorMPI2D.py:135-174):
    ``idx = floor((pos - shift) / dx)`` per axis; support indices
    ``idx + (-w+1 .. w)``; displacements = support position - marker
    position.

    :param lag_positions: (grid_dim, n) marker positions, components (x,y[,z]).
    :returns: (nearest_idx (grid_dim, n) int32,
               support_idx (grid_dim, 2w, n) int32,
               support_disp (grid_dim, 2w, n) displacements).
    """
    w = interp_kernel_width
    nearest = jnp.floor(
        (lag_positions - eul_grid_coord_shift) / dx
    ).astype(jnp.int32)
    offsets = jnp.arange(-w + 1, w + 1, dtype=jnp.int32)
    support_idx = nearest[:, None, :] + offsets[None, :, None]
    support_disp = (
        support_idx.astype(lag_positions.dtype) * dx
        + eul_grid_coord_shift
        - lag_positions[:, None, :]
    )
    return nearest, support_idx, support_disp


def cosine_delta_weights_1d(support_disp, dx):
    """Per-axis cosine delta factors ``(0.25/dx) (1 + cos(pi/2 d/dx))``
    (reference :389-428). Input (grid_dim, 2w, n); output same shape.
    The full tensor weight is the product over axes (the reference's
    (0.25/dx)^dim * prod terms, restructured as an outer product)."""
    r = support_disp / dx
    return (0.25 / dx) * (1.0 + jnp.cos(0.5 * jnp.pi * r))


def peskin_delta_weights_1d(support_disp, dx):
    """Per-axis Peskin (2002, eq. 6.27) 4-point delta factors
    (reference :431-518)."""
    r = jnp.abs(support_disp) / dx
    inner = (0.125 / dx) * (
        3.0 - 2.0 * r + jnp.sqrt(jnp.abs(1.0 + 4.0 * r - 4.0 * r**2))
    )
    outer = (0.125 / dx) * (
        5.0 - 2.0 * r - jnp.sqrt(jnp.abs(-7.0 + 12.0 * r - 4.0 * r**2))
    )
    return jnp.where(r < 1.0, inner, jnp.where(r < 2.0, outer, 0.0))


_DELTA_KERNELS = {
    "cosine": cosine_delta_weights_1d,
    "peskin": peskin_delta_weights_1d,
}


def interpolation_weights(support_disp, dx, kind="cosine"):
    """Full tensor-product interpolation weights.

    :param support_disp: (grid_dim, 2w, n) per-axis displacements.
    :returns: 2D -> (2w, 2w, n) weights (axes ordered [y-offset, x-offset]);
              3D -> (2w, 2w, 2w, n) ([z, y, x]-offsets). Matches the
              reference's interp_weights layout.
    """
    grid_dim = support_disp.shape[0]
    d1 = _DELTA_KERNELS[kind](support_disp, dx)
    if grid_dim == 2:
        # [y, x] offsets
        return d1[1][:, None, :] * d1[0][None, :, :]
    elif grid_dim == 3:
        return (
            d1[2][:, None, None, :]
            * d1[1][None, :, None, :]
            * d1[0][None, None, :, :]
        )
    raise ValueError(f"Invalid grid dim {grid_dim}")


def _support_gather_indices(support_idx, grid_shape):
    """Broadcasted integer index arrays selecting every support point of
    every marker; indices clipped to the grid (out-of-domain markers get
    edge values - combine with a validity check upstream)."""
    grid_dim = support_idx.shape[0]
    s = support_idx.shape[1]
    n = support_idx.shape[2]
    if grid_dim == 2:
        iy = jnp.clip(support_idx[1][:, None, :], 0, grid_shape[0] - 1)
        ix = jnp.clip(support_idx[0][None, :, :], 0, grid_shape[1] - 1)
        return (
            jnp.broadcast_to(iy, (s, s, n)),
            jnp.broadcast_to(ix, (s, s, n)),
        )
    iz = jnp.clip(support_idx[2][:, None, None, :], 0, grid_shape[0] - 1)
    iy = jnp.clip(support_idx[1][None, :, None, :], 0, grid_shape[1] - 1)
    ix = jnp.clip(support_idx[0][None, None, :, :], 0, grid_shape[2] - 1)
    shape = (s, s, s, n)
    return (
        jnp.broadcast_to(iz, shape),
        jnp.broadcast_to(iy, shape),
        jnp.broadcast_to(ix, shape),
    )


def axis_delta_weight_matrices(
    support_idx, support_disp, dx, window_shape, kind="cosine"
):
    """Per-grid-axis dense one-hot delta-factor matrices for the separable
    (matmul) transfer path.

    The tensor-product structure of the delta function (reference
    EulerianLagrangianGridCommunicatorMPI2D.py:389-518 builds weights as a
    per-axis outer product) means the E<->L transfer factorizes per axis.
    For markers with (window-relative) support indices ``support_idx``
    (grid_dim, 2w, n) and displacements ``support_disp``, returns a tuple
    of (n, W_axis) matrices ordered like the grid axes ((z, y, x) in 3D,
    (y, x) in 2D) such that the full delta weight of marker ``m`` at
    window cell (z, y, x) is ``Az[m, z] * Ay[m, y] * Ax[m, x]`` -
    numerically the same weights as :func:`interpolation_weights`,
    restructured so both transfer directions become dense matmuls instead
    of XLA gather/scatter.

    Support indices are CLIPPED to the window per axis (one-hot rows
    accumulate onto the edge cell), matching
    :func:`_support_gather_indices` clipping semantics exactly.
    """
    grid_dim = support_idx.shape[0]
    d1 = _DELTA_KERNELS[kind](support_disp, dx)  # (grid_dim, 2w, n)
    mats = []
    for g in range(grid_dim):
        comp = grid_dim - 1 - g  # marker components ordered (x, y[, z])
        w_axis = int(window_shape[g])
        idx = jnp.clip(support_idx[comp], 0, w_axis - 1)  # (2w, n)
        oh = jax.nn.one_hot(idx, w_axis, dtype=d1.dtype)  # (2w, n, W)
        mats.append(
            jnp.einsum("sn,snw->nw", d1[comp], oh, precision=_MM_PRECISION)
        )
    return tuple(mats)


def eulerian_to_lagrangian_interpolation_mm(eul_grid_field, axis_mats, dx):
    """Separable-matmul E->L interpolation:
    ``lag_m = sum_zyx E[z,y,x] Az[m,z] Ay[m,y] Ax[m,x] dx^dim``.

    Same contract/result as :func:`eulerian_to_lagrangian_interpolation`
    (modulo float summation order) with ``axis_mats`` from
    :func:`axis_delta_weight_matrices` on the same (window) field. In 3D
    the z/y axes contract through a combined (n, Wz*Wy) matrix so the only
    marker-sized intermediate is (c, n, Wx) - never (c, Wz, Wy, n).
    """
    grid_dim = len(axis_mats)
    vector = eul_grid_field.ndim == grid_dim + 1
    eul = eul_grid_field if vector else eul_grid_field[None]
    out_dtype = jnp.result_type(eul.dtype, axis_mats[0].dtype)
    eul = eul.astype(out_dtype)
    mats = [m.astype(out_dtype) for m in axis_mats]
    scale = dx**grid_dim
    if grid_dim == 2:
        a_y, a_x = mats
        u = jnp.einsum("ny,cyx->cnx", a_y, eul, precision=_MM_PRECISION)
    else:
        a_z, a_y, a_x = mats
        n = a_z.shape[0]
        a_zy = (a_z[:, :, None] * a_y[:, None, :]).reshape(n, -1)
        u = jnp.einsum(
            "ns,csx->cnx",
            a_zy,
            eul.reshape(eul.shape[0], -1, eul.shape[-1]),
            precision=_MM_PRECISION,
        )
    lag = jnp.einsum("cnx,nx->cn", u, a_x, precision=_MM_PRECISION) * scale
    return lag if vector else lag[0]


def lagrangian_to_eulerian_spread_mm(eul_grid_field, lag_grid_field, axis_mats):
    """Separable-matmul L->E spreading (exact adjoint of the mm
    interpolation): ``E[z,y,x] += sum_m lag_m Az[m,z] Ay[m,y] Ax[m,x]``.

    Same contract/result as :func:`lagrangian_to_eulerian_spread` (modulo
    float summation order); no scatter - the marker contraction is one
    matmul per component batch.
    """
    grid_dim = len(axis_mats)
    vector = lag_grid_field.ndim == 2
    lag = lag_grid_field if vector else lag_grid_field[None]
    lag = lag.astype(eul_grid_field.dtype)
    mats = [m.astype(eul_grid_field.dtype) for m in axis_mats]
    if grid_dim == 2:
        a_y, a_x = mats
        g = lag[:, :, None] * a_x[None]  # (c, n, Wx)
        add = jnp.einsum("ny,cnx->cyx", a_y, g, precision=_MM_PRECISION)
    else:
        a_z, a_y, a_x = mats
        n = a_z.shape[0]
        a_zy = (a_z[:, :, None] * a_y[:, None, :]).reshape(n, -1)
        g = lag[:, :, None] * a_x[None]
        add = jnp.einsum(
            "ns,cnx->csx", a_zy, g, precision=_MM_PRECISION
        ).reshape(lag.shape[0], a_z.shape[1], a_y.shape[1], a_x.shape[1])
    return eul_grid_field + (add if vector else add[0])


def eulerian_to_lagrangian_interpolation(
    eul_grid_field, interp_weights, support_idx, dx
):
    """Interpolate an Eulerian field onto markers:
    ``lag_i = sum_support eul * w * dx^dim``
    (reference :177-284). ``eul_grid_field`` may be a scalar field
    (ny, nx)/(nz, ny, nx) or a vector field with a leading component axis.

    :returns: (n,) for scalar input, (n_components, n) for vector input.
    """
    grid_dim = support_idx.shape[0]
    vector = eul_grid_field.ndim == grid_dim + 1
    grid_shape = eul_grid_field.shape[1:] if vector else eul_grid_field.shape
    idx = _support_gather_indices(support_idx, grid_shape)
    axes = tuple(range(grid_dim))
    scale = dx**grid_dim
    if vector:
        gathered = eul_grid_field[(slice(None), *idx)]
        return jnp.sum(gathered * interp_weights[None], axis=tuple(a + 1 for a in axes)) * scale
    gathered = eul_grid_field[idx]
    return jnp.sum(gathered * interp_weights, axis=axes) * scale


def lagrangian_to_eulerian_spread(
    eul_grid_field, lag_grid_field, interp_weights, support_idx
):
    """Spread (scatter-add) marker values onto the Eulerian grid:
    ``eul[support] += lag * w`` (reference :287-374 followed by the ghost-sum
    reduction, which the sharded scatter-add subsumes).

    :param eul_grid_field: field accumulated into (scalar or vector).
    :param lag_grid_field: (n,) or (n_components, n).
    :returns: updated Eulerian field.
    """
    grid_dim = support_idx.shape[0]
    vector = lag_grid_field.ndim == 2
    grid_shape = eul_grid_field.shape[1:] if vector else eul_grid_field.shape
    idx = _support_gather_indices(support_idx, grid_shape)
    # Cast marker-side data to the Eulerian field dtype at the boundary:
    # the reference contract is float32 flow + float64 markers (SURVEY §7
    # hard part 6), and a mixed-dtype scatter-add is a FutureWarning today
    # and an error in future JAX.
    lag_grid_field = lag_grid_field.astype(eul_grid_field.dtype)
    interp_weights = interp_weights.astype(eul_grid_field.dtype)
    if vector:
        n_comp = lag_grid_field.shape[0]
        expand = (slice(None),) + (None,) * grid_dim
        updates = interp_weights[None] * lag_grid_field[expand]
        comp = jnp.arange(n_comp, dtype=jnp.int32).reshape(
            (n_comp,) + (1,) * (grid_dim + 1)
        )
        comp = jnp.broadcast_to(comp, updates.shape)
        bidx = tuple(jnp.broadcast_to(i[None], updates.shape) for i in idx)
        return eul_grid_field.at[(comp, *bidx)].add(updates)
    updates = interp_weights * lag_grid_field
    return eul_grid_field.at[idx].add(updates)
