"""Device mesh construction and field shardings.

JAX replacement for the reference's MPI cartesian-communicator layer
(``MPIConstruct2D/3D``, /root/reference/sopht_mpi/utils/mpi_utils_2d.py:9-84,
mpi_utils_3d.py:7-83). Instead of a cartesian process grid with derived
datatypes and explicit halo messages, we build a ``jax.sharding.Mesh`` over
the devices and assign ``NamedSharding`` s to globally-shaped field arrays;
XLA's SPMD partitioner inserts the communication.

Conventions (mirroring the reference's field layout):
- 2D scalar fields: shape ``(ny, nx)``; mesh axes ``("y", "x")``.
- 3D scalar fields: shape ``(nz, ny, nx)``; mesh axes ``("z", "y")``
  (the x axis always stays local, the analogue of the reference's
  FFT-aligned last axis, mpi_utils_3d.py:32-48).
- Vector fields carry a leading component axis ``(dim, ...)`` which is
  always replicated.

Like the reference's default ``rank_distribution=[0,...,0,1]`` (slab along
the leading axis), the default mesh shape puts all devices on the leading
grid axis.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


MESH_AXES_2D = ("y", "x")
MESH_AXES_3D = ("z", "y")


def create_mesh(
    grid_dim: int,
    mesh_shape: tuple[int, ...] | None = None,
    devices=None,
) -> Mesh:
    """Create a device mesh for a ``grid_dim``-dimensional flow domain.

    :param grid_dim: 2 or 3.
    :param mesh_shape: devices per mesh axis. Defaults to a slab layout
        (all devices on the leading grid axis), the analogue of the
        reference's default ``rank_distribution`` (mpi_utils_2d.py:40-47).
        In 3D a 2-axis (pencil) shape like ``(4, 2)`` shards z and y.
    :param devices: explicit device list (default: ``jax.devices()``).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    axes = mesh_axis_names(grid_dim)
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axes) - 1)
    n_used = int(np.prod(mesh_shape))
    if n_used > n:
        raise ValueError(f"mesh_shape {mesh_shape} needs more than {n} devices")
    dev_array = np.asarray(devices[:n_used]).reshape(mesh_shape)
    return Mesh(dev_array, axes)


def mesh_axis_names(grid_dim: int) -> tuple[str, ...]:
    if grid_dim == 2:
        return MESH_AXES_2D
    elif grid_dim == 3:
        return MESH_AXES_3D
    raise ValueError(f"Invalid grid dim {grid_dim}")


def grid_partition_spec(grid_dim: int) -> P:
    """PartitionSpec for a scalar grid field."""
    if grid_dim == 2:
        return P("y", "x")
    elif grid_dim == 3:
        return P("z", "y", None)
    raise ValueError(f"Invalid grid dim {grid_dim}")


def scalar_field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a scalar field on the grid of ``mesh``'s dimension."""
    grid_dim = 2 if mesh.axis_names == MESH_AXES_2D else 3
    return NamedSharding(mesh, grid_partition_spec(grid_dim))


def vector_field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a vector field (leading component axis replicated)."""
    grid_dim = 2 if mesh.axis_names == MESH_AXES_2D else 3
    spec = grid_partition_spec(grid_dim)
    return NamedSharding(mesh, P(None, *spec))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def check_grid_divisibility(grid_size: tuple[int, ...], mesh: Mesh) -> None:
    """Ensure the grid divides evenly over the mesh (reference enforces the
    same, mpi_utils_2d.py:52-58)."""
    spec = grid_partition_spec(len(grid_size))
    for size, axis in zip(grid_size, spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if size % n != 0:
            raise RuntimeError(
                f"Grid axis of size {size} not divisible by {n} devices on "
                f"mesh axis '{axis}'"
            )


def shard_scalar_field(field, mesh: Mesh | None):
    if mesh is None:
        return field
    return jax.device_put(field, scalar_field_sharding(mesh))


def shard_vector_field(field, mesh: Mesh | None):
    if mesh is None:
        return field
    return jax.device_put(field, vector_field_sharding(mesh))
