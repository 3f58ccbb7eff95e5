"""Multi-host bootstrap and automatic process-grid factoring.

Multi-host counterpart of the reference's ``MPIConstruct2D/3D`` startup logic
(/root/reference/sopht_mpi/utils/mpi_utils_3d.py:7-83): where the reference
calls ``MPI.Compute_dims(world_size, rank_distribution)`` to factor ranks
over the distributable grid axes and ``Create_cart`` to build the topology,
this module factors ``jax.device_count()`` over the shardable mesh axes
(z/y in 3D, y/x in 2D; x always stays FFT-aligned-local in 3D, matching
the reference's default ``rank_distribution=[0,...,0,1]``) and initialises
the JAX distributed runtime on clusters.
"""

from __future__ import annotations

import os


# env hints that a multi-host JAX runtime is expected (the coordinator
# address a launcher exports for jax.distributed.initialize)
_DIST_ENV_HINTS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def initialize_distributed(**kwargs) -> bool:
    """Initialise the JAX distributed runtime when running multi-host.

    Safe to call unconditionally at the top of a driver script (the
    reference's scripts are likewise identical on every rank):

    - explicit kwargs (``coordinator_address=...``) -> always initialise;
    - a coordinator env hint present -> ``jax.distributed.initialize()``
      with auto-detection, which raises if the cluster cannot be joined;
    - plain single-host run -> no-op.

    Returns whether the distributed runtime was (or already is) live.
    """
    import jax

    if getattr(jax.distributed, "is_initialized", None) and (
        jax.distributed.is_initialized()
    ):
        if kwargs:
            raise RuntimeError(
                "jax.distributed is already initialized; the explicit "
                f"configuration {sorted(kwargs)} cannot be applied"
            )
        return True
    if not kwargs and not any(
        os.environ.get(k) is not None for k in _DIST_ENV_HINTS
    ):
        return False
    jax.distributed.initialize(**kwargs)
    return True


def compute_mesh_dims(
    grid_dim: int,
    n_devices: int,
    grid_size: tuple[int, ...] | None = None,
) -> tuple[int, int]:
    """Factor ``n_devices`` over the two shardable mesh axes.

    The reference's ``MPI.Compute_dims`` + even-divisibility check
    (mpi_utils_2d.py:47-58): prefer a slab on the leading axis (halo
    traffic along one axis, and the layout every example defaults to), fall
    back to the most balanced pencil whose axes divide the grid (on a
    balance tie, more devices on the leading axis). Raises when no
    factorization divides the grid evenly.

    :param grid_size: optional global grid shape used for divisibility;
        without it the slab shape is returned directly.
    """
    if grid_dim not in (2, 3):
        raise ValueError(f"Invalid grid dim {grid_dim}")
    if n_devices < 1:
        raise ValueError("n_devices must be positive")
    if grid_size is None:
        return (n_devices, 1)
    # the two shardable grid axes: (z, y) in 3D, (y, x) in 2D
    s0, s1 = int(grid_size[0]), int(grid_size[1])
    candidates = []
    for a in range(n_devices, 0, -1):
        if n_devices % a:
            continue
        b = n_devices // a
        if s0 % a == 0 and s1 % b == 0:
            # rank by balance (the Compute_dims criterion), slab-first on tie
            candidates.append((abs(a - b), -a, (a, b)))
    if not candidates:
        raise RuntimeError(
            f"grid {grid_size[:2]} not evenly divisible over any "
            f"{n_devices}-device mesh factorization"
        )
    slab = (n_devices, 1)
    if any(c[2] == slab for c in candidates):
        return slab
    candidates.sort()
    return candidates[0][2]


def auto_mesh(grid_dim: int, grid_size: tuple[int, ...] | None = None,
              devices=None):
    """``create_mesh`` with the process grid factored automatically
    (slab-first, divisibility-aware) over all available devices."""
    import jax

    from sopht_mpi_tpu.parallel.mesh import create_mesh

    if devices is None:
        devices = jax.devices()
    shape = compute_mesh_dims(grid_dim, len(devices), grid_size)
    return create_mesh(grid_dim, shape, devices)
