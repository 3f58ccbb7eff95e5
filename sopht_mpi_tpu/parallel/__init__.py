"""Distributed backbone: device mesh, shardings, and distributed FFT.

JAX counterpart of the reference's L1 MPI runtime
(/root/reference/sopht_mpi/utils/: MPIConstruct, MPIGhostCommunicator,
MPIFieldCommunicator). Halo exchange, scatter/gather and reductions are not
separate subsystems here - they are what XLA's SPMD partitioner emits for
sharded shifted-slice ops, `jax.device_put`, and `jnp` reductions under jit.
"""

from sopht_mpi_tpu.parallel.mesh import (
    MESH_AXES_2D,
    MESH_AXES_3D,
    check_grid_divisibility,
    create_mesh,
    grid_partition_spec,
    mesh_axis_names,
    replicated_sharding,
    scalar_field_sharding,
    shard_scalar_field,
    shard_vector_field,
    vector_field_sharding,
)
from sopht_mpi_tpu.parallel.fft import (
    distributed_rfftn,
    distributed_irfftn,
)
from sopht_mpi_tpu.parallel.distributed import (
    auto_mesh,
    compute_mesh_dims,
    initialize_distributed,
)
