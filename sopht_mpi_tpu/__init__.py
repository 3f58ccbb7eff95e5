"""sopht_mpi_tpu: JAX elastohydrodynamic solver for NVIDIA GPUs.

A ground-up JAX/XLA re-design with the capabilities of the MPI solver
`fankiat/sopht-mpi` (incompressible Navier-Stokes in vorticity form on an
unbounded uniform 2D/3D grid, two-way coupled to Cosserat rods and rigid
bodies via a penalty immersed-boundary method).

Architecture:
- Fields are globally-shaped ``jax.Array`` s with ``NamedSharding`` over a
  ``jax.sharding.Mesh`` of devices; there are no ghost cells and no
  explicit halo choreography - stencils are shifted-slice jnp ops that XLA
  fuses, and whose halo exchanges XLA's SPMD partitioner emits.
- The whole timestep (flow + IBM coupling + structural dynamics) is one
  jitted SPMD program.
- The distributed FFT Poisson solve uses per-axis local FFTs with
  ``lax.all_to_all`` pencil transposes under ``shard_map``.
- Lagrangian markers are replicated across devices (num markers << num grid
  cells); spreading is a masked scatter-add merged with ``psum``.

Reference capability map: see SURVEY.md at the repo root.
"""

from sopht_mpi_tpu import ops, parallel, utils, models

__version__ = "0.1.0"
