"""Sharded, async checkpointing of FSI carries via orbax.

The HDF5 ``FieldIO`` path (utils/io.py) keeps on-disk parity with the
reference's MPIIO (same layout + XDMF sidecars,
/root/reference/sopht_mpi/utils/mpi_io.py) but gathers fields to the host
single-controller side — right for visualization, wrong for production
checkpointing at pod scale. This module checkpoints the fused-loop carry
(any ``models.fsi`` carry NamedTuple, or any pytree of arrays) the
JAX way: orbax writes each shard from its device (no host gather of
the global array), asynchronously, with atomic finalization, and restores
with the ORIGINAL shardings reapplied.
"""

from __future__ import annotations

import os

import jax
import numpy as np


class CarryCheckpointer:
    """Save/restore fused-loop carries (or any array pytree) with orbax.

    >>> ckpt = CarryCheckpointer("ckpts")
    >>> ckpt.save(step_index, carry)            # async, per-shard writes
    >>> carry = ckpt.restore(template=carry0)   # shardings from template
    """

    def __init__(self, directory: str):
        import orbax.checkpoint as ocp

        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._ocp = ocp
        self._mgr = ocp.CheckpointManager(self._dir)

    def save(self, step: int, carry, wait: bool = False) -> None:
        """Write checkpoint ``step``; returns immediately (async) unless
        ``wait``.

        DONATION HAZARD: the fused loops donate the carry's device buffers
        into the next ``scan_steps(..., donate=True)`` call, which
        invalidates them while an async save may still be reading. When the
        next thing you do with ``carry`` is a donating scan, pass
        ``wait=True`` (or call :meth:`wait_until_finished` before the
        scan); async saving is only safe when the saved buffers stay
        alive until the save completes."""
        # orbax refuses zero-size arrays; carries may hold content-free
        # placeholders (e.g. the dropped eul_grid_forcing_field of a
        # sparse-forcing carry, init_rigid_fsi_carry(step=...)). Swap them
        # for 1-element placeholders on save; restore() swaps them back
        # from the template (zero-size = nothing to restore).
        import jax.numpy as jnp

        def save_safe(a):
            if getattr(a, "size", 1) == 0:
                return jnp.zeros((1,), a.dtype)
            return a

        self._mgr.save(
            int(step),
            args=self._ocp.args.StandardSave(
                jax.tree_util.tree_map(save_safe, carry)
            ),
        )
        if wait:
            self._mgr.wait_until_finished()

    def latest_step(self) -> int | None:
        return self._mgr.latest_step()

    def restore(self, template, step: int | None = None):
        """Restore into the structure/shardings/dtypes of ``template``
        (typically the freshly-initialised carry)."""
        from jax.sharding import NamedSharding, PartitionSpec

        if step is None:
            step = self._mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self._dir}")
        # Mesh-sharded templates: restore un-mesh-sharded leaves (marker
        # buffers, scalars - uncommitted in a fresh carry) as
        # mesh-REPLICATED arrays, or orbax pins them to one device and the
        # next jitted step fails with incompatible devices.
        mesh = None
        for leaf in jax.tree_util.tree_leaves(template):
            sh = getattr(leaf, "sharding", None)
            if isinstance(sh, NamedSharding):
                mesh = sh.mesh
                break

        def absify(a):
            sh = getattr(a, "sharding", None)
            if mesh is not None and not isinstance(sh, NamedSharding):
                sh = NamedSharding(mesh, PartitionSpec())
            shape = np.shape(a)
            if int(np.prod(shape)) == 0:
                # zero-size leaves were saved as 1-element placeholders
                # (see save()); restore that shape, swap back below. The
                # leaf's own spec can outrank the rank-1 placeholder
                # (e.g. a dropped (3,0,0,0) forcing buffer pinned to the
                # field spec by carry canonicalization) - restore it
                # replicated; the template leaf wins after restore anyway.
                shape = (1,)
                if isinstance(sh, NamedSharding):
                    sh = NamedSharding(sh.mesh, PartitionSpec())
            return jax.ShapeDtypeStruct(shape, a.dtype, sharding=sh)

        abstract = jax.tree_util.tree_map(absify, template)
        restored = self._mgr.restore(
            int(step), args=self._ocp.args.StandardRestore(abstract)
        )
        return jax.tree_util.tree_map(
            lambda t, r: t if getattr(t, "size", 1) == 0 else r,
            template, restored,
        )

    def wait_until_finished(self) -> None:
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.wait_until_finished()
        self._mgr.close()
