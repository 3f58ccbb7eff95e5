"""Field IO: HDF5 checkpoints + XDMF sidecars for ParaView.

Counterpart of the reference's parallel-HDF5 ``MPIIO`` / ``CosseratRodMPIIO``
(/root/reference/sopht_mpi/utils/mpi_io.py:8-792). This framework is
single-controller, so the collective mpio driver, per-rank hyperslabs and
master-rank-only Lagrangian writes disappear; the on-disk layout is kept
compatible (``Eulerian/Scalar|Vector/<name>``, ``Eulerian/Parameters``
attrs, per-grid ``Lagrangian`` groups with optional polyline ``Connection``,
``time`` attr, ``*_eulerian.xmf`` / ``*_<grid>.xmf`` sidecars) so existing
ParaView pipelines work unchanged.

Because JAX arrays are immutable, fields are registered as *bindings*
rather than mutable array views (mpi_io.py registers numpy views and
mutates them on load):

- ``FieldBinding(obj, "attr")``  - full save/load binding (recommended),
- a zero-arg callable           - save-only binding,
- a raw array                   - snapshot (saved as-is; load fills
  ``io.loaded_fields[name]``).

``load`` validates origin/dx/grid_size against the defined grid (restart
consistency, mpi_io.py:483-494) and returns the saved time.
"""

from __future__ import annotations

import numpy as np

try:
    import h5py

    HAS_H5PY = True
except ImportError:  # pragma: no cover - h5py is in the image
    HAS_H5PY = False


class FieldBinding:
    """Binds a field to ``getattr(obj, attr)`` for save and load."""

    def __init__(self, obj, attr: str):
        self.obj = obj
        self.attr = attr

    def get(self):
        return np.asarray(getattr(self.obj, self.attr))

    def get_raw(self):
        """The bound value WITHOUT the host copy - the sharded IO path
        reads device shards directly (save_eulerian_sharded)."""
        return getattr(self.obj, self.attr)

    def set(self, value):
        import jax.numpy as jnp

        current = getattr(self.obj, self.attr)
        setattr(
            self.obj, self.attr, jnp.asarray(value, dtype=current.dtype)
        )


class _Snapshot:
    def __init__(self, array):
        self.array = np.asarray(array)

    def get(self):
        return self.array

    def set(self, value):
        self.array = np.asarray(value)


class _Getter:
    def __init__(self, fn):
        self.fn = fn

    def get(self):
        return np.asarray(self.fn())

    def set(self, value):
        pass  # save-only binding


def _as_binding(value):
    if isinstance(value, FieldBinding):
        return value
    if callable(value):
        return _Getter(value)
    return _Snapshot(value)


class FieldIO:
    """HDF5 + XDMF IO for Eulerian and Lagrangian fields.

    :param dim: grid dimension (2 or 3).
    :param real_dtype: on-disk float dtype.
    """

    def __init__(self, dim: int, real_dtype=np.float64):
        if not HAS_H5PY:
            raise RuntimeError("h5py unavailable; FieldIO disabled")
        assert dim in (2, 3)
        self.dim = dim
        self.real_dtype = np.dtype(real_dtype)
        self.precision = 8 if self.real_dtype == np.float64 else 4
        self.eulerian_grid_defined = False
        self.eulerian_fields: dict[str, object] = {}
        self.eulerian_fields_type: dict[str, str] = {}
        self.lagrangian_grids: dict[str, object] = {}
        self.lagrangian_grid_connection: dict[str, np.ndarray] = {}
        self.lagrangian_fields: dict[str, object] = {}
        self.lagrangian_fields_type: dict[str, str] = {}
        self.lagrangian_fields_with_grid_name: dict[str, list] = {}
        self.lagrangian_grid_count = 0
        self.loaded_fields: dict[str, np.ndarray] = {}

    # -- registration ---------------------------------------------------------

    def define_eulerian_grid(self, origin, dx, grid_size, ghost_size=0):
        """Define the global Eulerian grid (z-y-x ordered arrays). The
        ``ghost_size`` argument is accepted for API parity and must be 0 -
        fields here are ghost-free."""
        assert ghost_size == 0, "fields are ghost-free"
        self.eulerian_origin = np.asarray(origin, dtype=np.float64)
        self.eulerian_dx = np.asarray(dx, dtype=np.float64)
        self.eulerian_grid_size = np.asarray(grid_size, dtype=np.int64)
        self.eulerian_grid_defined = True

    def add_as_eulerian_fields_for_io(self, **fields_for_io):
        for name, value in fields_for_io.items():
            binding = _as_binding(value)
            field = binding.get()
            if field.ndim == self.dim:
                ftype = "Scalar"
            elif field.ndim == self.dim + 1 and field.shape[0] == self.dim:
                ftype = "Vector"
            else:
                raise ValueError(
                    f"Unable to identify eulerian field type for shape "
                    f"{field.shape}"
                )
            self.eulerian_fields[name] = binding
            self.eulerian_fields_type[name] = ftype

    def add_as_lagrangian_fields_for_io(
        self,
        lagrangian_grid,
        lagrangian_grid_name=None,
        lagrangian_grid_connect=False,
        lagrangian_grid_master_rank=0,  # accepted for API parity; unused
        **fields_for_io,
    ):
        """Register a Lagrangian grid (positions binding, (dim, N)) and
        fields living on it."""
        grid_binding = _as_binding(lagrangian_grid)
        grid = grid_binding.get()
        assert grid.ndim == 2 and grid.shape[0] == self.dim
        if lagrangian_grid_name is None:
            lagrangian_grid_name = f"Lagrangian_grid_{self.lagrangian_grid_count}"
            self.lagrangian_grid_count += 1
        num_nodes = grid.shape[1]
        self.lagrangian_grids[lagrangian_grid_name] = grid_binding
        if lagrangian_grid_connect:
            self.lagrangian_grid_connection[lagrangian_grid_name] = np.arange(
                num_nodes, dtype=np.int64
            )
        self.lagrangian_fields_with_grid_name[lagrangian_grid_name] = []
        for name, value in fields_for_io.items():
            binding = _as_binding(value)
            field = binding.get()
            if field.shape == (num_nodes,):
                ftype = "Scalar"
            elif field.shape == grid.shape:
                ftype = "Vector"
            else:
                raise ValueError(
                    f"Unable to identify lagrangian field type for shape "
                    f"{field.shape}"
                )
            self.lagrangian_fields[name] = binding
            self.lagrangian_fields_type[name] = ftype
            self.lagrangian_fields_with_grid_name[lagrangian_grid_name].append(
                name
            )

    # -- save -------------------------------------------------------------------

    def save(self, h5_file_name: str, time=0.0):
        with h5py.File(h5_file_name, "w") as f:
            f.attrs["time"] = time
            if self.eulerian_grid_defined and self.eulerian_fields:
                grp = f.create_group("Eulerian")
                sgrp = grp.create_group("Scalar")
                vgrp = grp.create_group("Vector")
                for name, binding in self.eulerian_fields.items():
                    field = np.asarray(binding.get(), dtype=self.real_dtype)
                    if self.eulerian_fields_type[name] == "Scalar":
                        # 2D fields stored as a z=1 slab (ParaView
                        # 2DCORECTMesh workaround, mpi_io.py:303-310)
                        sgrp.create_dataset(
                            name, data=field.reshape(self._disk_shape())
                        )
                    else:
                        for c in range(self.dim):
                            vgrp.create_dataset(
                                f"{name}_{c}",
                                data=field[c].reshape(self._disk_shape()),
                            )
                pgrp = grp.create_group("Parameters")
                pgrp.attrs["origin"] = self.eulerian_origin
                pgrp.attrs["dx"] = self.eulerian_dx
                pgrp.attrs["grid_size"] = self.eulerian_grid_size
            for grid_name, grid_binding in self.lagrangian_grids.items():
                ggrp = f.create_group(grid_name)
                ggrp.create_dataset(
                    "position",
                    data=np.asarray(grid_binding.get(), dtype=self.real_dtype),
                )
                if grid_name in self.lagrangian_grid_connection:
                    ggrp.create_dataset(
                        "Connection",
                        data=self.lagrangian_grid_connection[grid_name],
                    )
                sgrp = ggrp.create_group("Scalar")
                vgrp = ggrp.create_group("Vector")
                for name in self.lagrangian_fields_with_grid_name[grid_name]:
                    field = np.asarray(
                        self.lagrangian_fields[name].get(),
                        dtype=self.real_dtype,
                    )
                    target = (
                        sgrp
                        if self.lagrangian_fields_type[name] == "Scalar"
                        else vgrp
                    )
                    target.create_dataset(name, data=field)
        if self.eulerian_fields:
            self.generate_xdmf_eulerian(h5_file_name, time=time)
        if self.lagrangian_grids:
            self.generate_xdmf_lagrangian(h5_file_name, time=time)

    def _disk_shape(self):
        gs = tuple(int(s) for s in self.eulerian_grid_size)
        return (1, *gs) if self.dim == 2 else gs

    # -- sharded (scale-out) Eulerian dumps -----------------------------------
    #
    # FieldIO.save gathers the global field to one host before writing -
    # fine on one chip, a serialization funnel for pod-scale dumps. The
    # sharded mode is the JAX analogue of the reference's collective
    # hyperslab writes (every MPI rank streams its local block,
    # /root/reference/sopht_mpi/utils/mpi_io.py:291,310-336): every JAX
    # PROCESS writes one file containing only the shards it addresses,
    # streamed one shard at a time (a device->host copy of one block, never
    # the global field), with each block's global hyperslab offsets stored
    # alongside. Restart on the same mesh re-uploads each block straight to
    # its device via jax.make_array_from_single_device_arrays.

    def save_eulerian_sharded(self, h5_file_name: str, time=0.0):
        """Per-shard Eulerian dump; writes ``<h5_file_name>.proc<r>.h5``
        for this process (process 0 also records grid parameters). Only
        Eulerian fields participate (Lagrangian state is marker-sized and
        replicated - use :meth:`save` for it)."""
        import jax

        rank = jax.process_index()
        fname = f"{h5_file_name}.proc{rank}.h5"
        with h5py.File(fname, "w") as f:
            f.attrs["time"] = time
            f.attrs["process"] = rank
            f.attrs["n_processes"] = jax.process_count()
            if rank == 0:
                pgrp = f.create_group("Parameters")
                pgrp.attrs["origin"] = self.eulerian_origin
                pgrp.attrs["dx"] = self.eulerian_dx
                pgrp.attrs["grid_size"] = self.eulerian_grid_size
            for name, binding in self.eulerian_fields.items():
                # raw device array (no host gather); plain numpy bindings
                # degrade to one process-0 block covering the whole field
                arr = getattr(binding, "get_raw", binding.get)()
                grp = f.create_group(name)
                grp.attrs["ftype"] = self.eulerian_fields_type[name]
                grp.attrs["global_shape"] = np.asarray(arr.shape, np.int64)
                if not hasattr(arr, "addressable_shards"):
                    d = grp.create_dataset(
                        "shard_d0", data=np.asarray(arr, self.real_dtype)
                    )
                    d.attrs["start"] = np.zeros(arr.ndim, np.int64)
                    continue
                for sh in arr.addressable_shards:
                    # one device->host copy of ONE block; the global field
                    # never materializes on the host
                    block = np.asarray(sh.data, dtype=self.real_dtype)
                    d = grp.create_dataset(f"shard_d{sh.device.id}",
                                           data=block)
                    d.attrs["start"] = np.asarray(
                        [s.start or 0 for s in sh.index], np.int64
                    )

    def load_eulerian_sharded(self, h5_file_name: str):
        """Restore from :meth:`save_eulerian_sharded` files; every block
        re-uploads straight to the device that addresses it under each
        binding's CURRENT sharding (same-mesh restart - the layout the
        blocks were written in). Validates grid parameters; returns the
        saved time."""
        import glob

        import jax

        files = sorted(glob.glob(f"{h5_file_name}.proc*.h5"))
        if not files:
            raise FileNotFoundError(f"{h5_file_name}.proc*.h5")
        # read every block's (start -> array) map per field
        blocks: dict[str, dict[tuple, np.ndarray]] = {}
        time = None
        for path in files:
            with h5py.File(path, "r") as f:
                if "Parameters" in f:
                    time = f.attrs["time"]
                    np.testing.assert_allclose(
                        self.eulerian_origin, f["Parameters"].attrs["origin"]
                    )
                    np.testing.assert_allclose(
                        self.eulerian_dx, f["Parameters"].attrs["dx"]
                    )
                    np.testing.assert_allclose(
                        self.eulerian_grid_size,
                        f["Parameters"].attrs["grid_size"],
                    )
                for name in self.eulerian_fields:
                    if name not in f:
                        continue
                    grp = f[name]
                    for key in grp:
                        d = grp[key]
                        blocks.setdefault(name, {})[
                            tuple(int(s) for s in d.attrs["start"])
                        ] = np.asarray(d)
        assert time is not None, "no Parameters group in any shard file"
        for name, binding in self.eulerian_fields.items():
            current = getattr(binding, "get_raw", binding.get)()
            sharding = getattr(current, "sharding", None)
            field_blocks = blocks[name]
            if sharding is None or not hasattr(
                sharding, "addressable_devices"
            ):
                # unsharded binding: assemble on host
                out = np.zeros(current.shape, self.real_dtype)
                for start, blk in field_blocks.items():
                    sl = tuple(
                        slice(s, s + n) for s, n in zip(start, blk.shape)
                    )
                    out[sl] = blk
                binding.set(out.astype(current.dtype))
                self.loaded_fields[name] = out
                continue
            import jax as _jax

            dev_map = sharding.addressable_devices_indices_map(current.shape)
            parts = []
            for dev, idx in dev_map.items():
                start = tuple(int(s.start or 0) for s in idx)
                if start not in field_blocks:
                    raise ValueError(
                        f"sharded restart of '{name}': no stored block at "
                        f"offsets {start} - the files were written under a "
                        "different mesh/layout (reload via the gathered "
                        "FieldIO.save/load path instead)"
                    )
                parts.append(
                    _jax.device_put(
                        field_blocks[start].astype(current.dtype), dev
                    )
                )
            arr = _jax.make_array_from_single_device_arrays(
                current.shape, sharding, parts
            )
            binding.set(arr)
            self.loaded_fields[name] = arr
        return time

    # -- load ---------------------------------------------------------------

    def load(self, h5_file_name: str):
        """Load registered fields back through their bindings; returns the
        saved time. Validates grid parameters (restart consistency,
        mpi_io.py:483-494)."""
        with h5py.File(h5_file_name, "r") as f:
            time = f.attrs["time"]
            if self.eulerian_fields:
                assert self.eulerian_grid_defined, "Eulerian grid undefined"
                np.testing.assert_allclose(
                    self.eulerian_origin,
                    f["Eulerian/Parameters"].attrs["origin"],
                )
                np.testing.assert_allclose(
                    self.eulerian_dx, f["Eulerian/Parameters"].attrs["dx"]
                )
                np.testing.assert_allclose(
                    self.eulerian_grid_size,
                    f["Eulerian/Parameters"].attrs["grid_size"],
                )
                gs = tuple(int(s) for s in self.eulerian_grid_size)
                for name, binding in self.eulerian_fields.items():
                    if self.eulerian_fields_type[name] == "Scalar":
                        data = np.asarray(f[f"Eulerian/Scalar/{name}"]).reshape(
                            gs
                        )
                    else:
                        data = np.stack(
                            [
                                np.asarray(
                                    f[f"Eulerian/Vector/{name}_{c}"]
                                ).reshape(gs)
                                for c in range(self.dim)
                            ]
                        )
                    binding.set(data)
                    self.loaded_fields[name] = data
            for grid_name, grid_binding in self.lagrangian_grids.items():
                data = np.asarray(f[f"{grid_name}/position"])
                grid_binding.set(data)
                self.loaded_fields[f"{grid_name}/position"] = data
                for name in self.lagrangian_fields_with_grid_name[grid_name]:
                    sub = (
                        "Scalar"
                        if self.lagrangian_fields_type[name] == "Scalar"
                        else "Vector"
                    )
                    data = np.asarray(f[f"{grid_name}/{sub}/{name}"])
                    self.lagrangian_fields[name].set(data)
                    self.loaded_fields[name] = data
        return time

    # -- XDMF -----------------------------------------------------------------

    def generate_xdmf_eulerian(self, h5_file_name: str, time=0.0):
        """XDMF sidecar (3DCORECTMesh + ORIGIN_DXDYDZ; 2D embedded as a
        z=1 slab, mpi_io.py:556-650)."""
        gs = self.eulerian_grid_size
        origin = self.eulerian_origin
        dx = self.eulerian_dx
        if self.dim == 2:
            gs = np.insert(gs, 0, 1)
            origin = np.insert(origin, 0, 0.0)
            dx = np.insert(dx, 0, 0.0)
        gs_s = "    ".join(str(int(v)) for v in gs)
        origin_s = "    ".join(f"{v:.{self.precision}g}" for v in origin)
        dx_s = "    ".join(f"{v:.{self.precision}g}" for v in dx)

        entries = []
        for name, ftype in self.eulerian_fields_type.items():
            names = (
                [name]
                if ftype == "Scalar"
                else [f"{name}_{c}" for c in range(self.dim)]
            )
            for nm in names:
                entries.append(
                    f'<Attribute Name="{nm}" Active="1" '
                    f'AttributeType="Scalar" Center="Node">\n'
                    f'  <DataItem Dimensions="{gs_s}" NumberType="Float" '
                    f'Precision="{self.precision}" Format="HDF">\n'
                    f"    {h5_file_name}:/Eulerian/{ftype}/{nm}\n"
                    f"  </DataItem>\n</Attribute>"
                )
        body = "\n".join(entries)
        xmf = f"""<?xml version="1.0" ?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf xmlns:xi="http://www.w3.org/2003/XInclude" Version="2.2">
  <Domain>
    <Grid GridType="Uniform">
      <Time Value="{time}"/>
      <Topology TopologyType="3DCORECTMesh" Dimensions="{gs_s}"/>
      <Geometry GeometryType="ORIGIN_DXDYDZ">
        <DataItem Name="Origin" Dimensions="3" NumberType="Float" Format="XML">
          {origin_s if self.dim == 3 else origin_s}
        </DataItem>
        <DataItem Name="Spacing" Dimensions="3" NumberType="Float" Format="XML">
          {dx_s}
        </DataItem>
      </Geometry>
{body}
    </Grid>
  </Domain>
</Xdmf>
"""
        with open(h5_file_name.replace(".h5", "_eulerian.xmf"), "w") as f:
            f.write(xmf)

    def generate_xdmf_lagrangian(self, h5_file_name: str, time=0.0):
        """Per-grid XDMF sidecars (Polyvertex, or Polyline when a
        Connection was registered; mpi_io.py:652-749)."""
        for grid_name, grid_binding in self.lagrangian_grids.items():
            grid = grid_binding.get()
            n = grid.shape[1]
            connected = grid_name in self.lagrangian_grid_connection
            topo = (
                f'<Topology TopologyType="Polyline" NodesPerElement="{n}">'
                f'\n  <DataItem Dimensions="1 {n}" NumberType="Int" '
                f'Format="HDF">\n    {h5_file_name}:/{grid_name}/Connection'
                f"\n  </DataItem>\n</Topology>"
                if connected
                else f'<Topology TopologyType="Polyvertex" '
                f'NumberOfElements="{n}"/>'
            )
            geom_type = "XY" if self.dim == 2 else "XYZ"
            entries = []
            for name in self.lagrangian_fields_with_grid_name[grid_name]:
                ftype = self.lagrangian_fields_type[name]
                dims = f"{n}" if ftype == "Scalar" else f"{self.dim} {n}"
                entries.append(
                    f'<Attribute Name="{name}" Active="1" '
                    f'AttributeType="{ftype}" Center="Node">\n'
                    f'  <DataItem Dimensions="{dims}" NumberType="Float" '
                    f'Precision="{self.precision}" Format="HDF">\n'
                    f"    {h5_file_name}:/{grid_name}/{ftype}/{name}\n"
                    f"  </DataItem>\n</Attribute>"
                )
            body = "\n".join(entries)
            xmf = f"""<?xml version="1.0" ?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf xmlns:xi="http://www.w3.org/2003/XInclude" Version="2.2">
  <Domain>
    <Grid GridType="Uniform">
      <Time Value="{time}"/>
      {topo}
      <Geometry GeometryType="{geom_type}">
        <DataItem Dimensions="{grid.shape[1]} {self.dim}" NumberType="Float"
        Precision="{self.precision}" Format="HDF">
          {h5_file_name}:/{grid_name}/position
        </DataItem>
      </Geometry>
{body}
    </Grid>
  </Domain>
</Xdmf>
"""
            with open(
                h5_file_name.replace(".h5", f"_{grid_name}.xmf"), "w"
            ) as f:
                f.write(xmf)


class CosseratRodIO(FieldIO):
    """Rod-specific IO (counterpart of ``CosseratRodMPIIO``,
    mpi_io.py:752-792): element-center positions as the Lagrangian grid
    with a polyline connection and the radius as a scalar field."""

    def __init__(self, cosserat_rod, real_dtype=np.float64, dim: int = 3):
        super().__init__(dim=dim, real_dtype=real_dtype)
        self.cosserat_rod = cosserat_rod

        def element_positions():
            pos = np.asarray(cosserat_rod.position_collection)
            return 0.5 * (pos[:dim, 1:] + pos[:dim, :-1])

        self.add_as_lagrangian_fields_for_io(
            lagrangian_grid=element_positions,
            lagrangian_grid_name="rod",
            lagrangian_grid_connect=True,
            radius=lambda: np.asarray(cosserat_rod.radius),
        )


def save_rod_state(cosserat_rod, h5_file_name: str, time=0.0):
    """Full rod dynamic-state checkpoint (counterpart of PyElastica's
    ``ea.save_state`` used for restarts,
    flow_past_freely_rotating_rod_case.py:199-246)."""
    with h5py.File(h5_file_name, "w") as f:
        f.attrs["time"] = time
        for name, arr in cosserat_rod.get_state_arrays().items():
            f.create_dataset(name, data=arr)


def load_rod_state(cosserat_rod, h5_file_name: str):
    """Restore a rod state checkpoint; returns the saved time."""
    with h5py.File(h5_file_name, "r") as f:
        arrays = {name: np.asarray(f[name]) for name in f.keys()}
        time = f.attrs["time"]
    cosserat_rod.set_state_arrays(arrays)
    return time
