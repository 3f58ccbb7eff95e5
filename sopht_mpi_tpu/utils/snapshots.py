"""Non-blocking field snapshots for fused (device-scanned) loops.

The reference wires its parallel-HDF5 IO into every example's time loop
(/root/reference/examples/3d_examples/FlowPastSphereCase/
flow_past_sphere_case.py:129-139, via mpi_io.py) — but those writes are
synchronous. The fused device loops only touch the host at scan-window
boundaries, so snapshotting must not stall the device queue:
:class:`SnapshotWriter` fetches each field once (a device->host copy that
the window boundary already pays for diagnostics anyway) and hands the
bytes to the native async writer (csrc/async_dump.cpp), which does the
file IO on its own C++ thread. Without the toolchain it degrades to
synchronous ``np.save`` transparently (AsyncFieldDumper's own fallback).
"""

from __future__ import annotations

import os

import numpy as np

from sopht_mpi_tpu.utils.native_io import AsyncFieldDumper


class SnapshotWriter:
    """Time-triggered .npy snapshots of named fields.

    >>> snaps = SnapshotWriter(interval=0.5, out_dir="snapshots")
    >>> while running:
    ...     carry, _ = scan_steps(step, carry, window, donate=True)
    ...     snaps.maybe_save(float(carry.time), vorticity=carry.flow_state...)
    >>> snaps.close()

    Files: ``<out_dir>/<name>_<index:04d>.npy`` plus a ``times.csv``
    (index, time) manifest rewritten after every snapshot, so a crashed
    run never leaves snapshots without their time metadata.
    """

    def __init__(self, interval: float, out_dir: str = "snapshots"):
        if interval <= 0:
            raise ValueError("snapshot interval must be positive")
        self.interval = float(interval)
        self.out_dir = out_dir
        self._next_time = 0.0
        self._index = 0
        self._times: list[tuple[int, float]] = []
        self._dumper = AsyncFieldDumper()
        os.makedirs(out_dir, exist_ok=True)

    @property
    def is_native(self) -> bool:
        return self._dumper.is_native

    @property
    def n_saved(self) -> int:
        return self._index

    def maybe_save(self, time: float, **fields) -> bool:
        """Write one snapshot of every field if ``time`` has reached the
        next save point (call at scan-window boundaries; granularity is
        the window length). Returns whether a snapshot was written."""
        if time < self._next_time:
            return False
        for name, field in fields.items():
            path = os.path.join(
                self.out_dir, f"{name}_{self._index:04d}.npy"
            )
            # np.asarray is the single device->host fetch; the dumper
            # copies once into its queue and returns immediately.
            self._dumper.dump(path, np.asarray(field))
        self._times.append((self._index, time))
        self._index += 1
        # keep the index->time manifest current after EVERY snapshot (it
        # is a tiny file): a run that crashes mid-flight must not leave
        # .npy snapshots on disk with no time metadata
        self._write_manifest()
        # schedule strictly after `time` (robust to interval << window dt)
        self._next_time = max(
            self._next_time + self.interval,
            time + 1e-12,
        )
        return True

    def _write_manifest(self) -> None:
        if self._times:
            np.savetxt(
                os.path.join(self.out_dir, "times.csv"),
                np.asarray(self._times),
                delimiter=",",
                header="index,time",
                comments="",
            )

    def flush(self) -> None:
        """Barrier: block until all queued writes hit the filesystem."""
        self._write_manifest()
        self._dumper.flush()

    def failed(self) -> int:
        return self._dumper.failed()

    def close(self) -> None:
        self._write_manifest()
        self._dumper.close()
