"""Async field dumps through the native C++ writer (csrc/async_dump.cpp).

High-frequency snapshot/checkpoint output must not block the device step loop
on host filesystem latency - the reference's collective parallel-HDF5
writes (/root/reference/sopht_mpi/utils/mpi_io.py:291) are synchronous by
construction. :class:`AsyncFieldDumper` copies the host array once into the
native writer's queue and returns; a C++ worker thread performs the file
IO. Files are standard ``.npy`` (header built here) so numpy and ParaView
tooling read them directly.

The shared library is compiled on first use with the system ``g++`` and
cached under ``csrc/``. Without a toolchain the dumper transparently falls
back to synchronous ``numpy.save``.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import threading

import numpy as np

_CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc",
)
_LIB_PATH = os.path.join(_CSRC_DIR, "libasyncdump.so")
_SRC_PATH = os.path.join(_CSRC_DIR, "async_dump.cpp")

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> str | None:
    if os.path.exists(_LIB_PATH) and os.path.getmtime(
        _LIB_PATH
    ) >= os.path.getmtime(_SRC_PATH):
        return _LIB_PATH
    try:
        subprocess.run(
            [
                "g++",
                "-O2",
                "-shared",
                "-fPIC",
                "-pthread",
                "-std=c++17",
                "-o",
                _LIB_PATH,
                _SRC_PATH,
            ],
            check=True,
            capture_output=True,
        )
        return _LIB_PATH
    except (OSError, subprocess.CalledProcessError):
        return None


def _load_library():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _build_library()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.adw_create.restype = ctypes.c_void_p
        lib.adw_submit.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_void_p,
            ctypes.c_uint64,
        ]
        lib.adw_pending.argtypes = [ctypes.c_void_p]
        lib.adw_pending.restype = ctypes.c_uint64
        lib.adw_failed.argtypes = [ctypes.c_void_p]
        lib.adw_failed.restype = ctypes.c_uint64
        lib.adw_flush.argtypes = [ctypes.c_void_p]
        lib.adw_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _npy_header(array: np.ndarray) -> bytes:
    """Minimal .npy v1.0 header for a C-contiguous array."""
    descr = np.lib.format.dtype_to_descr(array.dtype)
    shape = array.shape
    d = f"{{'descr': {descr!r}, 'fortran_order': False, 'shape': {shape!r}, }}"
    prefix = b"\x93NUMPY\x01\x00"
    unpadded = len(prefix) + 2 + len(d) + 1
    pad = (64 - unpadded % 64) % 64
    header = d + " " * pad + "\n"
    return prefix + struct.pack("<H", len(header)) + header.encode("latin1")


class AsyncFieldDumper:
    """Queue-based async .npy writer (native worker thread).

    >>> dumper = AsyncFieldDumper()
    >>> dumper.dump("snap_0001.npy", vorticity_field)   # returns immediately
    >>> ...
    >>> dumper.flush()                                   # barrier
    """

    def __init__(self):
        self._lib = _load_library()
        self._handle = self._lib.adw_create() if self._lib is not None else None

    @property
    def is_native(self) -> bool:
        return self._handle is not None

    def dump(self, path: str, array) -> None:
        arr = np.ascontiguousarray(np.asarray(array))
        if self._handle is None:
            np.save(path.removesuffix(".npy"), arr)  # sync fallback
            return
        header = _npy_header(arr)
        self._lib.adw_submit(
            self._handle,
            path.encode(),
            header,
            len(header),
            arr.ctypes.data_as(ctypes.c_void_p),
            arr.nbytes,
        )

    def pending(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.adw_pending(self._handle))

    def failed(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.adw_failed(self._handle))

    def flush(self) -> None:
        if self._handle is not None:
            self._lib.adw_flush(self._handle)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.adw_flush(self._handle)
            self._lib.adw_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
