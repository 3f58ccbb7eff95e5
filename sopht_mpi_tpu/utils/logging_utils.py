"""Logging for the single-controller JAX runtime.

Counterpart of the reference's ``MPILogger`` / ``MPIFileHandler``
(/root/reference/sopht_mpi/utils/mpi_logger.py): rank-filtered console
logging plus an MPI-shared logfile. JAX's single-controller model has one
Python process driving all devices, so the rank filtering degenerates to a
plain logger; file output is a standard FileHandler (optionally
timestamped, like the reference's :120-134).
"""

from __future__ import annotations

import logging
import sys
from datetime import datetime


class FlowLogger:
    """Console (+ optional file) logger with the reference's API surface."""

    def __init__(self, level=logging.INFO):
        self._logger = logging.getLogger("sopht_mpi_tpu")
        self._logger.setLevel(level)
        if not self._logger.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
            self._logger.addHandler(handler)

    def enable_write_to_logfile(self, filename: str | None = None,
                                timestamp: bool = True):
        """Attach a logfile (reference mpi_logger.py:120-134)."""
        if filename is None:
            filename = "sopht"
        if timestamp:
            filename = f"{filename}_{datetime.now():%Y%m%d_%H%M%S}"
        handler = logging.FileHandler(f"{filename}.log")
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s: %(message)s")
        )
        self._logger.addHandler(handler)

    def debug(self, msg, *a, **k):
        self._logger.debug(msg, *a, **k)

    def info(self, msg, *a, **k):
        self._logger.info(msg, *a, **k)

    def warning(self, msg, *a, **k):
        self._logger.warning(msg, *a, **k)

    def error(self, msg, *a, **k):
        self._logger.error(msg, *a, **k)

    def setLevel(self, level):
        self._logger.setLevel(level)


# module singleton, mirroring the reference's ``logger`` (mpi_logger.py:158)
logger = FlowLogger()
