"""pyANI-plus-TPU: an accelerator-native all-vs-all Average Nucleotide Identity engine.

A ground-up reimplementation of the capabilities of ``pyani-plus`` (the
reference CLI/library) whose device path runs on an NVIDIA GPU: the
numeric kernels that the reference delegates to external native binaries
(nucmer, blastn, fastANI, minimap2, skani, sourmash/branchwater) are
implemented here as JAX/XLA programs, CUDA and C++ kernels over packed
genome arrays, and the Snakemake/SQLite orchestration is replaced by a
sharded pairwise-tile scheduler over a ``jax.sharding.Mesh``.

Layout (see README.md):

- ``utils/``    -- FASTA parsing, MD5 identity, staging (ref: pyani_plus/utils.py)
- ``genomes/``  -- genome ingestion + 2-bit packed device representation
- ``ops/``      -- the JAX and GPU compute kernels (hashing, sketching, DP, ...)
- ``methods/``  -- the eight ANI "model families" (scoring math per method)
- ``parallel/`` -- device-mesh tile scheduler + collectives merge
- ``db/``       -- content-addressed result store (SQLite, resume semantics)
- ``report/``   -- matrices, export, plots, classify
- ``cli/``      -- the public + private command line interface
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

__version__ = "0.1.0"

# Reference parity: pyani_plus/__init__.py:46-49
LOG_FILE = Path("pyani-plus.log")
LOG_FILE_DYNAMIC = Path("--")  # internal sentinel, not exposed in CLI
FASTA_EXTENSIONS = {".fasta", ".fas", ".fna", ".fa"}  # plus .gz variants
GRAPHICS_FORMATS = ("tsv", "png", "jpg", "svgz", "pdf")


def setup_logger(
    log_file: Path | None,
    *,
    terminal_level: int = logging.INFO,
    plain: bool = False,
) -> logging.Logger:
    """Return a console logger plus an optional always-DEBUG file logger.

    Mirrors the behaviour of the reference ``setup_logger``
    (pyani_plus/__init__.py:61-117): terminal handler at ``terminal_level``
    (Rich console unless ``plain``), file handler always at DEBUG with a
    timestamped format. Use ``None`` or ``Path("-")`` for no log file.
    """
    if log_file == LOG_FILE_DYNAMIC:
        sys.exit("ERROR: Internal flag value for dynamic log setting unresolved")
    logger = logging.getLogger(__package__)
    min_level = min(logging.DEBUG, terminal_level)
    logger.setLevel(min_level)
    if logger.hasHandlers():
        logger.handlers.clear()

    if plain:
        console_handler: logging.Handler = logging.StreamHandler()
        console_handler.setLevel(terminal_level)
    else:
        try:
            from rich.logging import RichHandler

            console_handler = RichHandler(
                level=terminal_level,
                markup=True,
                omit_repeated_times=False,
                show_path=False,
                rich_tracebacks=True,
                tracebacks_suppress=["click"],
            )
        except ImportError:  # pragma: no cover - rich is expected to exist
            console_handler = logging.StreamHandler()
            console_handler.setLevel(terminal_level)
    logger.addHandler(console_handler)

    if log_file and log_file != Path("-"):
        file_handler = logging.FileHandler(log_file, mode="a")
        file_handler.setLevel(logging.DEBUG)
        file_handler.setFormatter(
            logging.Formatter(
                fmt="%(asctime)s %(levelname)9s %(filename)21s:%(lineno)-3s | %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger.addHandler(file_handler)
        logger.info("Logging to '%s'", log_file)
    else:
        logger.debug("Currently not logging to file.")

    return logger


def log_sys_exit(logger: logging.Logger, msg: str) -> None:
    """Log a CRITICAL message then ``sys.exit`` with it.

    Reference parity: pyani_plus/__init__.py:120-126.
    """
    logger.critical(msg)
    sys.exit(msg)
