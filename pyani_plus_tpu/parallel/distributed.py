"""Multi-host distributed runtime: process group init + collective merge.

The replacement for the reference's SLURM scale-out path
(Snakemake executor + shared-filesystem JSON transport + network-shared
SQLite, reference workflows/__init__.py:112-217, db_orm.py:635-702).
Here the process group is a real ``jax.distributed`` runtime:

- :func:`maybe_initialize` wires ``jax.distributed.initialize`` from the
  ``PYANI_TPU_COORDINATOR`` / ``PYANI_TPU_NUM_PROCESSES`` /
  ``PYANI_TPU_PROCESS_ID`` environment (set by the ``launch`` CLI
  command for single-node fan-out, or by the cluster launcher on a real
  cluster). On CPU hosts the Gloo collectives backend is selected so
  the same code path runs in tests and on GPU hosts.
- :func:`broadcast_pending` makes host 0's pending-pair view
  authoritative (hosts need not share a database file).
- :func:`allgather_comparisons` is the result merge: every host's
  comparison rows ride a device all-gather instead of the reference's
  polled JSON files; host 0 alone writes the store, keeping the
  content-addressed INSERT OR IGNORE idempotence for resume.

Rows are encoded losslessly: MD5 hashes as 4 uint32 words each, float
fields (including the integer-valued ones, which are far below 2**53)
as float64 bit-split into uint32 pairs -- uint32 is collective-safe on
every backend, with or without jax x64.
"""

from __future__ import annotations

import logging
import os
from typing import Any

import numpy as np

ENV_COORDINATOR = "PYANI_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "PYANI_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "PYANI_TPU_PROCESS_ID"

_FIELDS = ("identity", "aln_length", "sim_errors", "cov_query", "cov_subject")
# row encoding: 4 + 4 uint32 hash words + 5 fields x 2 uint32 words
_ROW_WORDS = 8 + 2 * len(_FIELDS)

_initialized = False


def is_initialized() -> bool:
    return _initialized


def maybe_initialize(logger: logging.Logger | None = None) -> tuple[int, int]:
    """Join the process group if the launch environment requests one.

    Returns (process_index, process_count); (0, 1) when not distributed.
    Safe to call repeatedly.
    """
    global _initialized
    import jax

    if _initialized:
        return jax.process_index(), jax.process_count()
    coordinator = os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        # Cluster launchers (SLURM srun, Open MPI mpirun) are
        # auto-detected by jax.distributed itself; opt in explicitly so
        # plain single-process runs inside a SLURM allocation stay
        # single-process (the reference's SLURM mode likewise needs
        # --executor slurm). `pyani-plus-tpu launch` sets the explicit
        # coordinator env instead.
        if os.environ.get("PYANI_TPU_AUTO_DISTRIBUTED") and (
            os.environ.get("SLURM_JOB_ID") or os.environ.get("OMPI_COMM_WORLD_SIZE")
        ):
            try:
                jax.config.update("jax_cpu_collectives_implementation", "gloo")
            except Exception:  # pragma: no cover
                pass
            jax.distributed.initialize()  # cluster auto-detection
            _initialized = True
            if logger is not None:
                logger.info(
                    "Joined auto-detected cluster: process %d of %d",
                    jax.process_index(),
                    jax.process_count(),
                )
            return jax.process_index(), jax.process_count()
        return 0, 1
    num = int(os.environ[ENV_NUM_PROCESSES])
    pid = int(os.environ[ENV_PROCESS_ID])
    try:
        # CPU backends need an explicit cross-process collectives
        # implementation; harmless on a GPU backend.
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # pragma: no cover - older/newer config surface
        pass
    jax.distributed.initialize(coordinator, num_processes=num, process_id=pid)
    _initialized = True
    if logger is not None:
        logger.info(
            "Joined distributed runtime: process %d of %d (%d devices total)",
            jax.process_index(),
            jax.process_count(),
            len(jax.devices()),
        )
    return jax.process_index(), jax.process_count()


def _md5_to_words(md5: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(md5), dtype=np.uint32)


def _words_to_md5(words: np.ndarray) -> str:
    return words.astype("<u4").tobytes().hex()


def _encode_rows(rows: list[dict[str, Any]]) -> np.ndarray:
    out = np.zeros((len(rows), _ROW_WORDS), dtype=np.uint32)
    vals = np.full((len(rows), len(_FIELDS)), np.nan, dtype=np.float64)
    for i, row in enumerate(rows):
        out[i, 0:4] = _md5_to_words(row["query_hash"])
        out[i, 4:8] = _md5_to_words(row["subject_hash"])
        for f, name in enumerate(_FIELDS):
            v = row.get(name)
            if v is not None:
                vals[i, f] = float(v)
    out[:, 8:] = vals.view(np.uint32).reshape(len(rows), -1)
    return out


def _decode_rows(packed: np.ndarray) -> list[dict[str, Any]]:
    rows: list[dict[str, Any]] = []
    vals = (
        np.ascontiguousarray(packed[:, 8:])
        .view(np.float64)
        .reshape(packed.shape[0], len(_FIELDS))
    )
    for i in range(packed.shape[0]):
        row: dict[str, Any] = {
            "query_hash": _words_to_md5(packed[i, 0:4]),
            "subject_hash": _words_to_md5(packed[i, 4:8]),
        }
        for f, name in enumerate(_FIELDS):
            v = vals[i, f]
            if np.isnan(v):
                row[name] = None
            elif name in ("aln_length", "sim_errors"):
                row[name] = int(v)
            else:
                row[name] = float(v)
        rows.append(row)
    return rows


def allgather_comparisons(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """Collectively merge every host's comparison rows (returned on all).

    A device all-gather (jax multihost collectives) replaces the
    reference's shared-filesystem JSON import loop
    (workflows/__init__.py:49-109). Duplicate rows from overlapping
    ownership are harmless downstream (INSERT OR IGNORE).
    """
    from jax.experimental import multihost_utils

    local = _encode_rows(rows)
    counts = np.asarray(
        multihost_utils.process_allgather(
            np.array([len(rows)], dtype=np.uint32)
        )
    ).reshape(-1)
    cap = int(counts.max())
    padded = np.zeros((max(cap, 1), _ROW_WORDS), dtype=np.uint32)
    if len(rows):
        padded[: len(rows)] = local
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    merged: list[dict[str, Any]] = []
    for host, count in enumerate(counts):
        if count:
            merged.extend(_decode_rows(gathered[host, :count]))
    return merged


def broadcast_pending(
    pending: set[tuple[str, str]],
    process_index: int,
) -> set[tuple[str, str]]:
    """Make host 0's pending-pair set authoritative on every host.

    Hosts may hold private database files (no shared filesystem
    required); only host 0's store decides what still needs computing.
    """
    from jax.experimental import multihost_utils

    if process_index == 0:
        local = np.zeros((len(pending), 8), dtype=np.uint32)
        for i, (q, s) in enumerate(sorted(pending)):
            local[i, 0:4] = _md5_to_words(q)
            local[i, 4:8] = _md5_to_words(s)
        count = np.array([len(pending)], dtype=np.uint32)
    else:
        local = np.zeros((0, 8), dtype=np.uint32)
        count = np.zeros((1,), dtype=np.uint32)
    count = np.asarray(multihost_utils.broadcast_one_to_all(count))
    k = int(count[0])
    buf = np.zeros((max(k, 1), 8), dtype=np.uint32)
    if process_index == 0 and k:
        buf[:k] = local
    buf = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    return {
        (_words_to_md5(buf[i, 0:4]), _words_to_md5(buf[i, 4:8]))
        for i in range(k)
    }


def launch_local(
    num_processes: int,
    argv: list[str],
    *,
    port: int | None = None,
    timeout: float | None = None,
    quiet: bool = False,
) -> int:
    """Spawn ``num_processes`` copies of this CLI as one process group.

    Single-node fan-out analogue of the reference's Snakemake local
    executor (workflows/__init__.py:158-171), but the workers form a
    real jax.distributed process group and merge results with
    collectives. Returns the worst exit code.

    On a GPU host every rank gets one card of its own
    (``CUDA_VISIBLE_DEVICES``): a JAX process reserves most of a card's
    memory, so two on one card would fail. Asking for more ranks than
    visible cards raises ValueError. The parent never starts JAX.
    """
    import socket
    import subprocess
    import sys

    import tempfile

    from pyani_plus_tpu.device import visible_gpus

    gpus = visible_gpus()
    if gpus and num_processes > len(gpus):
        msg = (
            f"launch -n {num_processes} needs one GPU per process, but only "
            f"{len(gpus)} are visible ({','.join(gpus)})"
        )
        raise ValueError(msg)
    if port is None:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
    procs = []
    logs: list = []
    for pid in range(num_processes):
        env = dict(os.environ)
        env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        env[ENV_NUM_PROCESSES] = str(num_processes)
        env[ENV_PROCESS_ID] = str(pid)
        if gpus:
            env["CUDA_VISIBLE_DEVICES"] = gpus[pid]
        # "{rank}" placeholders let each worker use private paths (e.g.
        # --database run_{rank}.db demonstrates that no shared store is
        # needed: results merge through the collective, host 0 persists)
        worker_argv = [a.replace("{rank}", str(pid)) for a in argv]
        # quiet=True keeps worker output off the parent's stdout
        # (benchmark drivers need it to stay a single JSON line), but
        # captures it in a temp log that is dumped to stderr on a
        # nonzero exit so failures stay diagnosable.
        sink = (
            tempfile.TemporaryFile(prefix=f"pyani-worker-{pid}-")
            if quiet
            else None
        )
        logs.append(sink)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "pyani_plus_tpu.cli.main", *worker_argv],
                env=env,
                stdout=sink,
                stderr=sink,
            )
        )
    worst = 0
    try:
        for p in procs:
            worst = max(worst, p.wait(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:  # kill exact PIDs we spawned, never by pattern
            if p.poll() is None:
                p.kill()
        worst = 124
    # Reap every child (killed ones included -- without this wait their
    # returncode stays None, which both leaks zombies and skipped the
    # log dump for exactly the hang/timeout case it exists for).
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:  # pragma: no cover - kill raced
            pass
    for pid, (p, log) in enumerate(zip(procs, logs)):
        if log is None:
            continue
        if worst != 0 and p.returncode != 0:
            log.seek(0)
            tail = log.read()[-8192:]
            if tail:
                sys.stderr.write(
                    f"[launch] worker {pid} exited {p.returncode}; "
                    f"output tail:\n{tail.decode(errors='replace')}\n"
                )
        log.close()
    return worst
