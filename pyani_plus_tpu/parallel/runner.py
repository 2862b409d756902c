"""The run driver: ingest genomes, compute pending pairs, persist, cache.

Mirrors the reference's ``start_and_run_method`` + ``run_method`` flow
(public_cli.py:115-329) minus the Snakemake/subprocess machinery:

1. validate the FASTA directory, MD5-index every genome (duplicate-MD5
   error, public_cli.py:158-173);
2. idempotently record genomes / configuration / run rows;
3. derive the pending (query, subject) pair set from the store --
   comparisons computed by any earlier run with the same configuration
   are reused, never recomputed (db_orm.py:222-228 semantics);
4. hand whole tiles of pending pairs to the method kernel;
5. bulk INSERT OR IGNORE results, verify N^2 completeness, cache the
   five matrices on the run row, set status "Done".

Interrupts (SIGINT/SIGTERM) are caught so completed comparisons are
flushed and the run is marked "Worker interrupted" -- same graceful
recovery contract as the reference workers (private_cli.py:816-823).
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Any

from pyani_plus_tpu import log_sys_exit
from pyani_plus_tpu.db import Database, Run
from pyani_plus_tpu.genomes import Genome, load_genome
from pyani_plus_tpu.methods import ComputeContext, get_method
from pyani_plus_tpu.utils import check_fasta, file_md5sum


def index_fasta_directory(
    logger: logging.Logger, fasta: Path
) -> dict[str, Path]:
    """MD5-index a FASTA directory; error on duplicate genome content."""
    filename_to_hash = {f: file_md5sum(f) for f in check_fasta(logger, fasta)}
    hash_to_filename: dict[str, Path] = {}
    for filename, md5 in filename_to_hash.items():
        if md5 in hash_to_filename:
            msg = (
                f"Multiple genomes with same MD5 checksum {md5}:\n"
                f" - {hash_to_filename[md5]}\n - {filename}"
            )
            log_sys_exit(logger, msg)
        hash_to_filename[md5] = filename
    return hash_to_filename


def start_and_run_method(  # noqa: PLR0913
    logger: logging.Logger,
    database: Path | str,
    fasta: Path,
    method_name: str,
    *,
    name: str | None = None,
    cmdline: str = "",
    create_db: bool = False,
    cache: Path | None = None,
    extra_files: dict[str, Path] | None = None,
    **params: Any,
) -> int:
    """Full run of one method over a FASTA directory; returns run_id."""
    method = get_method(method_name)
    config = method.configuration(**params)

    # Ingest problems (broken symlinks, empty/gzip-mismatched FASTA
    # files) raise ValueError from the genome layer; surface them as the
    # reference does -- one CRITICAL log line and a clean exit, never a
    # traceback (public_cli's log_sys_exit discipline).
    try:
        hash_to_filename = index_fasta_directory(logger, fasta)
        logger.info("Indexed %d genomes from %s", len(hash_to_filename), fasta)

        db = Database(database, create=create_db, logger=logger)
    except ValueError as exc:
        log_sys_exit(logger, str(exc))
        raise  # pragma: no cover - log_sys_exit raises SystemExit
    try:
        # _setup_run loads every genome (the remaining ingest-error
        # surface: empty/gzip-mismatched FASTA); resume_run is NOT
        # wrapped -- a ValueError from inside method compute is a bug
        # and must keep its traceback, not masquerade as input error.
        try:
            run = _setup_run(
                logger, db, fasta, config, hash_to_filename, name,
                cmdline, method_name
            )
        except ValueError as exc:
            log_sys_exit(logger, str(exc))
            raise  # pragma: no cover - log_sys_exit raises SystemExit
        return resume_run(
            logger,
            db,
            run,
            hash_to_filename=hash_to_filename,
            cache=cache,
            extra_files=extra_files,
        )
    finally:
        db.close()


def _setup_run(  # noqa: PLR0913
    logger: logging.Logger,
    db: Database,
    fasta: Path,
    config: dict[str, Any],
    hash_to_filename: dict[str, Path],
    name: str | None,
    cmdline: str,
    method_name: str,
) -> Run:
    configuration = db.get_or_create_configuration(
        config["method"],
        config["program"],
        config["version"],
        fragsize=config.get("fragsize"),
        mode=config.get("mode"),
        kmersize=config.get("kmersize"),
        minmatch=config.get("minmatch"),
        extra=config.get("extra"),
    )
    for md5, filename in hash_to_filename.items():
        genome = load_genome(filename, md5)
        db.add_genome(md5, str(filename), genome.length, genome.description)
    n = len(hash_to_filename)
    return db.add_run(
        configuration.configuration_id,
        cmdline,
        str(fasta),
        "Initialising",
        name or f"{n} genomes using {method_name}",
        [(md5, filename.name) for md5, filename in hash_to_filename.items()],
    )


def _progress_bar(label: str, total: int):
    """(context manager, advance callback) for a live progress bar.

    The reference's Rich progress columns (__init__.py:50-58; progress
    there is polled from the DB by a separate process -- here the
    methods tick the context directly). Without ``rich`` the run goes on
    with no bar: the compute path needs only numpy, scipy and JAX.
    """
    try:
        from rich.progress import (
            BarColumn,
            MofNCompleteColumn,
            Progress,
            SpinnerColumn,
            TimeElapsedColumn,
        )
    except ImportError:
        return contextlib.nullcontext(), lambda _n: None
    progress = Progress(
        SpinnerColumn(),
        "[progress.description]{task.description}",
        BarColumn(),
        MofNCompleteColumn(),
        TimeElapsedColumn(),
        transient=True,
    )
    task_id = progress.add_task(label, total=total)
    return progress, lambda n: progress.advance(task_id, n)


@contextlib.contextmanager
def _defer_interrupts(logger: logging.Logger):
    """Queue SIGINT/SIGTERM for the duration of run finalisation.

    Once the comparisons are computed, persisting them and caching the
    matrices is strictly better than abandoning the run mid-commit: an
    interrupt here would leave a fully-computed run stuck "Running"
    (unresumable work lost to a race). Signals received while deferred
    are logged after the store is consistent.
    """
    import signal

    received: list[int] = []
    saved = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            saved[sig] = signal.signal(
                sig, lambda signum, _frame: received.append(signum)
            )
        except ValueError:  # pragma: no cover - non-main thread
            pass
    try:
        yield
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
        if received:  # pragma: no cover - timing dependent
            logger.warning(
                "Interrupt received during run finalisation; results were "
                "already complete and have been persisted"
            )


def resume_run(  # noqa: PLR0913, C901
    logger: logging.Logger,
    db: Database,
    run: Run,
    *,
    hash_to_filename: dict[str, Path] | None = None,
    cache: Path | None = None,
    extra_files: dict[str, Path] | None = None,
) -> int:
    """Compute whatever comparisons the run still needs; finalise it."""
    config_obj = run.configuration
    config = {
        "method": config_obj.method,
        "program": config_obj.program,
        "version": config_obj.version,
        "fragsize": config_obj.fragsize,
        "mode": config_obj.mode,
        "kmersize": config_obj.kmersize,
        "minmatch": config_obj.minmatch,
        "extra": config_obj.extra,
    }
    method = get_method(config_obj.method)

    # Reference resume re-validates before any compute
    # (public_cli.py:751-807): the recorded program version must match
    # the one running now, and every input FASTA must still exist.
    from pyani_plus_tpu import __version__

    if config_obj.version and config_obj.version != __version__:
        log_sys_exit(
            logger,
            f"Run {run.run_id} used {config_obj.program} version "
            f"{config_obj.version}, but this is {__version__} -- cannot "
            "resume (rerun instead; matching the reference's tool-version "
            "equality check)",
        )

    hashes = run.genome_hashes
    n = len(hashes)
    if hash_to_filename is None:
        hash_to_filename = {
            h: Path(run.fasta_directory) / f for h, f in run.hash_to_filename.items()
        }

    # Join the jax.distributed process group when launched as one (the
    # `launch` command or a cluster launcher sets the coordinator env).
    from pyani_plus_tpu.parallel import distributed

    dist_index, dist_count = distributed.maybe_initialize(logger)
    collective = distributed.is_initialized() and dist_count > 1

    done = db.existing_pairs(run.configuration_id, hashes)
    pending = {
        (q, s) for q in hashes for s in hashes if (q, s) not in done
    }
    if collective:
        # Host 0's store is authoritative; workers may hold private
        # database files (no shared filesystem needed).
        pending = distributed.broadcast_pending(pending, dist_index)
    logger.info(
        "Run %d: %d of %d comparisons already done, %d pending",
        run.run_id,
        n * n - len(pending),
        n * n,
        len(pending),
    )

    # Multi-host sharding: each host owns a static slice of the pair grid
    # (parallel/tiles.owned_pairs); the content-addressed INSERT OR IGNORE
    # store makes the merge idempotent, and `resume` sweeps up any pairs
    # a dead host never computed. Host identity comes from an initialised
    # jax.distributed runtime or the PYANI_TPU_PROCESS_{INDEX,COUNT} env.
    import os

    proc_count = int(os.environ.get("PYANI_TPU_PROCESS_COUNT", "0"))
    proc_index = int(os.environ.get("PYANI_TPU_PROCESS_INDEX", "0"))
    if not proc_count:
        try:
            import jax

            proc_count = jax.process_count()
            proc_index = jax.process_index()
        except Exception:  # pragma: no cover - jax unavailable
            proc_count = 1
    if proc_count > 1:
        from pyani_plus_tpu.parallel.tiles import owned_pairs

        index = {h: i for i, h in enumerate(hashes)}
        mine = {
            (hashes[q], hashes[s]) for q, s in owned_pairs(n, proc_index, proc_count)
        }
        pending &= mine
        logger.info(
            "Host %d/%d owns %d of the pending pairs",
            proc_index,
            proc_count,
            len(pending),
        )

    interrupted = False
    rows: list[dict] = []
    if pending:
        # SLURM sends SIGTERM; convert to KeyboardInterrupt so the
        # graceful-interrupt path runs (ref private_cli.py:816-823)
        import signal

        def _terminate(_signum, _frame):  # pragma: no cover - signal path
            raise KeyboardInterrupt

        try:
            signal.signal(signal.SIGTERM, _terminate)
        except ValueError:  # pragma: no cover - non-main thread
            pass

        # EVERYTHING from here on is interrupt-protected -- an interrupt
        # while genomes load or the backend initialises must still leave
        # the run in "Worker interrupted", not stuck "Running" (the
        # reference installs its handlers before any per-column work,
        # private_cli.py:816-823).
        ctx = None
        try:
            run.set_status("Running")
            genomes: dict[str, Genome] = {}
            for md5 in hashes:
                genomes[md5] = load_genome(hash_to_filename[md5], md5)

            def flush(rows: list[dict]) -> None:
                # Incremental persist: INSERT OR IGNORE makes repeats
                # harmless
                db.insert_comparisons(
                    rows, configuration_id=run.configuration_id
                )
                logger.debug("Flushed %d comparisons", len(rows))

            progress, advance = _progress_bar(
                f"{config.get('method', 'ANI')} comparisons", len(pending)
            )

            ctx = ComputeContext(
                logger=logger,
                genomes=genomes,
                query_hashes=hashes,
                subject_hashes=hashes,
                pending=pending,
                config=config,
                cache=cache,
                extra_files=extra_files or {},
                progress=advance,
                flush=flush,
            )
            # Real profiling (the reference has none -- SURVEY.md
            # section 5): PYANI_TPU_PROFILE=<dir> captures a jax
            # profiler trace of the compute phase (TensorBoard/XProf).
            profile_dir = os.environ.get("PYANI_TPU_PROFILE")
            with progress:
                if profile_dir:
                    import jax

                    with jax.profiler.trace(profile_dir):
                        rows = method.compute(ctx)
                    logger.info("Wrote profiler trace to %s", profile_dir)
                else:
                    rows = method.compute(ctx)
        except KeyboardInterrupt:
            if not collective:
                logger.error("Interrupted; marking run as 'Worker interrupted'")
                run.set_status("Worker interrupted")
                return run.run_id
            # In a process group, still join the merge below with
            # whatever was completed so the peers don't deadlock.
            interrupted = True
        interrupted = interrupted or (ctx is not None and ctx.interrupted)

    if collective:
        # Collective result merge (a device all-gather) replaces the
        # reference's polled JSON import; every host receives the union
        # so host 0's store ends complete even when workers used private
        # databases. EVERY host joins, including those with no pending
        # share (the gather is also the completion barrier). The gather
        # stays OUTSIDE the signal-defer window: it is a network barrier
        # that blocks indefinitely if a peer host dies, and the worker
        # must remain interruptible during it -- an interrupt falls
        # through to persist whatever this host computed locally.
        try:
            gathered = distributed.allgather_comparisons(rows)
            logger.info(
                "Collective merge: %d local + %d remote comparisons",
                len(rows),
                len(gathered) - len(rows),
            )
            rows = gathered if dist_index == 0 else rows
        except KeyboardInterrupt:  # pragma: no cover - timing dependent
            logger.error("Interrupted during collective merge; keeping "
                         "this host's local results")
            interrupted = True
    with _defer_interrupts(logger):
        if rows:
            db.insert_comparisons(rows, configuration_id=run.configuration_id)
        if interrupted:
            # Partial results are saved; leave the run resumable
            run.set_status("Worker interrupted")
            logger.error("Run %d interrupted; partial results saved", run.run_id)
            return run.run_id

        final = run.comparisons_count()
        if final != n * n:
            if proc_count > 1:
                # Another host still owns the missing pairs; whoever finishes
                # last (or a `resume`) completes and caches the run.
                logger.info(
                    "Host %d/%d done with its share: %d of %d comparisons stored",
                    proc_index,
                    proc_count,
                    final,
                    n * n,
                )
                return run.run_id
            msg = (
                f"Run {run.run_id} has {final} of {n}²={n * n} comparisons"
                " after compute -- method returned incomplete results"
            )
            log_sys_exit(logger, msg)
        run.cache_comparisons()
        run.set_status("Done")
        logger.info("Run %d complete: %d comparisons", run.run_id, final)
        return run.run_id
