#!/usr/bin/env python
"""Smoke run of the ANI compute path on one NVIDIA GPU.

Drives the path every CLI method command takes
(``parallel.runner.start_and_run_method`` down to the SQLite store) on
genomes generated from ``--seed`` into a temporary directory, and
checks every device kernel against its plain reference:

0. device, card (``nvidia-smi`` name and power limit) and which optional
   packages are importable;
1. compile only: the containment Gram at the sourmash phase's shape,
   every ANIb scorer bucket the ANIb phase uses plus the largest
   (1024 x 32768), and the CUDA extension kernel on >= 512 tasks with
   ~10^4-row tails -- compile seconds and ``memory_analysis()``;
2. exact parity at real widths: Gram vs the host sparse product, the
   ANIb scorer (score, best_i, best_j) vs the host DP, the extension
   kernel vs native/band.cpp;
3. end to end through ``start_and_run_method``, each on a fresh store:
   sourmash (200 genomes of 4-6 Mb), ANIm and dnadiff (a 5 Mb subject
   and 3 queries), ANIb (a 1 Mb subject and 2 queries), each compared
   exactly with its host route and required to have dispatched its
   device kernel; fastANI, ANIminimap2 and skani on one 1 Mb pair.

With no GPU it exits non-zero before any phase; any failed phase exits
non-zero. The last line of standard output is one JSON object naming
the device. ``--four`` runs only the multi-card path (sourmash and an
ANIb column sharded over four cards) against the same runs on one card;
``--kernels-only`` stops after phase 2.

Run: ``python chip_smoke.py [--seed N] [--out report.json] [--four |
--kernels-only]``.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import importlib.util
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OPTIONAL = ("click", "pandas", "rich", "networkx", "matplotlib")
# Sizes: the reference's bacterial_example shape (4-6 Mb, multi-contig,
# some gzipped); a 5 Mb ANIm/dnadiff column, a 1 Mb ANIb column.
SOURMASH_GENOMES = 200
SOURMASH_LEN = (4_000_000, 6_000_000)
SOURMASH_FAMILIES = 10
ANIM_LEN = 5_000_000
ANIB_LEN = 1_000_000
PAIR_LEN = 1_000_000
EXT_TASKS = 512
EXT_LONG = 10199  # MAX_EXTENSION + breaklen: ANIm's longest tail
REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Time one phase; an exception propagates and fails the run."""
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    wall = time.perf_counter() - t0
    REPORT.setdefault("phase_seconds", {})[name] = wall
    log(f"== {name}: ok, {wall:.2f} s wall")


def card_line() -> str:
    """``nvidia-smi`` name and power limit, read outside JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


# --------------------------------------------------------------------------
# Synthetic genomes


_LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_codes(rng, length: int) -> np.ndarray:
    return rng.integers(0, 4, length, dtype=np.uint8)


def mutate(rng, codes: np.ndarray, divergence: float) -> np.ndarray:
    """Substitutions at ~95% of ``divergence`` and 1-4 bp indels at ~5%."""
    out = codes.copy()
    sub = np.flatnonzero(rng.random(out.size, dtype=np.float32) < divergence * 0.95)
    out[sub] = (out[sub] + rng.integers(1, 4, sub.size, dtype=np.uint8)) % 4
    n_indel = int(out.size * divergence * 0.05 / 2.5)
    if n_indel:
        dele = np.sort(rng.choice(out.size, n_indel, replace=False))
        keep = np.ones(out.size, bool)
        for shift in range(3):
            keep[np.minimum(dele + shift, out.size - 1)[rng.random(n_indel) < 0.5 ** shift]] = False
        out = out[keep]
        ins = np.sort(rng.choice(out.size, n_indel, replace=False))
        out = np.insert(out, ins, rng.integers(0, 4, n_indel, dtype=np.uint8))
    return out


def split_contigs(rng, codes: np.ndarray, n_contigs: int) -> list[np.ndarray]:
    cuts = np.sort(rng.choice(np.arange(1000, codes.size - 1000), n_contigs - 1, replace=False))
    contigs = np.split(codes, cuts)
    # some contigs on the other strand, as assemblies report them
    return [
        (3 - c[::-1]) if rng.random() < 0.3 else c for c in contigs
    ]


def write_fasta(path: Path, name: str, contigs: list[np.ndarray], *, gz: bool) -> None:
    parts = []
    for i, codes in enumerate(contigs):
        seq = _LETTERS[codes]
        pad = (-seq.size) % 80
        lines = np.concatenate([seq, np.full(pad, ord("\n"), np.uint8)]).reshape(-1, 80)
        body = np.concatenate([lines, np.full((lines.shape[0], 1), ord("\n"), np.uint8)], axis=1)
        text = body.tobytes()
        if pad:
            text = text[: -(pad + 1)] + b"\n"
        parts.append(f">{name}_contig{i + 1} synthetic genome {name}\n".encode() + text)
    data = b"".join(parts)
    if gz:
        with gzip.open(path, "wb", compresslevel=1) as fh:
            fh.write(data)
    else:
        path.write_bytes(data)


def make_column(rng, root: Path, length: int, anis: tuple[float, ...], n_contigs: int) -> Path:
    """A subject and queries at the given ANIs, multi-contig."""
    root.mkdir(parents=True)
    subject = random_codes(rng, length)
    write_fasta(root / "subject.fna", "subject", split_contigs(rng, subject, n_contigs), gz=False)
    for ani in anis:
        name = f"query_ani{round(ani * 100)}"
        query = mutate(rng, subject, 1.0 - ani)
        write_fasta(root / f"{name}.fna.gz", name, split_contigs(rng, query, n_contigs), gz=True)
    return root


def make_sourmash_set(rng, root: Path, n: int, families: int) -> Path:
    """``n`` genomes of 4-6 Mb in ``families`` lineages; every 4th gzipped."""
    root.mkdir(parents=True)
    ancestors = [random_codes(rng, int(rng.integers(*SOURMASH_LEN))) for _ in range(families)]
    seeds = rng.integers(0, 2**32, n)

    def one(i: int) -> None:
        r = np.random.default_rng(int(seeds[i]))
        codes = mutate(r, ancestors[i % families], float(r.uniform(0.002, 0.12)))
        gz = i % 4 == 0
        write_fasta(
            root / f"g{i:03d}.fna{'.gz' if gz else ''}", f"g{i:03d}",
            split_contigs(r, codes, int(r.integers(1, 9))) if codes.size > 20000 else [codes], gz=gz,
        )

    with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
        list(pool.map(one, range(n)))
    return root


# --------------------------------------------------------------------------
# Runs through the CLI's entry point


def run_method(fasta: Path, db_path: Path, method: str, *, column: bool = False, **params) -> dict:
    """One start_and_run_method run on a fresh store -> rows by pair.

    ``column=True`` computes only the column of ``subject.fna``: the
    runner's multi-host split (PYANI_TPU_PROCESS_COUNT/INDEX) with one
    share per genome owns exactly one subject column."""
    from pyani_plus_tpu.db import Database
    from pyani_plus_tpu.parallel.runner import start_and_run_method
    from pyani_plus_tpu.utils import file_md5sum

    logger = logging.getLogger("chip_smoke")
    split = {}
    if column:
        md5s = sorted(file_md5sum(p) for p in fasta.iterdir())
        split = {
            "PYANI_TPU_PROCESS_COUNT": len(md5s),
            "PYANI_TPU_PROCESS_INDEX": md5s.index(file_md5sum(fasta / "subject.fna")),
        }
    with env(**split):
        run_id = start_and_run_method(logger, db_path, fasta, method, create_db=True, **params)
    with Database(db_path) as db:
        run = db.load_run(run_id, check_complete=not column)
        assert column or run.status == "Done", run.status
        return {
            (r["query_hash"], r["subject_hash"]): (
                r["identity"], r["aln_length"], r["sim_errors"], r["cov_query"], r["cov_subject"],
            )
            for r in run.comparisons()
        }


@contextlib.contextmanager
def env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dispatches(kernel: str) -> int:
    from pyani_plus_tpu.utils import devmeter

    return devmeter.dispatches(kernel)


def timed_run(fasta: Path, db_path: Path, method: str, **params) -> tuple[dict, float]:
    from pyani_plus_tpu.ops.suffix import SEED_CACHE

    SEED_CACHE.clear()  # each route indexes its subjects afresh
    t0 = time.perf_counter()
    rows = run_method(fasta, db_path, method, **params)
    return rows, time.perf_counter() - t0


def require_equal(label: str, got: dict, want: dict, reference: str = "the host route") -> None:
    assert got.keys() == want.keys(), f"{label}: pair sets differ"
    bad = [k for k in got if got[k] != want[k]]
    assert not bad, f"{label}: {len(bad)} rows differ, e.g. {got[bad[0]]} vs {want[bad[0]]}"
    log(f"   {label}: {len(got)} rows equal to {reference}")


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: none"
    return (
        f"args {m.argument_size_in_bytes} B, out {m.output_size_in_bytes} B, "
        f"temp {m.temp_size_in_bytes} B, code {m.generated_code_size_in_bytes} B"
    )


def aot_compile(label: str, fn, *args) -> None:
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    dt = time.perf_counter() - t0
    REPORT.setdefault("compile_seconds", {})[label] = dt
    REPORT.setdefault("memory_analysis", {})[label] = memory_line(compiled)
    log(f"   {label}: compile {dt:.2f} s; {memory_line(compiled)}")


# --------------------------------------------------------------------------
# Kernel inputs at real widths


def extension_tasks(rng, count: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """Pre-trimmed free-end extension tails as ANIm makes them: up to
    MAX_EXTENSION + breaklen = 10199 rows, some near-identical ones that
    run their full length, some divergent ones that give up, N runs."""
    tasks = []
    for t in range(count):
        if t % 8 == 0:
            m = EXT_LONG
            div = 0.01
        else:
            m = int(rng.integers(60, EXT_LONG // 2))
            div = float(rng.choice([0.01, 0.05, 0.15, 0.4]))
        a = random_codes(rng, m)
        if t % 5 == 0:
            a[rng.integers(0, m, 8)] = 4  # N
        b = mutate(rng, a, div)
        b = b[: min(a.size, b.size) + 200]
        a = a[: min(a.size, b.size) + 200]
        tasks.append((a, b))
    return tasks


def anib_candidates(column: Path):
    """The ANIb phase's real (fragment, window) score tasks."""
    from pyani_plus_tpu.genomes import load_genome
    from pyani_plus_tpu.methods import anib
    from pyani_plus_tpu.ops.seeds import SeedIndex

    subject = load_genome(column / "subject.fna")
    seed_indexes = [SeedIndex(rec.codes) for rec in subject.records]
    flat = []
    for path in sorted(column.iterdir()):
        flat.extend(
            anib._pair_tasks(
                load_genome(path), subject, seed_indexes, anib.FRAGSIZE, include_singles=True
            )[2]
        )
    return flat


def anib_bucket(width: int) -> int:
    from pyani_plus_tpu.methods.anib import N_BUCKETS

    return next(n for n in N_BUCKETS if width <= n)


def anib_batch(pairs, n: int):
    from pyani_plus_tpu.methods.anib import DEVICE_BATCH
    from pyani_plus_tpu.ops.dp_jax import PAD_CODE

    q = np.full((DEVICE_BATCH, 1024), PAD_CODE, np.uint8)
    s = np.full((DEVICE_BATCH, n), PAD_CODE, np.uint8)
    for row, (frag, window) in enumerate(pairs[:DEVICE_BATCH]):
        q[row, : frag.size] = frag
        s[row, : window.size] = window
    return q, s


def host_best(q_row: np.ndarray, s_row: np.ndarray) -> tuple[int, int, int]:
    """(score, best_i, best_j) of the host DP on unpadded rows."""
    from pyani_plus_tpu.ops.dp import local_align_stats
    from pyani_plus_tpu.ops.dp_jax import PAD_CODE

    q = q_row[q_row != PAD_CODE]
    s = s_row[s_row != PAD_CODE]
    st = local_align_stats(q, s) if q.size and s.size else None
    return (0, 0, 0) if st is None else (st.score, st.query_end, st.subject_end)


def host_sketches(cache: Path):
    """The sketches the sourmash run cached, in the runner's order."""
    from pyani_plus_tpu.ops.minhash import Sketch

    files = sorted((cache / "sourmash_k=31_scaled=1000").glob("*.npy"))
    return [Sketch(p.stem, 31, 1000, np.load(p).astype(np.uint64)) for p in files]


# --------------------------------------------------------------------------


def one_card(args, tmp: Path) -> None:  # noqa: PLR0915
    import jax

    from pyani_plus_tpu.methods.anib import DEVICE_BATCH, MAX_DEVICE_WINDOW
    from pyani_plus_tpu.ops import dp_jax, extend_gpu
    from pyani_plus_tpu.ops.dp import GAP_EXTEND, GAP_OPEN, PENALTY, REWARD
    from pyani_plus_tpu.ops.minhash import (
        gram_program,
        intersection_matrix_device,
        intersection_matrix_host,
        sketch_genome,
    )

    rng = np.random.default_rng(args.seed)
    with phase("setup: generate genomes"):
        sour = make_sourmash_set(rng, tmp / "sourmash", SOURMASH_GENOMES, SOURMASH_FAMILIES)
        anim_col = make_column(rng, tmp / "anim", ANIM_LEN, (0.85, 0.95, 0.99), 8)
        anib_col = make_column(rng, tmp / "anib", ANIB_LEN, (0.85, 0.99), 4)
        pairs = {
            m: make_column(rng, tmp / m, PAIR_LEN, (0.95,), 3)
            for m in ("fastANI", "ANIminimap2", "skani")
        }
        ext_tasks = extension_tasks(rng, EXT_TASKS)
    with phase("setup: sketches and ANIb candidates (host)"):
        from pyani_plus_tpu.genomes import load_genome

        files = sorted(sour.iterdir())
        with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
            sketches = list(pool.map(lambda p: sketch_genome(load_genome(p)), files))
        cands = anib_candidates(anib_col)
        buckets = sorted({anib_bucket(w.size) for _f, w in cands if w.size <= MAX_DEVICE_WINDOW})
        log(f"   {len(sketches)} sketches, {sum(s.num_hashes for s in sketches)} hashes; "
            f"{len(cands)} ANIb candidates in buckets {buckets}")
        REPORT["anib_buckets"] = buckets

    best = dp_jax._get_best_kernel(REWARD, PENALTY, GAP_OPEN, GAP_EXTEND)
    meta, a_flat, b_flat = extend_gpu.pack(ext_tasks)
    with phase("1 compile"):
        gram_fn, pts = gram_program(sketches)
        aot_compile(f"gram n={len(sketches)} pts={pts.shape}", gram_fn, pts)
        for n in sorted({*buckets, MAX_DEVICE_WINDOW}):
            q = jax.ShapeDtypeStruct((DEVICE_BATCH, 1024), np.uint8)
            s = jax.ShapeDtypeStruct((DEVICE_BATCH, n), np.uint8)
            aot_compile(f"anib_sw {DEVICE_BATCH}x1024x{n}", best, q, s)
        t0 = time.perf_counter()
        extend_gpu._call(600)  # nvcc build + FFI registration
        REPORT["extend_build_seconds"] = time.perf_counter() - t0
        log(f"   band_extend.cu build + register: {REPORT['extend_build_seconds']:.2f} s")
        aot_compile(f"band_extend T={meta.shape[0]} A={a_flat.size} B={b_flat.size}",
                    extend_gpu._call(600), meta, a_flat, b_flat)

    with phase("2 parity"):
        dev = intersection_matrix_device(sketches)
        host = intersection_matrix_host(sketches)
        assert np.array_equal(dev, host), "Gram differs from the host sparse product"
        log(f"   gram: {dev.shape} counts equal (max {int(dev.max())})")
        by_bucket: dict[int, list] = {}
        for f, w in cands:
            if w.size <= MAX_DEVICE_WINDOW:
                by_bucket.setdefault(anib_bucket(w.size), []).append((f, w))
        long_rows = []
        for _ in range(32):  # planted homology in the widest windows
            w = random_codes(rng, int(rng.integers(MAX_DEVICE_WINDOW // 2, MAX_DEVICE_WINDOW + 1)))
            lo = int(rng.integers(0, w.size - 1020))
            long_rows.append((mutate(rng, w[lo : lo + 1020], 0.1)[:1020], w))
        by_bucket.setdefault(MAX_DEVICE_WINDOW, []).extend(long_rows)
        for n, rows in sorted(by_bucket.items()):
            q, s = anib_batch(rows, n)
            got = np.asarray(dp_jax.batch_local_align_best(q, s))
            with ThreadPoolExecutor(max_workers=min(16, os.cpu_count() or 1)) as pool:
                want = np.array(list(pool.map(host_best, q, s)))
            assert np.array_equal(got, want), (
                f"anib_sw bucket {n}: {int((got != want).any(axis=1).sum())} rows differ"
            )
            log(f"   anib_sw {DEVICE_BATCH}x1024x{n}: {min(len(rows), DEVICE_BATCH)} real rows equal")
        got = extend_gpu.batch_extend(ext_tasks, stop_rows=600)
        want = extend_gpu.batch_extend(ext_tasks, stop_rows=600, executor=extend_gpu.host_executor)
        bad = [t for t in range(len(ext_tasks)) if got[t] != want[t]]
        assert not bad, f"band_extend: {len(bad)} tasks differ, e.g. {got[bad[0]]} vs {want[bad[0]]}"
        log(f"   band_extend: {len(ext_tasks)} tasks equal to band.cpp "
            f"(longest {max(a.size for a, _ in ext_tasks)} rows)")
    if args.kernels_only:
        return

    with phase("3 sourmash"):
        before = dispatches("containment_gram")
        t0 = time.perf_counter()
        rows = run_method(sour, tmp / "sourmash.db", "sourmash", cache=tmp / "cache")
        REPORT["sourmash_run_seconds"] = time.perf_counter() - t0
        assert dispatches("containment_gram") > before, "sourmash never ran the device Gram"
        from pyani_plus_tpu.ops.minhash import containment_ani

        cached = host_sketches(tmp / "cache")
        identity, cov = containment_ani(cached, use_device=False)
        index = {s.md5: i for i, s in enumerate(cached)}
        bad = 0
        for (qh, sh), row in rows.items():
            i, j = index[qh], index[sh]
            want = (None if np.isnan(identity[i, j]) else float(identity[i, j]),
                    None if np.isnan(cov[i, j]) else float(cov[i, j]))
            bad += (row[0], row[3]) != want
        assert not bad, f"sourmash: {bad} rows differ from use_device=False"
        log(f"   sourmash: {len(rows)} rows equal to use_device=False; "
            f"run {REPORT['sourmash_run_seconds']:.2f} s")

    recorded: list[list] = []
    from pyani_plus_tpu.methods import anim

    production = anim._run_extensions

    def recording(tasks, **kw):
        recorded.append(tasks)
        return production(tasks, **kw)

    for method in ("ANIm", "dnadiff"):
        with phase(f"3 {method}"):
            with env(PYANI_TPU_EXTEND_BATCH_MIN=1 << 30):
                host_rows, host_s = timed_run(anim_col, tmp / f"{method}_host.db", method, column=True)
            before = dispatches(extend_gpu.KERNEL)
            anim._run_extensions = recording if method == "ANIm" else production
            try:
                dev_rows, dev_s = timed_run(anim_col, tmp / f"{method}_dev.db", method, column=True)
            finally:
                anim._run_extensions = production
            ran = dispatches(extend_gpu.KERNEL) - before
            assert ran > 0, f"{method} never ran the extension kernel"
            require_equal(method, dev_rows, host_rows)
            REPORT[f"{method}_seconds"] = {"gpu_route": dev_s, "host_route": host_s, "kernel_launches": ran}
            log(f"   {method}: gpu route {dev_s:.2f} s ({ran} launches), host route {host_s:.2f} s")

    with phase("3 extension timing (ANIm column tasks)"):
        extension_timing(recorded)

    with phase("3 ANIb"):
        with env(PYANI_TPU_ANIB_DEVICE=0):
            host_rows, host_s = timed_run(anib_col, tmp / "anib_host.db", "ANIb", column=True)
        before = dispatches("anib_sw")
        dev_rows, dev_s = timed_run(anib_col, tmp / "anib_dev.db", "ANIb", column=True)
        ran = dispatches("anib_sw") - before
        assert ran > 0, "ANIb never ran the device scorer"
        require_equal("ANIb", dev_rows, host_rows)
        REPORT["ANIb_seconds"] = {"gpu_route": dev_s, "host_route": host_s, "batches": ran}
        log(f"   ANIb: gpu route {dev_s:.2f} s ({ran} batches), host route {host_s:.2f} s")

    for method, col in pairs.items():
        with phase(f"3 {method} (host)"):
            rows = run_method(col, tmp / f"{method}.db", method)
            pair_ids = [r[0] for (q, s), r in rows.items() if q != s]
            assert all(v is not None and 0.0 < v <= 1.0 for v in pair_ids), (method, pair_ids)
            log(f"   {method}: identities {pair_ids}")


def extension_timing(recorded: list[list]) -> None:
    """The CUDA kernel against the threaded host kernel on the ANIm
    column's own extension tasks: all in one call, and batch by batch as
    the column made them (small batches only: the crossover)."""
    from pyani_plus_tpu.methods import anim
    from pyani_plus_tpu.ops.extend import extend_errors
    from pyani_plus_tpu.ops.extend_gpu import batch_extend
    from pyani_plus_tpu.utils import intra_pair_workers

    def trimmed(tasks):
        out = []
        for a, b in tasks:
            if a.size and b.size:
                limit = min(a.size, b.size) + anim.EXT_BREAKLEN
                if max(min(a.size, limit), min(b.size, limit)) >= anim.EXT_BAND:
                    out.append((a[:limit], b[:limit]))
        return out

    batches = [trimmed(t) for t in recorded]
    batches = [b for b in batches if b]
    tasks = [t for b in batches for t in b]
    workers = intra_pair_workers()

    def host(ts):
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(lambda t: extend_errors(*t), ts))

    def clock(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        return out, time.perf_counter() - t0

    want, t_host = clock(host, tasks)
    batch_extend(tasks)  # warm the launch shape
    got, t_cuda = clock(batch_extend, tasks)
    assert got == want, "band_extend differs from the host kernel on the column's tasks"
    rows = sum(a.size for a, _ in tasks)
    REPORT["extension_merged"] = {
        "tasks": len(tasks), "a_rows": rows, "host_threads": workers,
        "host_seconds": t_host, "cuda_seconds": t_cuda,
    }
    log(f"   all {len(tasks)} column tasks in one call: host ({workers} threads) "
        f"{t_host:.3f} s, CUDA {t_cuda:.3f} s")
    per_batch = []
    for b in batches:
        if len(b) >= 256:
            continue
        _, th = clock(host, b)
        batch_extend(b)
        _, tc = clock(batch_extend, b)
        per_batch.append((len(b), th, tc))
    per_batch.sort()
    REPORT["extension_per_batch"] = per_batch
    for size in (1, 4, 16, 64):
        sel = [p for p in per_batch if size <= p[0] < size * 4]
        if sel:
            h = sum(p[1] for p in sel) / len(sel)
            c = sum(p[2] for p in sel) / len(sel)
            log(f"   batches of {size}-{size * 4 - 1} tasks (n={len(sel)}): "
                f"host {h * 1e3:.2f} ms, CUDA {c * 1e3:.2f} ms")


def four_cards(args, tmp: Path) -> None:
    import jax

    from pyani_plus_tpu.parallel.tiles import default_pair_mesh

    assert len(jax.devices()) == 4, f"--four needs 4 cards, JAX sees {len(jax.devices())}"
    rng = np.random.default_rng(args.seed)
    with phase("setup: generate genomes"):
        sour = make_sourmash_set(rng, tmp / "sourmash", SOURMASH_GENOMES, SOURMASH_FAMILIES)
        anib_col = make_column(rng, tmp / "anib", ANIB_LEN, (0.85, 0.99), 4)
    mesh = default_pair_mesh()
    assert mesh is not None and mesh.devices.size == 4, "no 4-card pair mesh"
    log(f"   pair mesh {dict(mesh.shape)} over {[d.id for d in mesh.devices.flat]}")
    for method, col, kernel, params in (
        ("sourmash", sour, "containment_gram", {"cache": tmp / "cache"}),
        ("ANIb", anib_col, "anib_sw", {"column": True}),
    ):
        with phase(f"4 cards: {method}"):
            with env(PYANI_TPU_MESH=0):
                one, one_s = timed_run(col, tmp / f"{method}_1.db", method, **params)
            before = dispatches(kernel)
            four, four_s = timed_run(col, tmp / f"{method}_4.db", method, **params)
            assert dispatches(kernel) > before, f"{method} never ran {kernel}"
            require_equal(f"{method} on 4 cards", four, one, "the 1-card run")
            REPORT[f"four_{method}_seconds"] = {"four_cards": four_s, "one_card": one_s}
            log(f"   {method}: 4 cards {four_s:.2f} s, 1 card {one_s:.2f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four", action="store_true", help="only the 4-card path")
    parser.add_argument(
        "--kernels-only", action="store_true",
        help="stop after phases 0-2 (compile and kernel parity)",
    )
    parser.add_argument("--out", type=Path, help="write the full report here (JSON)")
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    import jax

    from pyani_plus_tpu.device import configure_compile_cache, gpu_available

    if not gpu_available():
        print(f"chip_smoke: needs a GPU, JAX backend is {jax.default_backend()}", file=sys.stderr)
        return 2
    configure_compile_cache()
    # share every compile between the AOT phase and the runs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}
    with phase("0 device"):
        log(f"   jax {jax.__version__}: {device}")
        card = card_line()
        log(f"   nvidia-smi: {card}")
        present = {m: importlib.util.find_spec(m) is not None for m in OPTIONAL}
        log(f"   optional packages importable: {present}")
        REPORT.update(device=device, card=card, optional_packages=present)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        (four_cards if args.four else one_card)(args, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(REPORT, indent=1, default=str))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
