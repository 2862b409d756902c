"""ANIm: whole-genome alignment ANI (nucmer/MUMmer-equivalent).

Replaces ``nucmer --mum`` + ``delta-filter -1`` (reference invocation
private_cli.py:1194-1224) with a seed-chain-extend pipeline:

1. maximal unique matches (unique in both sequences, length >= 20) on
   both strands via suffix array (ops/suffix.py) -- nucmer's --mum
   seeding; --maxmatch drops the uniqueness requirement (dnadiff);
2. mgaps-style clustering (ops/chaining.py, nucmer defaults
   mincluster=65 maxgap=90 diagdiff=5 diagfactor=0.12);
3. per cluster: consistent anchor chain, banded DP over inter-anchor
   gaps, banded free-end extension outward from the terminal anchors
   (ops/extend.py) -- postnuc's extension stage;
4. delta-filter -1 analogue: intersection of best ref-axis and qry-axis
   chains;
5. scoring per the reference parse_delta (methods/anim.py:72-193):
   identity = sum((ref_len + qry_len) - 2*sim) / sum(ref_len + qry_len),
   aligned bases per genome via inclusive interval union
   (anim.py:53-69); aln_length = query aligned bases; cov = aligned
   bases / genome length (private_cli.py:1238-1245). No alignments ->
   all-None (anim.py:186-188).

Exactness status: every alignment block (coordinates, error count,
indel-column count) is bit-identical to the fixture ``.filter`` deltas
for both --mum (ANIm) and --maxmatch (dnadiff) modes on the viral and
bad_alignments sets (tests/test_delta_parity.py), so all matrix cells
match the reference pipeline exactly.
"""

from __future__ import annotations

import numpy as np

from pyani_plus_tpu import __version__
from pyani_plus_tpu.genomes import Genome, complement_codes
from pyani_plus_tpu.methods import ComputeContext
from pyani_plus_tpu.ops.chaining import (
    Alignment,
    cluster_matches,
    one_to_one,
)
from pyani_plus_tpu.ops.extend import extend_errors, gap_errors
from pyani_plus_tpu.ops.suffix import (
    SEED_CACHE,
    max_matches_indexed,
    maximal_matches,
    mum_matches_indexed,
    seed_index_enabled,
)

NAME = "ANIm"
PROGRAM = "pyani-plus-tpu-anim"

MIN_MATCH = 20  # nucmer -l default
MODE = "mum"  # ref methods/anim.py:50


def configuration(*, mode: str = MODE) -> dict:
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
        "mode": mode,
    }


def _consistent_chain(
    r: np.ndarray, q: np.ndarray, ln: np.ndarray
) -> list[tuple[int, int, int]]:
    """Longest consistent (both axes increasing) anchor chain by weight."""
    order = np.argsort(r, kind="stable")
    anchors = [(int(r[i]), int(q[i]), int(ln[i])) for i in order]
    n = len(anchors)

    from pyani_plus_tpu.native import anchor_chain_dp_native

    native = anchor_chain_dp_native(r[order], q[order], ln[order])
    if native is not None:
        best, prev = native
    else:  # pragma: no cover - no compiler
        best = [0.0] * n
        prev = [-1] * n
        for i in range(n):
            ri, qi, li = anchors[i]
            best[i] = float(li)
            for j in range(i):
                rj, qj, lj = anchors[j]
                if (
                    rj <= ri
                    and qj <= qi
                    and rj + lj <= ri + li
                    and qj + lj <= qi + li
                ):
                    cand = best[j] + li
                    if cand > best[i]:
                        best[i] = cand
                        prev[i] = j
    end = int(np.argmax(best))
    chain = []
    while end != -1:
        chain.append(anchors[end])
        end = prev[end]
    return chain[::-1]


MAX_EXTENSION = 9999  # postnuc caps outward extension length (fitted
# against the reference .delta fixtures: both extensions of the rotated
# viral pair stop at exactly 9999 bases past the terminal anchors)


def _chain_and_fill(
    ref: np.ndarray,
    qry: np.ndarray,
    r: np.ndarray,
    q: np.ndarray,
    ln: np.ndarray,
) -> tuple[int, int, int, int, int, int] | None:
    """Chain one cluster and fill inter-anchor gaps (host phase).

    Returns (errors, nonid, gapcols, rs, qs, prev_re, prev_qe); the
    outward extensions happen separately so they can batch onto the
    device.
    """
    chain = _consistent_chain(r, q, ln)
    if not chain:
        return None
    errors = 0
    nonid = 0
    gapcols = 0
    rs, qs, l0 = chain[0]
    prev_re, prev_qe = rs + l0, qs + l0
    for ri, qi, li in chain[1:]:
        # Trim anchor start to remove overlap with the previous anchor
        trim = max(prev_re - ri, prev_qe - qi, 0)
        ri_t, qi_t = ri + trim, qi + trim
        if trim >= li:
            # Anchor fully inside the previous coverage: advancing the
            # frontier here would let the next gap fill skip bases that
            # never got alignment columns (undercounting errors vs the
            # single-path alignment nucmer emits), so drop it outright.
            continue
        g_err, g_nid, g_gap = gap_errors(ref[prev_re:ri_t], qry[prev_qe:qi_t])
        errors += g_err
        nonid += g_nid
        gapcols += g_gap
        prev_re, prev_qe = ri + li, qi + li
    return errors, nonid, gapcols, rs, qs, prev_re, prev_qe


EXT_BAND = 60  # extend_errors' band; device lanes share it (extend.py:234)
EXT_BREAKLEN = 200
# Minimum batch for the GPU extension kernel (ops/extend_gpu.py, bit-exact
# with the host kernel) when a GPU is live; smaller batches run on the
# threaded host kernel. On an H100 the kernel beat the host from the
# smallest batches measured (4-15 tasks of a 5 Mb ANIm column, PERF.md).
# PYANI_TPU_EXTEND_BATCH_MIN overrides it.
EXT_GPU_BATCH_MIN = 4


def _extension_tasks(
    fill: tuple[int, int, int, int, int, int, int],
    ref: np.ndarray,
    qry: np.ndarray,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """The two outward-extension (a, b) tail pairs of one chained cluster."""
    _err, _nid, _gap, rs, qs, prev_re, prev_qe = fill
    left_budget = min(rs, MAX_EXTENSION)
    right_budget = min(ref.size - prev_re, MAX_EXTENSION)
    return [
        (
            ref[rs - left_budget : rs][::-1].copy(),
            qry[max(0, qs - MAX_EXTENSION) : qs][::-1].copy(),
        ),
        (
            ref[prev_re : prev_re + right_budget].copy(),
            qry[prev_qe : prev_qe + MAX_EXTENSION].copy(),
        ),
    ]


def _run_extensions(
    tasks: list[tuple[np.ndarray, np.ndarray]],
    *,
    executor=None,
) -> list[tuple[int, int, int, int, int]]:
    """Batch free-end extensions: the GPU kernel when a GPU is live and
    the batch is large, the per-task host kernel otherwise. An explicit
    ``executor`` (ops/extend_gpu.py) sends every eligible task through
    the batched wrapper. Bit-identical either way."""
    import os

    from pyani_plus_tpu.device import gpu_available

    device_idx: list[int] = []
    device_tasks: list[tuple[np.ndarray, np.ndarray]] = []
    results: list[tuple[int, int, int, int, int] | None] = [None] * len(tasks)
    for idx, (a, b) in enumerate(tasks):
        if a.size and b.size:
            limit = min(a.size, b.size) + EXT_BREAKLEN
            a_t, b_t = a[:limit], b[:limit]
            if max(a_t.size, b_t.size) >= EXT_BAND:
                device_idx.append(idx)
                device_tasks.append((a_t, b_t))
    if executor is None and gpu_available():
        env_min = os.environ.get("PYANI_TPU_EXTEND_BATCH_MIN")
        on_device = len(device_tasks) >= int(env_min or EXT_GPU_BATCH_MIN)
    else:
        on_device = executor is not None
    if on_device:
        from pyani_plus_tpu.ops.extend_gpu import batch_extend

        for idx, res in zip(
            device_idx,
            batch_extend(
                device_tasks, stop_rows=3 * EXT_BREAKLEN, executor=executor
            ),
        ):
            results[idx] = res
    host_idx = [idx for idx in range(len(tasks)) if results[idx] is None]
    # The native band-DP kernel releases the GIL inside ctypes, so the
    # remaining extensions run thread-parallel across host cores;
    # results land at their task index, keeping order deterministic.
    from pyani_plus_tpu.utils import intra_pair_workers

    workers = intra_pair_workers()
    if workers > 1 and len(host_idx) > 4:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as pool:
            for idx, res in zip(
                host_idx,
                pool.map(lambda i: extend_errors(*tasks[i]), host_idx),
            ):
                results[idx] = res
    else:
        for idx in host_idx:
            results[idx] = extend_errors(*tasks[idx])
    return results  # type: ignore[return-value]


def _assemble_alignment(
    fill: tuple[int, int, int, int, int, int, int],
    ext_left: tuple[int, int, int, int, int],
    ext_right: tuple[int, int, int, int, int],
) -> Alignment:
    errors, nonid, gapcols, rs, qs, prev_re, prev_qe = fill
    ext_l_r, ext_l_q, ext_l_err, ext_l_nid, ext_l_gap = ext_left
    ext_r_r, ext_r_q, ext_r_err, ext_r_nid, ext_r_gap = ext_right
    return Alignment(
        ref_start=rs - ext_l_r,
        ref_end=prev_re + ext_r_r,
        qry_start=qs - ext_l_q,
        qry_end=prev_qe + ext_r_q,
        errors=errors + ext_l_err + ext_r_err,
        gap_columns=gapcols + ext_l_gap + ext_r_gap,
        nonid=nonid + ext_l_nid + ext_r_nid,
    )


def align_sequences(
    ref: np.ndarray,
    qry: np.ndarray,
    *,
    mode: str = "mum",
    min_match: int = MIN_MATCH,
) -> list[Alignment]:
    """All alignment blocks between one ref and one qry sequence."""
    unique = mode == "mum"
    qlen = qry.size
    # Collect clusters from both strands first; extension caps come from
    # the neighbouring clusters' reference spans (postnuc behaviour).
    # Both the strand seeding (native suffix array / LCP) and the
    # per-cluster banded DP release the GIL inside ctypes, so thread
    # pools parallelise them across host cores; results are assembled in
    # the same deterministic order as the sequential loops.
    from concurrent.futures import ThreadPoolExecutor

    # Both seeding modes stream the query through a cached per-subject
    # suffix automaton (O(|qry| + matches) per pair, the index amortised
    # down a column): MUMs for --mum, all maximal matches for
    # --maxmatch (dnadiff).  Match sets are identical to the
    # combined-suffix-array path, which remains the no-compiler
    # fallback (tests/test_mum_index.py, tests/test_maxmatch_index.py).
    use_index = seed_index_enabled()

    def _strand(reverse: bool):
        if reverse:
            q_codes = (
                SEED_CACHE.rc_for(qry)
                if use_index
                else complement_codes(qry)[::-1].copy()
            )
        else:
            q_codes = qry
        if use_index and unique:
            r, q, ln = mum_matches_indexed(
                SEED_CACHE.sam_for(ref), ref, q_codes, min_match
            )
        elif use_index:
            r, q, ln = max_matches_indexed(
                SEED_CACHE.sam_for(ref), ref, q_codes, min_match
            )
        else:
            r, q, ln = maximal_matches(
                ref, q_codes, min_match, unique_ref=unique, unique_qry=unique
            )
        return q_codes, [
            (reverse, r[idx], q[idx], ln[idx])
            for idx in cluster_matches(r, q, ln)
        ]

    from pyani_plus_tpu.utils import intra_pair_workers

    strand_workers = min(2, intra_pair_workers())
    if strand_workers > 1:
        with ThreadPoolExecutor(max_workers=strand_workers) as pool:
            per_strand = list(pool.map(_strand, (False, True)))
    else:
        per_strand = [_strand(False), _strand(True)]
    strand_matches = {rev: per_strand[rev][0] for rev in (False, True)}
    clusters = [cl for _codes, cls in per_strand for cl in cls]

    workers = intra_pair_workers()
    if workers > 1 and len(clusters) > 4:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            fills = list(
                pool.map(
                    lambda c: _chain_and_fill(
                        ref, strand_matches[c[0]], c[1], c[2], c[3]
                    ),
                    clusters,
                )
            )
    else:
        fills = [
            _chain_and_fill(ref, strand_matches[rev], r, q, ln)
            for rev, r, q, ln in clusters
        ]

    # Outward extensions of every chained cluster, batched together (the
    # device path runs all lanes in one dispatch when the batch is big).
    tasks: list[tuple[np.ndarray, np.ndarray]] = []
    task_of: list[int | None] = []
    for (reverse, _r, _q, _ln), fill in zip(clusters, fills):
        if fill is None:
            task_of.append(None)
            continue
        task_of.append(len(tasks))
        tasks.extend(_extension_tasks(fill, ref, strand_matches[reverse]))
    ext_results = _run_extensions(tasks)

    blocks: list[Alignment | None] = []
    for fill, base in zip(fills, task_of):
        if fill is None or base is None:
            blocks.append(None)
            continue
        blocks.append(
            _assemble_alignment(fill, ext_results[base], ext_results[base + 1])
        )

    alignments: list[Alignment] = []
    for (reverse, _r, _q, _ln), block in zip(clusters, blocks):
        if block is None:
            continue
        if reverse:
            qs, qe = block.qry_start, block.qry_end
            block = Alignment(
                ref_start=block.ref_start,
                ref_end=block.ref_end,
                qry_start=qlen - qe,
                qry_end=qlen - qs,
                errors=block.errors,
                reverse=True,
                gap_columns=block.gap_columns,
                nonid=block.nonid,
            )
        alignments.append(block)
    return alignments


def _interval_union(intervals: list[tuple[int, int]]) -> int:
    """Total bases covered by inclusive-coordinate intervals (anim.py:53-69)."""
    if not intervals:
        return 0
    intervals = sorted(intervals)
    total = 0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_s + 1
            cur_s, cur_e = s, e
    total += cur_e - cur_s + 1
    return total


def score_alignments(
    per_seq_alignments: dict[tuple[int, int], list[Alignment]],
) -> tuple[int | None, int | None, float | None, int | None]:
    """parse_delta math: (query_aligned, ref_aligned, identity, sim_errors)."""
    sum_lengths = 0
    sum_penalty = 0
    sim_total = 0
    qry_regions: dict[int, list[tuple[int, int]]] = {}
    ref_regions: dict[int, list[tuple[int, int]]] = {}
    for (ref_id, qry_id), blocks in per_seq_alignments.items():
        for a in blocks:
            ref_len = a.ref_end - a.ref_start  # == inclusive |e-s|+1
            qry_len = a.qry_end - a.qry_start
            sum_lengths += ref_len + qry_len
            sum_penalty += 2 * a.errors
            sim_total += a.errors
            ref_regions.setdefault(ref_id, []).append(
                (a.ref_start + 1, a.ref_end)
            )
            qry_regions.setdefault(qry_id, []).append(
                (a.qry_start + 1, a.qry_end)
            )
    if not sum_lengths:
        return None, None, None, None
    identity = (sum_lengths - sum_penalty) / sum_lengths
    query_aligned = sum(_interval_union(v) for v in qry_regions.values())
    ref_aligned = sum(_interval_union(v) for v in ref_regions.values())
    return query_aligned, ref_aligned, identity, sim_total


def compute_pair(
    query: Genome, subject: Genome, mode: str = "mum"
) -> dict:
    """One directed comparison: subject is the nucmer reference."""
    per_seq: dict[tuple[int, int], list[Alignment]] = {}
    all_blocks: list[Alignment] = []
    keys: list[tuple[int, int]] = []
    for si, s_rec in enumerate(subject.records):
        for qi, q_rec in enumerate(query.records):
            blocks = align_sequences(s_rec.codes, q_rec.codes, mode=mode)
            all_blocks.extend(blocks)
            keys.extend([(si, qi)] * len(blocks))
    # delta-filter -1 with the reference's per-sequence-per-axis chains:
    # -r runs the LIS separately for each reference contig (over its
    # alignments to every query contig), -q per query contig; keys carry
    # the grouping so multi-contig genomes filter exactly like nucmer's
    kept = set(id(a) for a in one_to_one(all_blocks, keys))
    for key, block in zip(keys, all_blocks):
        if id(block) in kept:
            per_seq.setdefault(key, []).append(block)
    query_aligned, ref_aligned, identity, sim_errors = score_alignments(per_seq)
    return {
        "identity": identity,
        "aln_length": query_aligned,
        "sim_errors": sim_errors,
        "cov_query": None
        if query_aligned is None
        else float(query_aligned) / query.length,
        "cov_subject": None
        if ref_aligned is None
        else float(ref_aligned) / subject.length,
    }


def compute(ctx: ComputeContext) -> list[dict]:
    mode = ctx.config.get("mode") or MODE
    from pyani_plus_tpu.methods import run_pairwise

    return run_pairwise(
        ctx,
        lambda q, s: compute_pair(ctx.genomes[q], ctx.genomes[s], mode),
    )
