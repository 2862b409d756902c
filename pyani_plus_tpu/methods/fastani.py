"""fastANI-mode ANI: fragment minimizer-mapping.

Replaces the fastANI binary (invocation: private_cli.py:1029-1063 in the
reference). Per (query, subject) pair:

1. chop every query sequence into floor(len/3000) non-overlapping 3 kb
   fragments (incomplete tails dropped, like fastANI);
2. map each fragment to the subject via winnowed MinHash
   (ops/fastani_map.py), keeping the best mapping per fragment whose
   CI-quantised identity upper bound reaches 80%;
3. cgi.hpp reference-bin dedup: best mapping per (ref sequence,
   position // fragLen) bin (ops/fastani_map.ref_bin_filter);
4. ANI% = mean mapping identity; matched = surviving fragment count;
   report only if matched*fraglen >= minFraction * min(genome lengths).

Reference-derived proxy statistics (private_cli.py:1071-1080):
identity = ANI/100, aln_length = fragsize * matches,
sim_errors = fragments - matches, cov_query = matches / fragments.

The ANI percentage is passed through fastANI's 6-significant-digit
output formatting before division by 100, so stored identities match the
reference's parse of fastANI's printed output exactly.

Defaults k=16, fragLen=3000, minFraction=0.2 (ref methods/fastani.py:27-30).
"""

from __future__ import annotations

import numpy as np

from pyani_plus_tpu import __version__
from pyani_plus_tpu.genomes import Genome, decode_sequence
from pyani_plus_tpu.methods import ComputeContext
from pyani_plus_tpu.ops.fastani_map import (
    FRAG_LEN,
    KMER_SIZE,
    WINDOW_SIZE,
    FragmentMapping,
    RefIndex,
    map_fragment,
    ref_bin_filter,
)
from pyani_plus_tpu.ops.minimizers import window_minimizers

NAME = "fastANI"
PROGRAM = "pyani-plus-tpu-fastani"

MIN_FRACTION = 0.2  # ref methods/fastani.py:30


def configuration(
    *,
    fragsize: int = FRAG_LEN,
    kmersize: int = KMER_SIZE,
    minmatch: float = MIN_FRACTION,
) -> dict:
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
        "fragsize": fragsize,
        "kmersize": kmersize,
        "minmatch": minmatch,
    }


def fragment_genome(genome: Genome, frag_len: int) -> list[bytes]:
    """Non-overlapping complete fragments of every sequence (fastANI style)."""
    fragments: list[bytes] = []
    for rec in genome.records:
        seq = decode_sequence(rec.codes)
        for start in range(0, len(seq) - frag_len + 1, frag_len):
            fragments.append(seq[start : start + frag_len])
    return fragments


def compute_pair(  # noqa: PLR0913
    query: Genome,
    subject_index: RefIndex,
    subject_length: int,
    fragsize: int,
    kmersize: int,
    minmatch: float,
) -> tuple[float, int, int] | None:
    """Map query fragments to subject; return (ani_pct, matches, total)."""
    fragments = fragment_genome(query, fragsize)
    total = len(fragments)
    if total == 0:
        return None

    def _map_one(frag_id: int) -> FragmentMapping | None:
        mins = window_minimizers(fragments[frag_id], kmersize, WINDOW_SIZE)
        return map_fragment(
            mins,
            subject_index,
            frag_len=fragsize,
            k=kmersize,
            w=WINDOW_SIZE,
            fragment_id=frag_id,
        )

    # The native winnow + mapping kernels release the GIL inside ctypes,
    # so a thread pool parallelises fragments across host cores; results
    # are collected in fragment order, keeping everything deterministic.
    from concurrent.futures import ThreadPoolExecutor

    from pyani_plus_tpu.utils import intra_pair_workers

    workers = intra_pair_workers()
    if workers > 1 and total > 4:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            results = list(pool.map(_map_one, range(total)))
    else:
        results = [_map_one(i) for i in range(total)]
    mappings: list[FragmentMapping] = [mp for mp in results if mp is not None]
    # cgi.hpp order: one (best) mapping per query fragment, then the
    # reference-bin dedup removes fragments that map onto an already-
    # claimed reference bin (ops/fastani_map.ref_bin_filter).
    kept = ref_bin_filter(mappings, fragsize, WINDOW_SIZE)
    matches = len(kept)
    if matches == 0:
        return None
    shared_length = matches * fragsize
    if shared_length < minmatch * min(query.length, subject_length):
        return None
    ani = float(np.mean([mp.identity for mp in kept]))
    return ani, matches, total


def compute(ctx: ComputeContext) -> list[dict]:
    """Compute all pending pairs, one subject index at a time."""
    fragsize = ctx.config.get("fragsize") or FRAG_LEN
    kmersize = ctx.config.get("kmersize") or KMER_SIZE
    minmatch = ctx.config.get("minmatch")
    if minmatch is None:
        minmatch = MIN_FRACTION

    rows: list[dict] = []
    subjects = sorted({s for _q, s in ctx.pending})
    try:
        _compute_all(ctx, rows, subjects, fragsize, kmersize, minmatch)
    except KeyboardInterrupt:
        ctx.interrupted = True
        ctx.logger.error("Interrupted with %d completed comparisons", len(rows))
    return rows


def _compute_all(ctx, rows, subjects, fragsize, kmersize, minmatch):  # noqa: PLR0913
    for subject_hash in subjects:
        subject = ctx.genomes[subject_hash]
        index = RefIndex.build(
            [decode_sequence(rec.codes) for rec in subject.records],
            k=kmersize,
            w=WINDOW_SIZE,
        )
        for query_hash in sorted(q for q, s in ctx.pending if s == subject_hash):
            query = ctx.genomes[query_hash]
            result = compute_pair(
                query, index, subject.length, fragsize, kmersize, minmatch
            )
            if result is None:
                rows.append(
                    {
                        "query_hash": query_hash,
                        "subject_hash": subject_hash,
                        "identity": None,
                        "aln_length": None,
                        "sim_errors": None,
                        "cov_query": None,
                        "cov_subject": None,
                    }
                )
            else:
                ani, matches, total = result
                # fastANI prints ANI%% with 6 significant digits; the
                # reference stores float(printed)/100 (methods/fastani.py:33-120)
                printed = float(f"{ani:.6g}")
                rows.append(
                    {
                        "query_hash": query_hash,
                        "subject_hash": subject_hash,
                        "identity": printed / 100.0,
                        "aln_length": fragsize * matches,
                        "sim_errors": total - matches,
                        "cov_query": matches / total,
                        "cov_subject": None,
                    }
                )
            ctx.tick()
            ctx.maybe_flush(rows)
