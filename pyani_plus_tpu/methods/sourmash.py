"""sourmash-mode ANI: FracMinHash containment.

Replaces the reference's shell-outs to ``sourmash scripts singlesketch`` /
``sig collect`` / branchwater ``manysearch`` (methods/sourmash.py:34-206)
with our own sketching + containment kernels (pyani_plus_tpu.ops.minhash).

Semantics (validated against reference fixtures to 1 ulp):
- identity  = max(c_qs, c_sq) ** (1/k)   (the "max_containment_ani")
- cov_query = c_qs ** (1/k)              (the "query_containment_ani")
- pairs with no common hashes -> None/NaN (failed alignment)
- aln_length / sim_errors / cov_subject are not defined for this method

Defaults k=31, scaled=1000 (ref methods/sourmash.py:30-31).
"""

from __future__ import annotations

import numpy as np

from pyani_plus_tpu import __version__
from pyani_plus_tpu.methods import ComputeContext
from pyani_plus_tpu.ops.minhash import (
    DEFAULT_KMER,
    DEFAULT_SCALED,
    Sketch,
    containment_ani,
    sketch_genome,
)

NAME = "sourmash"
PROGRAM = "pyani-plus-tpu-minhash"
KMER_SIZE = DEFAULT_KMER  # 31
SCALED = DEFAULT_SCALED  # 1000

# Whole-tile method: one compute call covers the full query x subject grid
# (like the reference's single column_0 job, public_cli.py:232-235).
WHOLE_MATRIX = True


def configuration(
    *, kmersize: int = KMER_SIZE, scaled: int = SCALED
) -> dict:
    return {
        "method": NAME,
        "program": PROGRAM,
        "version": __version__,
        "kmersize": kmersize,
        "extra": f"scaled={scaled}",
    }


def _scaled_from_extra(extra: str | None) -> int:
    if extra and extra.startswith("scaled="):
        return int(extra.split("=", 1)[1])
    return SCALED


def get_sketch(genome, kmersize: int, scaled: int, cache=None) -> Sketch:
    """Sketch a genome, with optional on-disk .npy cache (prepare-genomes)."""
    if cache is not None:
        cache_dir = cache / f"sourmash_k={kmersize}_scaled={scaled}"
        cache_file = cache_dir / f"{genome.md5}.npy"
        if cache_file.is_file():
            hashes = np.load(cache_file)
            return Sketch(genome.md5, kmersize, scaled, hashes.astype(np.uint64))
    sketch = sketch_genome(genome, kmersize, scaled)
    if cache is not None:
        cache_dir.mkdir(parents=True, exist_ok=True)
        np.save(cache_file, sketch.hashes)
    return sketch


def compute(ctx: ComputeContext) -> list[dict]:
    """Compute the full query x subject containment tile."""
    kmersize = ctx.config.get("kmersize") or KMER_SIZE
    scaled = _scaled_from_extra(ctx.config.get("extra"))

    hashes = sorted(set(ctx.query_hashes) | set(ctx.subject_hashes))
    sketches = [
        get_sketch(ctx.genomes[h], kmersize, scaled, ctx.cache) for h in hashes
    ]
    identity, cov = containment_ani(sketches)
    index = {h: i for i, h in enumerate(hashes)}

    rows: list[dict] = []
    for q, s in ctx.pending:
        i, j = index[q], index[s]
        ident = identity[i, j]
        c = cov[i, j]
        rows.append(
            {
                "query_hash": q,
                "subject_hash": s,
                "identity": None if np.isnan(ident) else float(ident),
                "cov_query": None if np.isnan(c) else float(c),
                "aln_length": None,
                "sim_errors": None,
                "cov_subject": None,
            }
        )
    ctx.tick(len(rows))
    return rows
