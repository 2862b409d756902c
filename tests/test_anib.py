"""Tests for the ANIb method (BLAST-equivalent fragment alignment).

Oracle: the per-fragment blastn fixture TSVs and the expected matrices.
Our optimal-local DP with blastn scoring reproduces blastn's best HSP
statistics (pident, length, mismatch, gaps) bit-exactly on the viral
fixtures, so integer matrices match exactly.
"""

from pathlib import Path

import pytest

from pyani_plus_tpu.genomes import load_genome
from pyani_plus_tpu.methods.anib import (
    best_fragment_alignment,
    compute_pair,
    fragment_genome,
)
from pyani_plus_tpu.ops.seeds import SeedIndex


@pytest.fixture(scope="module")
def viral():
    d = Path("/root/reference/tests/fixtures/viral_example")
    if not d.is_dir():
        pytest.skip("reference fixtures not available")
    return d


def test_fragment_counts_and_tail(viral) -> None:
    genome = load_genome(viral / "MGV-GENOME-0264574.fas")  # 39253 bp
    frags = fragment_genome(genome, 1020)
    assert len(frags) == 39  # ceil(39253/1020): tails are kept (anib.py:58-88)
    assert frags[-1].size == 39253 - 38 * 1020


def test_per_fragment_blast_parity(viral) -> None:
    """Every fragment's best HSP must match blastn's output exactly."""
    query = load_genome(viral / "MGV-GENOME-0264574.fas")
    subject = load_genome(viral / "MGV-GENOME-0266457.fna")
    expected = {}
    fixture = viral / "intermediates" / "ANIb" / (
        "MGV-GENOME-0264574_vs_MGV-GENOME-0266457.tsv"
    )
    for line in fixture.read_text().splitlines():
        fields = line.split("\t")
        expected.setdefault(
            fields[0],
            (float(fields[2]), int(fields[3]), int(fields[4]), int(fields[6])),
        )
    indexes = [SeedIndex(rec.codes) for rec in subject.records]
    subject_codes = [rec.codes for rec in subject.records]
    for i, frag in enumerate(fragment_genome(query, 1020)):
        name = f"frag{i + 1:05d}"
        stats = best_fragment_alignment(frag, subject_codes, indexes)
        assert stats is not None, name
        got = (
            float(f"{stats.pident:.3f}"),
            stats.length,
            stats.mismatches,
            stats.gaps,
        )
        assert got == expected[name], f"{name}: {got} != {expected[name]}"


def test_pair_summary_matches_doctest_values(viral) -> None:
    """Spot value from reference anib.py doctest (99.5% over 39169, 215 errors)."""
    query = load_genome(viral / "MGV-GENOME-0264574.fas")
    subject = load_genome(viral / "MGV-GENOME-0266457.fna")
    indexes = [SeedIndex(rec.codes) for rec in subject.records]
    identity, aln_length, sim_errors = compute_pair(query, subject, indexes, 1020)
    assert aln_length == 39169
    assert sim_errors == 215
    assert round(100 * identity, 1) == 99.5
    assert abs(identity - 0.9945938462) < 2e-8


def test_device_batched_scores_match_host(viral, monkeypatch) -> None:
    """The padded device batch path picks the same winners as the host path.

    Forces the dp_jax bucketed batch scorer on the CPU backend and
    compares the full pair summary against the host native scorer --
    scores are integer-identical, so results must be too.
    """
    from pyani_plus_tpu.genomes import load_genome
    from pyani_plus_tpu.methods.anib import FRAGSIZE, compute_pair
    from pyani_plus_tpu.ops.seeds import SeedIndex

    q = load_genome(viral / "MGV-GENOME-0264574.fas")
    s = load_genome(viral / "MGV-GENOME-0266457.fna")
    idx = [SeedIndex(rec.codes) for rec in s.records]
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "0")
    host = compute_pair(q, s, idx, FRAGSIZE)
    monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", "1")
    device = compute_pair(q, s, idx, FRAGSIZE)
    assert device == host


def test_group_pooled_scoring_matches_per_pair(viral, monkeypatch) -> None:
    """PYANI_TPU_ANIB_GROUP pools score tasks from several queries into
    shared batches (the cross-pair device amortisation); results must be
    identical to the unpooled per-pair path."""
    import logging

    from pyani_plus_tpu.methods import ComputeContext, anib

    genomes = {
        g.md5: g
        for g in (
            load_genome(p)
            for ext in (".fas", ".fna", ".fasta")
            for p in sorted(viral.glob(f"*{ext}"))
        )
    }

    def run(group):
        monkeypatch.setenv("PYANI_TPU_ANIB_GROUP", group)
        hashes = sorted(genomes)
        ctx = ComputeContext(
            logger=logging.getLogger("t"),
            genomes=genomes,
            query_hashes=hashes,
            subject_hashes=hashes,
            pending={(q, s) for q in hashes for s in hashes},
            config=anib.configuration(),
        )
        rows = anib.compute(ctx)
        return {
            (r["query_hash"], r["subject_hash"]): (
                r["identity"], r["aln_length"], r["sim_errors"]
            )
            for r in rows
        }

    assert run("3") == run("1")


def test_device_pipeline_matches_host_path(viral, monkeypatch) -> None:
    """The one-group-lookahead device pipeline (submit group g, finalize
    group g-1 while the device crunches) returns exactly the serial host
    path's rows -- forced onto the CPU backend via PYANI_TPU_ANIB_DEVICE."""
    import logging

    from pyani_plus_tpu.methods import ComputeContext, anib

    genomes = {
        g.md5: g
        for g in (
            load_genome(p)
            for ext in (".fas", ".fna", ".fasta")
            for p in sorted(viral.glob(f"*{ext}"))
        )
    }

    def run(device, group):
        monkeypatch.setenv("PYANI_TPU_ANIB_DEVICE", device)
        monkeypatch.setenv("PYANI_TPU_ANIB_GROUP", group)
        hashes = sorted(genomes)
        ctx = ComputeContext(
            logger=logging.getLogger("t"),
            genomes=genomes,
            query_hashes=hashes,
            subject_hashes=hashes,
            pending={(q, s) for q in hashes for s in hashes},
            config=anib.configuration(),
        )
        rows = anib.compute(ctx)
        assert len(rows) == len(hashes) ** 2
        return {
            (r["query_hash"], r["subject_hash"]): (
                r["identity"], r["aln_length"], r["sim_errors"],
                r["cov_query"], r["cov_subject"],
            )
            for r in rows
        }

    # group=2 exercises the cross-group pipeline (several groups per
    # subject column) including the trailing-group drain
    assert run("1", "2") == run("0", "1")
