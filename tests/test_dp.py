"""Tests for the alignment DP kernels (numpy oracle + JAX parity)."""

import numpy as np

from pyani_plus_tpu.genomes import encode_sequence
from pyani_plus_tpu.ops.dp import local_align_stats
from pyani_plus_tpu.ops.dp_jax import batch_local_align_scores


def test_exact_match() -> None:
    a = encode_sequence(b"ACGTACGTACGTACGTACGT")
    st = local_align_stats(a, a)
    assert (st.score, st.matches, st.mismatches, st.gaps) == (40, 20, 0, 0)


def test_single_mismatch() -> None:
    a = encode_sequence(b"ACGTACGTACGTACGTACGT")
    b = encode_sequence(b"ACGTACGTTCGTACGTACGT")
    st = local_align_stats(a, b)
    assert (st.length, st.matches, st.mismatches) == (20, 19, 1)


def test_gap() -> None:
    a = encode_sequence(b"ACGTACGTACGTACGTACGT")
    b = encode_sequence(b"ACGTACGTGTACGTACGT")  # 2bp deletion
    st = local_align_stats(a, b)
    assert st.gaps == 2
    assert st.gap_opens == 1
    assert st.matches == 18
    # score: 18*2 - (5 + 2*2) = 27
    assert st.score == 27


def test_n_never_matches() -> None:
    d = encode_sequence(b"ACGTNNNNACGT")
    st = local_align_stats(d, d)
    # Best local clips to one ACGT run: crossing 4 Ns costs 4*3 > 8 gain
    assert st.score == 8
    assert st.matches == 4


def test_no_alignment_returns_none() -> None:
    a = encode_sequence(b"AAAA")
    b = encode_sequence(b"TTTT")
    assert local_align_stats(a, b) is None


def test_jax_score_parity() -> None:
    rng = np.random.default_rng(11)
    B, M, N = 6, 60, 90
    qs = rng.integers(0, 4, (B, M)).astype(np.uint8)
    ss = rng.integers(0, 4, (B, N)).astype(np.uint8)
    for i in range(0, B, 2):
        ss[i, 5 : 5 + M] = qs[i]
        mut = rng.random(M) < 0.1
        ss[i, 5 : 5 + M][mut] = (ss[i, 5 : 5 + M][mut] + 1) % 4
    jax_scores = np.asarray(batch_local_align_scores(qs, ss))
    for i in range(B):
        st = local_align_stats(qs[i], ss[i])
        expected = 0 if st is None else st.score
        assert jax_scores[i] == expected, i


def _extension_tasks(rng, count: int, lo: int = 60, hi: int = 1200):
    tasks = []
    for _ in range(count):
        m = int(rng.integers(lo, hi))
        n = int(rng.integers(lo, hi))
        a = rng.integers(0, 5, m).astype(np.uint8)
        b = rng.integers(0, 4, n).astype(np.uint8)
        if rng.random() < 0.6:
            span = min(m, n)
            b[:span] = a[:span] % 4
            mut = rng.random(span) < 0.1
            b[:span][mut] = (b[:span][mut] + 1) % 4
        tasks.append((a, b))
    return tasks


def test_batch_extend_wrapper_parity() -> None:
    """The GPU kernel's wrapper (task sorting, packing, lane padding,
    result order), driven here by the host executor over the same packed
    buffers, matches the native kernel bit-for-bit: give-up rule, N
    codes, uneven lanes."""
    from pyani_plus_tpu.native import band_dp_native
    from pyani_plus_tpu.ops.extend import EXTEND, MATCH, MISMATCH, OPEN
    from pyani_plus_tpu.ops.extend_gpu import batch_extend, host_executor

    tasks = _extension_tasks(np.random.default_rng(41), 20, hi=1100)
    got = batch_extend(tasks, stop_rows=600, executor=host_executor)
    for idx, (a, b) in enumerate(tasks):
        i, j, _score, err, nid, gap = band_dp_native(
            a, b, 60, True, MATCH, MISMATCH, OPEN, EXTEND, 600
        )
        assert tuple(got[idx]) == (i, j, err, nid, gap)


def test_batch_extend_wrapper_launch_layout() -> None:
    """One launch per call: tasks longest first, task count and byte
    buffers padded to powers of two, padding tasks empty, and results
    returned in the caller's order."""
    from pyani_plus_tpu.ops.extend import extend_errors
    from pyani_plus_tpu.ops.extend_gpu import batch_extend, host_executor

    tasks = _extension_tasks(np.random.default_rng(3), 37)
    launches = []

    def recording(meta, a, b, stop_rows):
        launches.append((meta.copy(), a.size, b.size, stop_rows))
        return host_executor(meta, a, b, stop_rows)

    got = batch_extend(tasks, stop_rows=600, executor=recording)
    assert len(launches) == 1
    meta, a_size, b_size, stop_rows = launches[0]
    assert stop_rows == 600
    assert meta.shape == (64, 4)
    for size in (a_size, b_size):
        assert size & (size - 1) == 0
    m = meta[:37, 1]
    assert list(m) == sorted((t[0].size for t in tasks), reverse=True)
    assert (meta[37:, 1] == 0).all() and (meta[37:, 3] == 0).all()
    assert list(meta[1:37, 0]) == list(np.cumsum(m)[:-1])
    assert got == [extend_errors(a, b) for a, b in tasks]


def test_batch_extend_wrapper_routes_misfits_to_host() -> None:
    """Tasks past MAX_ROWS (packed-key headroom), with an empty tail, or
    with both tails shorter than the band run on the host kernel in
    their original task positions; the rest share one launch."""
    from pyani_plus_tpu.ops.extend import extend_errors
    from pyani_plus_tpu.ops.extend_gpu import MAX_ROWS, batch_extend, host_executor

    rng = np.random.default_rng(7)
    big = MAX_ROWS + 64
    tasks = []
    for m, n in ((big, 400), (300, 280), (40, 30), (0, 50), (256, 300)):
        a = rng.integers(0, 4, m).astype(np.uint8)
        b = a[: min(m, n)].copy()
        mut = rng.random(b.size) < 0.05
        b[mut] = (b[mut] + 1) % 4
        tasks.append((a, b[:n] if n <= b.size else b))
    seen = []

    def recording(meta, a, b, stop_rows):
        seen.extend(int(v) for v in meta[:, 1] if v)
        return host_executor(meta, a, b, stop_rows)

    got = batch_extend(tasks, stop_rows=600, executor=recording)
    assert seen == [300, 256]
    for idx, (a, b) in enumerate(tasks):
        assert tuple(got[idx]) == tuple(extend_errors(a, b)), idx


def _force_batched_extensions(monkeypatch) -> None:
    """Send every ANIm extension batch through the GPU kernel's wrapper,
    with the host executor standing in for the launch."""
    from functools import partial

    from pyani_plus_tpu.methods import anim
    from pyani_plus_tpu.ops.extend_gpu import host_executor

    monkeypatch.setattr(
        anim,
        "_run_extensions",
        partial(anim._run_extensions, executor=host_executor),
    )


def test_anim_device_extension_pipeline_parity(monkeypatch) -> None:
    """Routing extensions through the batched wrapper leaves ANIm results
    unchanged (reference viral genomes)."""
    from pathlib import Path

    import pytest

    d = Path("/root/reference/tests/fixtures/viral_example")
    if not d.is_dir():
        pytest.skip("reference fixtures not available")
    from pyani_plus_tpu.genomes import load_genome
    from pyani_plus_tpu.methods.anim import compute_pair

    fastas = sorted(d.glob("*.f*"))[:2]
    q, s = (load_genome(p) for p in fastas)
    host = compute_pair(q, s)
    _force_batched_extensions(monkeypatch)
    assert compute_pair(q, s) == host


def test_anim_batched_extension_pipeline_parity_synthetic(monkeypatch) -> None:
    """The same on seeded genomes: ~90% ANI with indels, two contigs."""
    from pathlib import Path

    from pyani_plus_tpu.genomes import Genome, SequenceRecord
    from pyani_plus_tpu.methods import anim
    from pyani_plus_tpu.methods.anim import compute_pair

    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 30000).astype(np.uint8)
    qry = ref.copy()
    qry[rng.random(qry.size) < 0.08] = rng.integers(0, 4)
    qry = np.delete(qry, rng.choice(qry.size, 60, replace=False))
    calls = []
    production = anim._run_extensions

    def genome(name, codes):
        recs = [SequenceRecord(f"{name}{i}".encode(), c) for i, c in enumerate(np.split(codes, [12000]))]
        return Genome(md5=name * 32, path=Path(name), records=recs)

    q, s = genome("a", qry), genome("b", ref)
    host = compute_pair(q, s)
    _force_batched_extensions(monkeypatch)
    batched = anim._run_extensions
    monkeypatch.setattr(
        anim, "_run_extensions", lambda t, **kw: calls.append(len(t)) or batched(t, **kw)
    )
    assert compute_pair(q, s) == host
    assert host["identity"] is not None and sum(calls) > 4
    assert production is not batched


def test_iupac_letter_equality_identities() -> None:
    """blastn counts identities by LETTER equality: N==N or W==W columns
    are identities (scored as penalties), but two DIFFERENT ambiguity
    letters (W vs R) are mismatches -- the per-letter ambiguity encoding
    (genomes._ENCODE) carries this through the traceback."""
    flank = b"ACGTACGTACGTACGTACGT"
    q = encode_sequence(flank + b"WW" + flank)
    s_same = encode_sequence(flank + b"WW" + flank)
    s_diff = encode_sequence(flank + b"RK" + flank)
    st_same = local_align_stats(q, s_same)
    st_diff = local_align_stats(q, s_diff)
    # identical scores (both ambiguity columns score as mismatch)...
    assert st_same.score == st_diff.score
    assert st_same.length == st_diff.length == 42
    # ...but letter-equal columns count as identities
    assert (st_same.matches, st_same.mismatches) == (42, 0)
    assert (st_diff.matches, st_diff.mismatches) == (40, 2)


def test_iupac_fuzz_native_numpy_parity() -> None:
    """Fuzz: native and numpy stats DPs agree field-for-field on
    sequences salted with the full IUPAC alphabet."""
    rng = np.random.default_rng(42)
    letters = np.frombuffer(b"ACGTNRYSWKMBDHV", dtype=np.uint8)
    for _ in range(25):
        m = int(rng.integers(10, 120))
        n = int(rng.integers(10, 160))
        q = encode_sequence(letters[rng.integers(0, 15, m)].tobytes())
        s = encode_sequence(letters[rng.integers(0, 15, n)].tobytes())
        a = local_align_stats(q, s)
        b = local_align_stats(q, s, force_numpy=True)
        assert (a is None) == (b is None)
        if a is not None:
            assert a == b


def test_batch_best_trim_equivalence_fuzz() -> None:
    """batch_local_align_best returns the host DP's exact argmax cell
    (first max in row-major order), and the stats DP on the trimmed
    prefix domain query[:best_i] x subject[:best_j] is field-for-field
    identical to the full-domain stats DP."""
    from pyani_plus_tpu.ops.dp_jax import PAD_CODE, batch_local_align_best

    rng = np.random.default_rng(7)
    tasks = []
    for _ in range(24):
        m = int(rng.integers(20, 90))
        n = int(rng.integers(30, 140))
        q = rng.integers(0, 5, m).astype(np.uint8)
        s = rng.integers(0, 5, n).astype(np.uint8)
        if rng.random() < 0.7:  # plant homology so alignments exist
            ln = min(m, n) // 2
            s[:ln] = q[:ln]
        tasks.append((q, s))
    mmax = max(q.size for q, _ in tasks)
    nmax = max(s.size for _, s in tasks)
    qb = np.full((len(tasks), mmax), PAD_CODE, np.uint8)
    sb = np.full((len(tasks), nmax), PAD_CODE, np.uint8)
    for i, (q, s) in enumerate(tasks):
        qb[i, : q.size] = q
        sb[i, : s.size] = s
    out = np.asarray(batch_local_align_best(qb, sb))
    for i, (q, s) in enumerate(tasks):
        score, bi, bj = (int(v) for v in out[i])
        full = local_align_stats(q, s)
        if full is None:
            assert score <= 0, (i, score)
            continue
        assert score == full.score, (i, score, full.score)
        assert (bi, bj) == (full.query_end, full.subject_end), i
        trimmed = local_align_stats(q[:bi], s[:bj])
        assert trimmed == full, (i, trimmed, full)
