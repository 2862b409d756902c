"""Affine-gap local alignment DP with alignment statistics.

The numeric core replacing BLAST+ (`blastn`, ANIb fragments) and
nucmer's extension stage (ANIm) -- SURVEY.md section 2.2. Scoring
follows ``blastn -task blastn`` defaults: reward +2, penalty -3, gap
open 5, gap extend 2 (a gap of length L costs 5 + 2L).

Row-vectorised Smith-Waterman: within a row the horizontal (E) state is
computed with a prefix-cummax, exploiting the affine-gap property that a
gap immediately following a gap in the same direction is never optimal:

    E[j] = max_{j'<j} (G[j'] + ge*j') - go - ge*j,
    G[j] = max(0, diag[j], F[j])

so each row is a handful of vector ops -- the same shape used by the
JAX batched kernel in ops/dp_jax.py (anti-diagonal-free, scan over query rows with
length-n row vectors; cummax = associative max scan).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

REWARD = 2
PENALTY = -3
GAP_OPEN = 5
GAP_EXTEND = 2

NEG = np.int32(-(10**6))


@dataclass(frozen=True)
class AlignmentStats:
    """Statistics of one local alignment."""

    score: int
    length: int  # alignment columns
    matches: int
    mismatches: int
    gaps: int  # total gap columns (sum of gap lengths)
    gap_opens: int
    query_start: int  # 0-based inclusive
    query_end: int  # 0-based exclusive
    subject_start: int
    subject_end: int

    @property
    def pident(self) -> float:
        return 100.0 * self.matches / self.length if self.length else 0.0


def local_align_stats(  # noqa: C901, PLR0912
    query: np.ndarray,
    subject: np.ndarray,
    *,
    reward: int = REWARD,
    penalty: int = PENALTY,
    gap_open: int = GAP_OPEN,
    gap_extend: int = GAP_EXTEND,
    force_numpy: bool = False,
) -> AlignmentStats | None:
    """Optimal local alignment of two uint8 code arrays, with statistics.

    Codes 0..3 are bases; codes >= 4 (N/ambiguous) never MATCH anything
    for scoring (BLAST scores unknown residues as mismatches), but the
    traceback counts letter-equal columns (e.g. N==N) as identities.
    Returns None if no positive-scoring alignment exists.

    Dispatches to the native C++ kernel (bit-identical, ~300x faster)
    when available; ``force_numpy`` pins the numpy path (parity tests).
    """
    if not force_numpy:
        from pyani_plus_tpu.native import local_align_stats_native

        native = local_align_stats_native(
            query, subject, reward, penalty, gap_open, gap_extend
        )
        if native is False:
            return None
        if native is not None:
            return AlignmentStats(*native)
    m, n = int(query.size), int(subject.size)
    if m == 0 or n == 0:
        return None
    q = query.astype(np.int16)
    s = subject.astype(np.int16)
    go_ge = gap_open + gap_extend
    ge = gap_extend

    H = np.zeros((m + 1, n + 1), dtype=np.int32)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int32)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int32)

    jidx = np.arange(1, n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        match = (s == q[i - 1]) & (q[i - 1] < 4) & (s < 4)
        sub = np.where(match, reward, penalty).astype(np.int32)
        diag = H[i - 1, :-1] + sub
        f = np.maximum(H[i - 1, 1:] - go_ge, F[i - 1, 1:] - ge)
        g = np.maximum(np.maximum(diag, f), 0)
        a = g + ge * jidx
        cummax = np.maximum.accumulate(a)
        # E[j] looks at j' < j: shift the prefix max right by one
        e = np.empty(n, dtype=np.int32)
        e[0] = NEG
        e[1:] = cummax[:-1] - gap_open - ge * jidx[1:]
        h = np.maximum(g, e)
        H[i, 1:] = h
        E[i, 1:] = e
        F[i, 1:] = f

    best_flat = int(H.argmax())
    best_i, best_j = divmod(best_flat, n + 1)
    best_score = int(H[best_i, best_j])
    if best_score <= 0:
        return None

    # Traceback (preference: diagonal > E > F on ties)
    i, j = best_i, best_j
    matches = mismatches = gaps = gap_opens = length = 0
    while i > 0 and j > 0 and H[i, j] > 0:
        is_match = q[i - 1] == s[j - 1] and q[i - 1] < 4 and s[j - 1] < 4
        sub = reward if is_match else penalty
        if H[i, j] == H[i - 1, j - 1] + sub:
            length += 1
            # blastn counts IDENTITIES by letter equality: N aligned to
            # N is an identity (pident 100.000 across an N run) even
            # though it SCORES as a penalty column.
            if q[i - 1] == s[j - 1]:
                matches += 1
            else:
                mismatches += 1
            i -= 1
            j -= 1
        elif H[i, j] == E[i, j]:
            # Horizontal gap (in query) ending at (i, j): find its length
            # L as the smallest L with E[i,j] == G[i, j-L] - go - ge*L,
            # where G = max(0, diag, F) (a gap never follows a gap in the
            # same direction under affine costs).
            gap_opens += 1
            target = int(E[i, j])
            ln = 1
            while j - ln > 1:
                g_here = _g_value(H, F, q, s, i, j - ln, reward, penalty)
                if g_here - gap_open - ge * ln == target:
                    break
                ln += 1
            length += ln
            gaps += ln
            j -= ln
        else:
            # Vertical gap (in subject): F[i,j] = max_L H[i-L,j] - go - ge*L
            gap_opens += 1
            target = int(F[i, j])
            ln = 1
            while i - ln > 1:
                if int(H[i - ln, j]) - gap_open - ge * ln == target:
                    break
                ln += 1
            length += ln
            gaps += ln
            i -= ln

    return AlignmentStats(
        score=best_score,
        length=length,
        matches=matches,
        mismatches=mismatches,
        gaps=gaps,
        gap_opens=gap_opens,
        query_start=i,
        query_end=best_i,
        subject_start=j,
        subject_end=best_j,
    )


def _sub(q, s, i, j, reward, penalty):  # pragma: no cover - helper
    is_match = q[i - 1] == s[j - 1] and q[i - 1] < 4 and s[j - 1] < 4
    return reward if is_match else penalty


def _g_value(H, F, q, s, i, j, reward, penalty):
    """G[i,j] = max(0, diag, F) -- the non-E candidates at a cell."""
    is_match = q[i - 1] == s[j - 1] and q[i - 1] < 4 and s[j - 1] < 4
    sub = reward if is_match else penalty
    return max(0, H[i - 1, j - 1] + sub, int(F[i, j]))
