"""Batched affine-gap local alignment scores in JAX (the ANIb device scorer).

Same recurrence as ops/dp.py, expressed as a ``lax.scan`` over query
rows with length-N row vectors; the within-row horizontal (E) state is
a prefix cummax (``jax.lax.cummax``), using the affine-gap property
that chained same-direction gaps are never optimal:

    E[j] = max_{j'<j}(G[j'] + ge*j') - go - ge*j

The kernel is score-only (no traceback) and vmapped over a batch of
(query, subject) pairs with static shapes -- fragments pad to the batch
shape with code 5 (never matches, never equals anything). Statistics
for the winning window are recovered on host with the exact DP
(ops/dp.py) on just that window.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from pyani_plus_tpu.ops.dp import GAP_EXTEND, GAP_OPEN, PENALTY, REWARD

PAD_CODE = 5  # never matches anything, including itself


def _row_step(carry, q_code, *, reward, penalty, go_ge, ge, jidx, neg):
    import jax.numpy as jnp
    import jax

    h_prev, f_prev, best, s_codes = carry
    match = (s_codes == q_code) & (q_code < 4) & (s_codes < 4)
    sub = jnp.where(match, reward, penalty)
    diag = jnp.concatenate([jnp.zeros((1,), h_prev.dtype), h_prev[:-1]]) + sub
    f = jnp.maximum(h_prev - go_ge, f_prev - ge)
    g = jnp.maximum(jnp.maximum(diag, f), 0)
    a = g + ge * jidx
    cummax = jax.lax.cummax(a)
    e = (
        jnp.concatenate([jnp.full((1,), neg, a.dtype), cummax[:-1]])
        - (go_ge - ge)
        - ge * jidx
    )
    h = jnp.maximum(g, e)
    best = jnp.maximum(best, jnp.max(h))
    return (h, f, best, s_codes), None


def _row_step_best(carry, xs, *, reward, penalty, go_ge, ge, jidx, neg):
    """Row step that also tracks the argmax CELL with the host DPs'
    exact tie rule: first maximum in row-major order (strict improvement
    only, jnp.argmax = first occurrence within the row)."""
    import jax.numpy as jnp
    import jax

    q_code, i_row = xs
    h_prev, f_prev, best, best_i, best_j, s_codes = carry
    match = (s_codes == q_code) & (q_code < 4) & (s_codes < 4)
    sub = jnp.where(match, reward, penalty)
    diag = jnp.concatenate([jnp.zeros((1,), h_prev.dtype), h_prev[:-1]]) + sub
    f = jnp.maximum(h_prev - go_ge, f_prev - ge)
    g = jnp.maximum(jnp.maximum(diag, f), 0)
    a = g + ge * jidx
    cummax = jax.lax.cummax(a)
    e = (
        jnp.concatenate([jnp.full((1,), neg, a.dtype), cummax[:-1]])
        - (go_ge - ge)
        - ge * jidx
    )
    h = jnp.maximum(g, e)
    row_best = jnp.max(h)
    improved = row_best > best
    best = jnp.where(improved, row_best, best)
    best_i = jnp.where(improved, i_row, best_i)  # 1-based row
    best_j = jnp.where(improved, jnp.argmax(h).astype(jnp.int32) + 1, best_j)
    return (h, f, best, best_i, best_j, s_codes), None


_KERNEL_CACHE: dict[tuple[int, int, int, int], object] = {}


def _get_kernel(reward: int, penalty: int, gap_open: int, gap_extend: int):
    """Jitted batch scorer for one scoring-parameter set.

    One persistent jit per parameter set: XLA caches a compiled
    executable per input shape, so bucketing callers to a small set of
    padded (B, M, N) shapes amortises compilation across batches.
    """
    key = (reward, penalty, gap_open, gap_extend)
    fn = _KERNEL_CACHE.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        def batch(queries, subjects):
            # inputs arrive as uint8 (4x less host->device transfer
            # than int32); widen on device
            queries = queries.astype(jnp.int32)
            subjects = subjects.astype(jnp.int32)
            n = subjects.shape[1]
            neg = jnp.int32(-(10**6))
            jidx = jnp.arange(1, n + 1, dtype=jnp.int32)
            step = partial(
                _row_step,
                reward=jnp.int32(reward),
                penalty=jnp.int32(penalty),
                go_ge=jnp.int32(gap_open + gap_extend),
                ge=jnp.int32(gap_extend),
                jidx=jidx,
                neg=neg,
            )

            def one_pair(q_row, s_row):
                h0 = jnp.zeros((n,), jnp.int32)
                f0 = jnp.full((n,), neg, jnp.int32)
                (_, _, best, _), _ = jax.lax.scan(
                    lambda c, q: step(c, q), (h0, f0, jnp.int32(0), s_row), q_row
                )
                return best

            return jax.vmap(one_pair)(queries, subjects)

        fn = jax.jit(batch)
        _KERNEL_CACHE[key] = fn
    return fn


_BEST_KERNEL_CACHE: dict[tuple[int, int, int, int], object] = {}


def _get_best_kernel(reward: int, penalty: int, gap_open: int, gap_extend: int):
    """Jitted batch scorer returning (score, best_i, best_j) per pair."""
    key = (reward, penalty, gap_open, gap_extend)
    fn = _BEST_KERNEL_CACHE.get(key)
    if fn is None:
        import jax
        import jax.numpy as jnp

        def batch(queries, subjects):
            queries = queries.astype(jnp.int32)
            subjects = subjects.astype(jnp.int32)
            m = queries.shape[1]
            n = subjects.shape[1]
            neg = jnp.int32(-(10**6))
            jidx = jnp.arange(1, n + 1, dtype=jnp.int32)
            step = partial(
                _row_step_best,
                reward=jnp.int32(reward),
                penalty=jnp.int32(penalty),
                go_ge=jnp.int32(gap_open + gap_extend),
                ge=jnp.int32(gap_extend),
                jidx=jidx,
                neg=neg,
            )
            rows = jnp.arange(1, m + 1, dtype=jnp.int32)

            def one_pair(q_row, s_row):
                h0 = jnp.zeros((n,), jnp.int32)
                f0 = jnp.full((n,), neg, jnp.int32)
                (_, _, best, bi, bj, _), _ = jax.lax.scan(
                    step,
                    (h0, f0, jnp.int32(0), jnp.int32(0), jnp.int32(0), s_row),
                    (q_row, rows),
                )
                return jnp.stack([best, bi, bj])

            return jax.vmap(one_pair)(queries, subjects)

        fn = jax.jit(batch)
        _BEST_KERNEL_CACHE[key] = fn
    return fn


def batch_local_align_scores(
    queries: np.ndarray,  # (B, M) uint8 codes, padded with PAD_CODE
    subjects: np.ndarray,  # (B, N) uint8 codes, padded with PAD_CODE
    *,
    reward: int = REWARD,
    penalty: int = PENALTY,
    gap_open: int = GAP_OPEN,
    gap_extend: int = GAP_EXTEND,
):
    """Best local alignment score for each (query, subject) row pair.

    On a multi-device host the batch axis shards over the production
    pair mesh (parallel/tiles.default_pair_mesh): each device scores its
    slice of the (fragment, window) tasks and XLA gathers the scores --
    embarrassingly parallel across the cards.
    Single-device (and PYANI_TPU_MESH=0) keeps the plain path.
    """
    import jax
    import jax.numpy as jnp

    fn = _get_kernel(reward, penalty, gap_open, gap_extend)
    return _dispatch_sharded(fn, queries, subjects)


def _dispatch_sharded(fn, queries: np.ndarray, subjects: np.ndarray):
    """Run a batched kernel with the batch axis sharded over the
    production pair mesh (multi-device hosts); plain path otherwise."""
    import jax
    import jax.numpy as jnp

    from pyani_plus_tpu.parallel.tiles import default_pair_mesh

    mesh = default_pair_mesh()
    if mesh is not None and mesh.devices.size > 1:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        ndev = int(mesh.devices.size)
        b = queries.shape[0]
        pad = (-b) % ndev
        if pad:
            queries = np.concatenate(
                [queries, np.full((pad, queries.shape[1]), PAD_CODE, queries.dtype)]
            )
            subjects = np.concatenate(
                [subjects, np.full((pad, subjects.shape[1]), PAD_CODE, subjects.dtype)]
            )
        sharding = NamedSharding(mesh, P(("q", "s")))
        q_dev = jax.device_put(jnp.asarray(queries), sharding)
        s_dev = jax.device_put(jnp.asarray(subjects), sharding)
        return fn(q_dev, s_dev)[:b]

    # ship uint8; the kernels widen on device (4x less transfer)
    return fn(jnp.asarray(queries), jnp.asarray(subjects))


def batch_local_align_best(
    queries: np.ndarray,  # (B, M) uint8 codes, padded with PAD_CODE
    subjects: np.ndarray,  # (B, N) uint8 codes, padded with PAD_CODE
    *,
    reward: int = REWARD,
    penalty: int = PENALTY,
    gap_open: int = GAP_OPEN,
    gap_extend: int = GAP_EXTEND,
):
    """(B, 3) int32 [score, best_i, best_j] per row pair (1-based cell).

    best_i/best_j use the host DPs' exact argmax rule (first maximum in
    row-major order), so the exact-stats DP can run on the TRIMMED
    prefix domain query[:best_i] x subject[:best_j]: every DP value in
    that prefix rectangle is independent of the removed rows/columns,
    and the winning cell's row-major-first property is inherited --
    identical traceback, fewer cells (tests/test_dp.py fuzz-locks it).
    """
    fn = _get_best_kernel(reward, penalty, gap_open, gap_extend)
    return _dispatch_sharded(fn, queries, subjects)
