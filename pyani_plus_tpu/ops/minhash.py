"""FracMinHash sketching and all-pairs containment scoring.

Replacement for ``sourmash`` + ``sourmash_plugin_branchwater``
(reference invocations: pyani_plus/methods/sourmash.py:34-206). A sketch is
the sorted set of 64-bit canonical-k-mer hashes whose value is <= 2^64 /
scaled; containment of sketch A in sketch B is |A n B| / |A| and the ANI
point estimate is containment ** (1/k) (verified against the reference's
fixture ``manysearch.csv``).

All-pairs intersection counting has two paths:

- :func:`intersection_matrix_host` -- sparse matmul on host (scipy), used
  for small inputs and as the correctness oracle;
- :func:`intersection_matrix_device` -- the device path: the union of
  hashes is split into fixed-size blocks, each block becomes a dense
  {0,1} membership matrix (N_genomes x block), and a bf16 matrix
  product (cuBLAS on a GPU) computes counts += M @ M.T per block. Exact in float32 for counts < 2^24.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pyani_plus_tpu.genomes import Genome
from pyani_plus_tpu.ops.kmers import canonical_kmer_hashes

DEFAULT_KMER = 31  # ref methods/sourmash.py:31
DEFAULT_SCALED = 1000  # ref methods/sourmash.py:30
GRAM_KERNEL = "containment_gram"  # devmeter name of the device Gram


def max_hash_for_scaled(scaled: int) -> int:
    """sourmash's scaled -> max_hash mapping (float64 rounding included).

    Matches the ``max_hash`` recorded in reference fixture .sig files:

    >>> max_hash_for_scaled(300)
    61489146912365176
    >>> max_hash_for_scaled(1000)
    18446744073709552
    >>> max_hash_for_scaled(1)
    18446744073709551615
    """
    if scaled <= 0:
        msg = f"scaled must be positive, got {scaled}"
        raise ValueError(msg)
    if scaled == 1:
        return 2**64 - 1
    return min(int(round(2**64 / scaled, 0)), 2**64 - 1)


@dataclass(frozen=True)
class Sketch:
    """A FracMinHash sketch: sorted unique retained hashes."""

    md5: str
    ksize: int
    scaled: int
    hashes: np.ndarray  # sorted unique uint64

    @property
    def num_hashes(self) -> int:
        return int(self.hashes.size)


def sketch_genome(genome: Genome, ksize: int = DEFAULT_KMER, scaled: int = DEFAULT_SCALED) -> Sketch:
    """FracMinHash sketch of a genome (all sequences pooled).

    Uses the native C++ hashing kernel when available (bit-identical to
    the numpy path; parity-tested), falling back to numpy otherwise.
    """
    from pyani_plus_tpu.native import sketch_codes_native

    max_hash = np.uint64(max_hash_for_scaled(scaled))
    kept: list[np.ndarray] = []
    for rec in genome.records:
        h = sketch_codes_native(rec.codes, ksize, int(max_hash))
        if h is None:
            h = canonical_kmer_hashes(rec.codes, ksize)
            h = h[h <= max_hash]
        if h.size:
            kept.append(h)
    if kept:
        hashes = np.unique(np.concatenate(kept))
    else:
        hashes = np.empty(0, np.uint64)
    return Sketch(md5=genome.md5, ksize=ksize, scaled=scaled, hashes=hashes)


def intersection_matrix_host(sketches: list[Sketch]) -> np.ndarray:
    """All-pairs |A n B| via sparse matmul on host. Returns (N, N) int64."""
    from scipy import sparse

    n = len(sketches)
    if n == 0:
        return np.zeros((0, 0), dtype=np.int64)
    all_hashes = np.concatenate([s.hashes for s in sketches]) if any(
        s.hashes.size for s in sketches
    ) else np.empty(0, np.uint64)
    if all_hashes.size == 0:
        return np.zeros((n, n), dtype=np.int64)
    _, inverse = np.unique(all_hashes, return_inverse=True)
    rows = np.repeat(np.arange(n), [s.hashes.size for s in sketches])
    data = np.ones(all_hashes.size, dtype=np.int64)
    m = sparse.csr_matrix(
        (data, (rows, inverse)), shape=(n, int(inverse.max()) + 1 if inverse.size else 1)
    )
    return np.asarray((m @ m.T).todense(), dtype=np.int64)


def intersection_matrix_device(
    sketches: list[Sketch], *, block: int = 4096, mesh="auto"
) -> np.ndarray:
    """All-pairs |A n B| on the device via blocked membership matmuls.

    The union of hashes is cut into contiguous id blocks. Each block's
    (genome, id) incidence pairs ship as one padded (nblocks, p_max)
    int32 array of flat scatter indices; a single jitted ``lax.scan``
    then, per block, scatter-adds the {0,1} membership (1D scatter),
    reshapes to (N, block) bfloat16, and accumulates the Gram
    ``counts += M @ M.T`` with float32 accumulation. One dispatch for
    the whole matrix -- no per-block host round trips. ``block`` has not
    been re-tuned for the GPU. Products are 0/1 so bfloat16 operands are
    exact; counts stay exact below 2^24 in the float32 accumulator.

    On a multi-device host the counts tile is sharded over the
    production 2D ("q", "s") pair-grid mesh (``mesh="auto"`` picks
    :func:`pyani_plus_tpu.parallel.tiles.default_pair_mesh`): each
    device computes its (N/nq x N/ns) Gram tile, so all local cards
    contribute -- the SURVEY section 2.4 local-executor analogue. Pass
    ``mesh=None`` to force single-device execution.
    """
    n = len(sketches)
    if n == 0:
        return np.zeros((0, 0), dtype=np.int64)
    if sum(s.hashes.size for s in sketches) == 0:
        return np.zeros((n, n), dtype=np.int64)
    import jax.numpy as jnp

    from pyani_plus_tpu.utils import devmeter

    fn, pts = gram_program(sketches, block=block, mesh=mesh)
    t_submit = devmeter.now()
    counts = np.asarray(fn(jnp.asarray(pts)))
    devmeter.record(t_submit, kernel=GRAM_KERNEL)
    return counts[:n, :n].astype(np.int64)


def gram_program(sketches: list[Sketch], *, block: int = 4096, mesh="auto"):
    """(jitted Gram, its padded scatter-index input) for non-empty sketches.

    Host preparation of :func:`intersection_matrix_device`, split out so
    a caller can compile the program at its real shape without running
    it (``fn.lower(pts).compile()``)."""
    import jax
    import jax.numpy as jnp

    n = len(sketches)
    sizes = [s.hashes.size for s in sketches]
    if mesh == "auto":
        from pyani_plus_tpu.parallel.tiles import default_pair_mesh

        mesh = default_pair_mesh()
    out_sharding = None
    n_rows = n
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        nq, ns = mesh.devices.shape
        tile_mult = int(np.lcm(nq, ns))
        n_rows = -(-n // tile_mult) * tile_mult
        out_sharding = NamedSharding(mesh, PartitionSpec("q", "s"))
    all_hashes = np.concatenate([s.hashes for s in sketches])
    union, inverse = np.unique(all_hashes, return_inverse=True)
    u = union.size
    nblocks = -(-u // block)

    # (genome, id) incidence pairs grouped by id block. ``inverse`` is
    # already ordered id-major after the stable argsort, so each block's
    # pairs are a contiguous slice.
    rows = np.repeat(np.arange(n, dtype=np.int64), sizes)
    order = np.argsort(inverse, kind="stable")
    ids_sorted = inverse[order]
    rows_sorted = rows[order]
    per_block = np.bincount(ids_sorted // block, minlength=nblocks)
    p_max = int(per_block.max())
    # Flat index into the (n_rows * block) membership vector; the pad
    # value n_rows * block scatters into a sacrificial extra slot.
    flat = (rows_sorted * block + (ids_sorted % block)).astype(np.int32)
    pts = np.full((nblocks, p_max), n_rows * block, dtype=np.int32)
    offsets = np.concatenate(([0], np.cumsum(per_block)))
    for b in range(nblocks):
        seg = flat[offsets[b] : offsets[b + 1]]
        pts[b, : seg.size] = seg

    def all_blocks(pts_dev):
        def body(counts, pts_b):
            mem = (
                jnp.zeros((n_rows * block + 1,), jnp.bfloat16)
                .at[pts_b]
                .set(jnp.bfloat16(1))
            )
            mf = mem[:-1].reshape(n_rows, block)
            return (
                counts
                + jnp.dot(mf, mf.T, preferred_element_type=jnp.float32),
                None,
            )

        counts, _ = jax.lax.scan(
            body, jnp.zeros((n_rows, n_rows), jnp.float32), pts_dev
        )
        # Fetch as int32: counts are exact integers below 2^24 in the
        # float32 accumulator, and int32 halves the device->host copy.
        return counts.astype(jnp.int32)

    jitted = (
        jax.jit(all_blocks)
        if out_sharding is None
        else jax.jit(all_blocks, out_shardings=out_sharding)
    )
    return jitted, pts


def containment_ani(
    sketches: list[Sketch],
    *,
    use_device: bool | None = None,
    mesh="auto",
) -> tuple[np.ndarray, np.ndarray]:
    """All-pairs (identity, cov_query) matrices for the sourmash method.

    identity[q, s] = max(c_qs, c_sq) ** (1/k)   ("max_containment_ani")
    cov[q, s]      = c_qs ** (1/k)              ("query_containment_ani")

    where c_qs = |Q n S| / |Q|. Pairs with an empty intersection (or an
    empty sketch) give NaN, matching the reference's absent-pair -> None
    semantics (methods/sourmash.py:140-144).
    """
    n = len(sketches)
    ksize = sketches[0].ksize if sketches else DEFAULT_KMER
    if use_device is None:
        total = sum(s.hashes.size for s in sketches)
        use_device = n >= 64 and total > 1 << 18
    inter = (
        intersection_matrix_device(sketches, mesh=mesh)
        if use_device
        else intersection_matrix_host(sketches)
    )
    sizes = np.array([s.hashes.size for s in sketches], dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        c_q = inter / sizes[:, None]  # containment of query (row) in subject
        c_s = inter / sizes[None, :]  # containment of subject in query
        c_max = np.maximum(c_q, c_s)
        identity = np.power(c_max, 1.0 / ksize)
        cov = np.power(c_q, 1.0 / ksize)
    # Zero intersection or empty sketches -> failed alignment -> NaN
    bad = (inter == 0) | ~np.isfinite(c_q) | ~np.isfinite(c_max)
    identity[bad] = np.nan
    cov[bad] = np.nan
    # Exact 1.0 on the diagonal for self-comparisons with non-empty sketches
    return identity, cov


# ---------------------------------------------------------------------------
# Device sketching: canonical k-mer selection + MurmurHash3 + scaled
# filter entirely on-chip. The genome ships as its 1-byte code array (the
# only host->device traffic); hashing, canonicalisation, the scaled filter
# and the survivor sort all run on the device, and only the ~W/scaled
# kept hashes come back. Bit-identical to sketch_genome (parity-tested).
# Off the main path: only bench.py calls it.
# ---------------------------------------------------------------------------

_DEV_CHUNK_W = 1 << 18  # windows per chunk row
_DEV_BATCH = 4  # chunk rows per device call

_DEV_SKETCH_CACHE: dict[tuple, object] = {}


def _device_sketch_fn(chunk_w: int, k: int, cap: int):
    key = (chunk_w, k, cap)
    fn = _DEV_SKETCH_CACHE.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    from pyani_plus_tpu.ops.murmur3 import murmur64_jax

    decode = np.frombuffer(b"ACGTN", dtype=np.uint8)
    h_len = min(16, k)  # bases in the high packed word

    def run(codes, mh_hi, mh_lo):
        # codes: (B, chunk_w + k - 1) uint8, 0..3 valid / 4 masked+padding
        b = codes.shape[0]
        w = chunk_w
        c = jnp.minimum(codes, 4).astype(jnp.uint8)
        invalid = (c >= 4).astype(jnp.int32)
        csum = jnp.concatenate(
            [jnp.zeros((b, 1), jnp.int32), jnp.cumsum(invalid, axis=1)], axis=1
        )
        valid = (csum[:, k:] - csum[:, :-k]) == 0  # (B, W)
        cc = jnp.minimum(c, 3).astype(jnp.uint32)
        comp = 3 - cc
        lut = jnp.asarray(decode)
        # canonical selection: big-endian 2-bit packing split into two
        # 32-bit words; integer order == lexicographic byte order
        zeros = jnp.zeros((b, w), jnp.uint32)
        hi_f = zeros
        lo_f = zeros
        hi_r = zeros
        lo_r = zeros
        for j in range(k):
            col_f = cc[:, j : j + w]
            col_r = comp[:, k - 1 - j : k - 1 - j + w]
            if j < h_len:
                sh = jnp.uint32(2 * (h_len - 1 - j))
                hi_f = hi_f | (col_f << sh)
                hi_r = hi_r | (col_r << sh)
            else:
                sh = jnp.uint32(2 * (k - 1 - j))
                lo_f = lo_f | (col_f << sh)
                lo_r = lo_r | (col_r << sh)
        take_rc = (hi_r < hi_f) | ((hi_r == hi_f) & (lo_r < lo_f))
        cols = []
        for j in range(k):
            f_b = lut[cc[:, j : j + w]]
            r_b = lut[comp[:, k - 1 - j : k - 1 - j + w]]
            cols.append(jnp.where(take_rc, r_b, f_b))
        kmer_bytes = jnp.stack(cols, axis=2).reshape(b * w, k)
        hh, hl = murmur64_jax(kmer_bytes)
        hh = hh.reshape(b, w)
        hl = hl.reshape(b, w)
        keep = valid & ((hh < mh_hi) | ((hh == mh_hi) & (hl <= mh_lo)))
        full = jnp.uint32(0xFFFFFFFF)
        hh = jnp.where(keep, hh, full)
        hl = jnp.where(keep, hl, full)
        s_hi, s_lo = jax.lax.sort((hh, hl), num_keys=2, dimension=1)
        counts = keep.sum(axis=1).astype(jnp.int32)
        return s_hi[:, :cap], s_lo[:, :cap], counts

    fn = jax.jit(run)
    _DEV_SKETCH_CACHE[key] = fn
    return fn


def sketch_genomes_device(
    genomes: list["Genome"],
    ksize: int = DEFAULT_KMER,
    scaled: int = DEFAULT_SCALED,
    *,
    chunk_w: int = _DEV_CHUNK_W,
    batch: int = _DEV_BATCH,
) -> list[Sketch]:
    """FracMinHash sketches computed on the accelerator (see block comment).

    Chunks from ALL genomes pool into shared fixed-shape device batches,
    so per-dispatch latency amortises across the whole input set. Falls
    back to the host path for any chunk whose kept-hash count exceeds
    the transfer cap (practically impossible at real ``scaled``).
    Bit-identical to sketch_genome.
    """
    max_hash = max_hash_for_scaled(scaled)
    mh_hi = np.uint32(max_hash >> 32)
    mh_lo = np.uint32(max_hash & 0xFFFFFFFF)
    cap = min(chunk_w, chunk_w // max(1, scaled) * 3 + 64)
    fn = _device_sketch_fn(chunk_w, ksize, cap)

    chunks: list[np.ndarray] = []
    owner: list[int] = []
    for gi, genome in enumerate(genomes):
        for rec in genome.records:
            codes = rec.codes
            if codes.size < ksize:
                continue
            for start in range(0, codes.size - ksize + 1, chunk_w):
                piece = codes[start : start + chunk_w + ksize - 1]
                if piece.size < chunk_w + ksize - 1:
                    pad = np.full(chunk_w + ksize - 1, 4, dtype=np.uint8)
                    pad[: piece.size] = piece
                    piece = pad
                chunks.append(piece)
                owner.append(gi)
    kept: dict[int, list[np.ndarray]] = {}
    for base in range(0, len(chunks), batch):
        grp = chunks[base : base + batch]
        while len(grp) < batch:
            grp.append(np.full(chunk_w + ksize - 1, 4, dtype=np.uint8))
        s_hi, s_lo, counts = fn(np.stack(grp), mh_hi, mh_lo)
        s_hi = np.asarray(s_hi, dtype=np.uint64)
        s_lo = np.asarray(s_lo, dtype=np.uint64)
        counts = np.asarray(counts)
        for row in range(min(batch, len(chunks) - base)):
            gi = owner[base + row]
            n = int(counts[row])
            if n > cap:  # pragma: no cover - cap is ~3x the expectation
                from pyani_plus_tpu.ops.kmers import canonical_kmer_hashes

                h = canonical_kmer_hashes(chunks[base + row], ksize)
                kept.setdefault(gi, []).append(h[h <= np.uint64(max_hash)])
                continue
            if n:
                kept.setdefault(gi, []).append(
                    (s_hi[row, :n] << np.uint64(32)) | s_lo[row, :n]
                )
    out = []
    for gi, genome in enumerate(genomes):
        parts = kept.get(gi)
        hashes = (
            np.unique(np.concatenate(parts)) if parts else np.empty(0, np.uint64)
        )
        out.append(
            Sketch(md5=genome.md5, ksize=ksize, scaled=scaled, hashes=hashes)
        )
    return out


def sketch_genome_device(
    genome: "Genome",
    ksize: int = DEFAULT_KMER,
    scaled: int = DEFAULT_SCALED,
    *,
    chunk_w: int = _DEV_CHUNK_W,
    batch: int = _DEV_BATCH,
) -> Sketch:
    """Single-genome convenience wrapper over :func:`sketch_genomes_device`."""
    return sketch_genomes_device(
        [genome], ksize, scaled, chunk_w=chunk_w, batch=batch
    )[0]
