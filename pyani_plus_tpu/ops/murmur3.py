"""Vectorised MurmurHash3 x64-128 (first 64 bits), sourmash-compatible.

sourmash's FracMinHash keeps the low 64 bits of MurmurHash3_x64_128 of the
canonical k-mer string with seed 42 ("0.murmur64" in the .sig JSON, see e.g.
tests/fixtures/viral_example/intermediates/sourmash/*.sig in the reference).
We reimplement that hash as a batch operation over an (N, L) uint8 matrix of
N equal-length byte strings, so a whole genome's k-mers hash in one
vectorised sweep.

Two implementations with identical outputs:

- :func:`murmur64_numpy` -- host numpy, uint64 modular arithmetic; the
  correctness oracle and the default for host-side sketching.
- :func:`murmur64_jax`   -- JAX, written as (hi, lo) uint32 pairs so it runs
  without 64-bit integer types; jit/vmap friendly. Used by the
  device sketching path.

MurmurHash3 is public domain (Austin Appleby).
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)
_M5 = np.uint64(5)
_N1 = np.uint64(0x52DCE729)
_N2 = np.uint64(0x38495AB5)


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r_ = np.uint64(r)
    inv = np.uint64(64 - r)
    return (x << r_) | (x >> inv)


def _fmix64(k: np.ndarray) -> np.ndarray:
    s33 = np.uint64(33)
    k ^= k >> s33
    k *= _F1
    k ^= k >> s33
    k *= _F2
    k ^= k >> s33
    return k


def _le_u64(block: np.ndarray) -> np.ndarray:
    """Assemble little-endian uint64 from an (..., 8) uint8 array."""
    block = np.ascontiguousarray(block)
    if block.strides[-1] == 1 and block.shape[-1] == 8:
        # Fast path: reinterpret 8 contiguous bytes as one LE uint64
        # (numpy is little-endian on all supported platforms here).
        # copy: callers mutate in place, and the source may be read-only
        return block.view("<u8").reshape(block.shape[:-1]).copy()
    out = np.zeros(block.shape[:-1], dtype=np.uint64)  # pragma: no cover
    for i in range(8):  # pragma: no cover
        out |= block[..., i].astype(np.uint64) << np.uint64(8 * i)
    return out  # pragma: no cover


def murmur64_numpy(data: np.ndarray, seed: int = 42) -> np.ndarray:
    """Batch MurmurHash3 x64-128 (low word) of N equal-length byte rows.

    ``data`` is an (N, L) uint8 array; returns an (N,) uint64 array equal to
    the first 64 bits of MurmurHash3_x64_128(row_bytes, seed) for each row.
    """
    if data.ndim == 1:
        data = data[None, :]
    n, length = data.shape
    with np.errstate(over="ignore"):
        h1 = np.full(n, np.uint64(seed), dtype=np.uint64)
        h2 = np.full(n, np.uint64(seed), dtype=np.uint64)

        nblocks = length // 16
        for b in range(nblocks):
            k1 = _le_u64(data[:, b * 16 : b * 16 + 8])
            k2 = _le_u64(data[:, b * 16 + 8 : b * 16 + 16])

            k1 *= _C1
            k1 = _rotl64(k1, 31)
            k1 *= _C2
            h1 ^= k1

            h1 = _rotl64(h1, 27)
            h1 += h2
            h1 = h1 * _M5 + _N1

            k2 *= _C2
            k2 = _rotl64(k2, 33)
            k2 *= _C1
            h2 ^= k2

            h2 = _rotl64(h2, 31)
            h2 += h1
            h2 = h2 * _M5 + _N2

        tail = data[:, nblocks * 16 :]
        ntail = length & 15
        if ntail > 0:
            k1 = np.zeros(n, dtype=np.uint64)
            k2 = np.zeros(n, dtype=np.uint64)
            for i in range(min(ntail, 8)):
                k1 |= tail[:, i].astype(np.uint64) << np.uint64(8 * i)
            for i in range(8, ntail):
                k2 |= tail[:, i].astype(np.uint64) << np.uint64(8 * (i - 8))
            if ntail > 8:
                k2 *= _C2
                k2 = _rotl64(k2, 33)
                k2 *= _C1
                h2 ^= k2
            k1 *= _C1
            k1 = _rotl64(k1, 31)
            k1 *= _C2
            h1 ^= k1

        ln = np.uint64(length)
        h1 ^= ln
        h2 ^= ln
        h1 += h2
        h2 += h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 += h2
        # h2 += h1  # second word unused; we return the first 64 bits
    return h1


# ---------------------------------------------------------------------------
# JAX implementation via (hi, lo) uint32 pairs -- runs without jax x64.
# ---------------------------------------------------------------------------


def _jax_ops():
    import jax.numpy as jnp

    u32 = jnp.uint32

    def mk(x: int):
        return (jnp.uint32((x >> 32) & 0xFFFFFFFF), jnp.uint32(x & 0xFFFFFFFF))

    def add64(a, b):
        lo = a[1] + b[1]
        carry = (lo < a[1]).astype(u32)
        hi = a[0] + b[0] + carry
        return (hi, lo)

    def xor64(a, b):
        return (a[0] ^ b[0], a[1] ^ b[1])

    def mul64(a, b):
        # 64x64 -> low 64 via 16-bit limbs? 32-bit partial products suffice:
        # (ah*2^32+al)*(bh*2^32+bl) mod 2^64 = (al*bl) + ((ah*bl+al*bh)<<32)
        ah, al = a
        bh, bl = b

        def mul32(x, y):
            # 32x32 -> 64 as (hi, lo) via 16-bit halves
            x0 = x & jnp.uint32(0xFFFF)
            x1 = x >> jnp.uint32(16)
            y0 = y & jnp.uint32(0xFFFF)
            y1 = y >> jnp.uint32(16)
            p00 = x0 * y0
            p01 = x0 * y1
            p10 = x1 * y0
            p11 = x1 * y1
            mid = p01 + p10  # may overflow 32 bits
            mid_carry = (mid < p01).astype(u32)
            lo = p00 + (mid << jnp.uint32(16))
            lo_carry = (lo < p00).astype(u32)
            hi = (
                p11
                + (mid >> jnp.uint32(16))
                + (mid_carry << jnp.uint32(16))
                + lo_carry
            )
            return (hi, lo)

        hi_ll, lo_ll = mul32(al, bl)
        cross = al * bh + ah * bl  # mod 2^32 is fine: it lands in the hi word
        return (hi_ll + cross, lo_ll)

    def rotl64(a, r: int):
        hi, lo = a
        if r == 32:
            return (lo, hi)
        if r > 32:
            hi, lo = lo, hi
            r -= 32
        rr = jnp.uint32(r)
        inv = jnp.uint32(32 - r)
        return ((hi << rr) | (lo >> inv), (lo << rr) | (hi >> inv))

    def shr64(a, r: int):
        hi, lo = a
        if r >= 32:
            return (jnp.zeros_like(hi), hi >> jnp.uint32(r - 32)) if r > 32 else (
                jnp.zeros_like(hi),
                hi,
            )
        rr = jnp.uint32(r)
        inv = jnp.uint32(32 - r)
        return (hi >> rr, (lo >> rr) | (hi << inv))

    return jnp, mk, add64, xor64, mul64, rotl64, shr64


def murmur64_jax(data, seed: int = 42):
    """JAX version of :func:`murmur64_numpy` over an (N, L) uint8 array.

    Returns a pair of (N,) uint32 arrays ``(hi, lo)`` holding the 64-bit
    hash split into high/low words (no uint64 without jax x64).
    """
    jnp, mk, add64, xor64, mul64, rotl64, shr64 = _jax_ops()
    c1 = mk(0x87C37B91114253D5)
    c2 = mk(0x4CF5AD432745937F)
    f1 = mk(0xFF51AFD7ED558CCD)
    f2 = mk(0xC4CEB9FE1A85EC53)
    m5 = mk(5)
    n1 = mk(0x52DCE729)
    n2 = mk(0x38495AB5)

    data = jnp.asarray(data, dtype=jnp.uint32)
    if data.ndim == 1:
        data = data[None, :]
    n, length = data.shape

    def le64(cols):
        lo = jnp.zeros((n,), dtype=jnp.uint32)
        hi = jnp.zeros((n,), dtype=jnp.uint32)
        for i in range(4):
            if cols + i < length:
                lo = lo | (data[:, cols + i] << jnp.uint32(8 * i))
        for i in range(4):
            if cols + 4 + i < length:
                hi = hi | (data[:, cols + 4 + i] << jnp.uint32(8 * i))
        return (hi, lo)

    def fmix(k):
        k = xor64(k, shr64(k, 33))
        k = mul64(k, f1)
        k = xor64(k, shr64(k, 33))
        k = mul64(k, f2)
        k = xor64(k, shr64(k, 33))
        return k

    zero = (jnp.zeros((n,), jnp.uint32), jnp.zeros((n,), jnp.uint32))
    h1 = add64(zero, mk(seed))
    h1 = (jnp.broadcast_to(h1[0], (n,)), jnp.broadcast_to(h1[1], (n,)))
    h2 = h1

    nblocks = length // 16
    for b in range(nblocks):
        k1 = le64(b * 16)
        k2 = le64(b * 16 + 8)
        k1 = mul64(k1, c1)
        k1 = rotl64(k1, 31)
        k1 = mul64(k1, c2)
        h1 = xor64(h1, k1)
        h1 = rotl64(h1, 27)
        h1 = add64(h1, h2)
        h1 = add64(mul64(h1, m5), n1)
        k2 = mul64(k2, c2)
        k2 = rotl64(k2, 33)
        k2 = mul64(k2, c1)
        h2 = xor64(h2, k2)
        h2 = rotl64(h2, 31)
        h2 = add64(h2, h1)
        h2 = add64(mul64(h2, m5), n2)

    ntail = length & 15
    if ntail > 0:
        base = nblocks * 16
        k1 = le64(base)
        if ntail > 8:
            k2 = le64(base + 8)
            # zero out bytes beyond ntail handled by le64 bounds check
            k2 = mul64(k2, c2)
            k2 = rotl64(k2, 33)
            k2 = mul64(k2, c1)
            h2 = xor64(h2, k2)
        # mask k1 to min(ntail, 8) bytes: le64 already bounds-checks columns,
        # but when ntail < 8 we must not include later columns -- rebuild:
        if ntail < 8:
            lo = jnp.zeros((n,), dtype=jnp.uint32)
            hi = jnp.zeros((n,), dtype=jnp.uint32)
            for i in range(min(ntail, 4)):
                lo = lo | (data[:, base + i] << jnp.uint32(8 * i))
            for i in range(max(0, ntail - 4)):
                hi = hi | (data[:, base + 4 + i] << jnp.uint32(8 * i))
            k1 = (hi, lo)
        k1 = mul64(k1, c1)
        k1 = rotl64(k1, 31)
        k1 = mul64(k1, c2)
        h1 = xor64(h1, k1)

    ln = mk(length)
    h1 = xor64(h1, ln)
    h2 = xor64(h2, ln)
    h1 = add64(h1, h2)
    h2 = add64(h2, h1)
    h1 = fmix(h1)
    h2 = fmix(h2)
    h1 = add64(h1, h2)
    return h1
