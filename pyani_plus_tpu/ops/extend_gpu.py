"""Batched banded free-end extensions on the GPU (ANIm and dnadiff).

The outward extensions from terminal anchors (nucmer postnuc's
Extend_Alignment stage; host kernel native/band.cpp, numpy oracle
ops/extend.py::_band_dp with ``free_end=True``) are thousands of
independent banded affine-gap DPs per genome pair, each a sequential
loop of up to ~10^4 rows over a 121-cell band. native/band_extend.cu
runs one task per warp with the whole band state in registers; this
module packs the tasks, calls the kernel through the XLA FFI and
unpacks the results. The result contract is extend_errors' exactly.

Dispatch rules:

- tasks are sorted longest first into one launch, so the warps with
  the longest row loops start first;
- the task count and the byte buffers are padded to powers of two,
  which bounds the number of shapes XLA compiles the call for;
- a task with more than ``MAX_ROWS`` rows (packed-key headroom in the
  kernel), an empty tail, or both tails shorter than the band runs on
  the host kernel in its task position;
- results come back in the caller's task order.

The executor is the launch itself: :func:`gpu_executor` on the card,
:func:`host_executor` (the host kernel over the same packed buffers)
wherever a test passes it explicitly.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable

import numpy as np

from pyani_plus_tpu.ops.extend import EXTEND, MATCH, MISMATCH, OPEN, extend_errors

BAND = 60  # extend_errors' band; the kernel's 128-column layout fixes it
# 2 * rows + 127 < 32768 and 3 * rows * 32768 < 2^31 (band_extend.cu)
MAX_ROWS = 16256
MAX_TASKS_PER_CALL = 1 << 16  # keeps every byte offset inside int32
KERNEL = "band_extend"  # devmeter name of the dispatch
_TARGET = "pyani_band_extend"

# (meta int32[T, 4], a uint8[A], b uint8[B], stop_rows) -> int32[T, 6]
Executor = Callable[[np.ndarray, np.ndarray, np.ndarray, int], np.ndarray]


def _pow2(x: int, floor: int) -> int:
    return max(floor, 1 << (max(1, x) - 1).bit_length())


def pack(
    tasks: list[tuple[np.ndarray, np.ndarray]],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate tasks into the kernel's padded (meta, a, b) buffers.

    ``meta[t] = (a_offset, m, b_offset, n)``; padding tasks have m = n = 0
    and finish at row 0."""
    a_len = sum(a.size for a, _b in tasks)
    b_len = sum(b.size for _a, b in tasks)
    meta = np.zeros((_pow2(len(tasks), 32), 4), np.int32)
    a_flat = np.full(_pow2(a_len, 1024), 255, np.uint8)
    b_flat = np.full(_pow2(b_len, 1024), 255, np.uint8)
    a_off = b_off = 0
    for t, (a, b) in enumerate(tasks):
        meta[t] = (a_off, a.size, b_off, b.size)
        a_flat[a_off : a_off + a.size] = a
        b_flat[b_off : b_off + b.size] = b
        a_off += a.size
        b_off += b.size
    return meta, a_flat, b_flat


def host_executor(
    meta: np.ndarray, a: np.ndarray, b: np.ndarray, stop_rows: int
) -> np.ndarray:
    """The host kernel over the packed buffers (the GPU launch's stand-in
    where there is no card)."""
    from pyani_plus_tpu.native import band_dp_native

    out = np.zeros((meta.shape[0], 6), np.int32)
    for t, (a_off, m, b_off, n) in enumerate(meta.tolist()):
        if m:
            out[t] = band_dp_native(
                a[a_off : a_off + m], b[b_off : b_off + n], BAND, True,
                MATCH, MISMATCH, OPEN, EXTEND, stop_rows,
            )
    return out


_LOCK = threading.Lock()
_CALLS: dict[int, Callable] = {}


def _register() -> None:
    import jax

    from pyani_plus_tpu.native import BAND_EXTEND_CU, build_cuda

    so = build_cuda(BAND_EXTEND_CU, (jax.ffi.include_dir(),))
    lib = ctypes.cdll.LoadLibrary(str(so))
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.PyaniBandExtend), platform="CUDA"
    )


def _call(stop_rows: int) -> Callable:
    """Jitted FFI launch for one give-up setting (build + register once)."""
    with _LOCK:
        fn = _CALLS.get(stop_rows)
        if fn is not None:
            return fn
        import jax
        import jax.numpy as jnp

        if not _CALLS:
            _register()

        def run(meta, a, b):
            return jax.ffi.ffi_call(
                _TARGET, jax.ShapeDtypeStruct((meta.shape[0], 6), jnp.int32)
            )(
                meta, a, b,
                stop_rows=np.int32(stop_rows),
                match=np.int32(MATCH),
                mismatch=np.int32(MISMATCH),
                gap_open=np.int32(OPEN),
                gap_extend=np.int32(EXTEND),
            )

        fn = jax.jit(run)
        _CALLS[stop_rows] = fn
        return fn


def gpu_executor(
    meta: np.ndarray, a: np.ndarray, b: np.ndarray, stop_rows: int
) -> np.ndarray:
    """One launch of native/band_extend.cu (built on first use)."""
    return np.asarray(_call(stop_rows)(meta, a, b))


def batch_extend(
    tasks: list[tuple[np.ndarray, np.ndarray]],
    *,
    stop_rows: int = 600,
    executor: Executor | None = None,
) -> list[tuple[int, int, int, int, int]]:
    """Free-end extensions of pre-trimmed (a, b) tails.

    Per task (a_advance, b_advance, errors, nonid, gap_columns), exactly
    extend_errors' result with ``breaklen = stop_rows // 3``."""
    from pyani_plus_tpu.utils import devmeter

    run = gpu_executor if executor is None else executor
    results: list[tuple[int, int, int, int, int] | None] = [None] * len(tasks)
    device: list[int] = []
    for t, (a, b) in enumerate(tasks):
        if a.size and b.size and a.size <= MAX_ROWS and max(a.size, b.size) >= BAND:
            device.append(t)
        else:
            results[t] = extend_errors(a, b, breaklen=max(1, stop_rows // 3))
    device.sort(key=lambda t: tasks[t][0].size, reverse=True)
    for lo in range(0, len(device), MAX_TASKS_PER_CALL):
        group = device[lo : lo + MAX_TASKS_PER_CALL]
        t_submit = devmeter.now()
        out = run(*pack([tasks[t] for t in group]), stop_rows)
        devmeter.record(t_submit, kernel=KERNEL)
        for pos, t in enumerate(group):
            bi, bj, _score, err, nid, gap = (int(v) for v in out[pos])
            results[t] = (bi, bj, err, nid, gap)
    return results  # type: ignore[return-value]
