"""Device-dispatch meter: occupancy intervals and dispatch counts.

This meter records, per device dispatch, the [submit, result-observed]
interval; ``busy_fraction`` then reports the fraction of a wall-clock
window in which at least one dispatch was in flight (interval union /
window). ``dispatches`` counts the dispatches of each named device
kernel, so a run can prove that its device route actually ran.

"Observed" is when the host materialises the result (np.asarray), so
the metric is an upper bound on true device busyness -- honest for the
question asked (is the chip ever waited on, or is the host the
bottleneck?). Overhead is two timestamps + a lock per dispatch.

Enabled by default (cost is negligible); ``reset()`` starts a window.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque

_LOCK = threading.Lock()
# Bounded: record() runs on every production dispatch but only bench
# windows ever read the buffer -- without a cap a multi-day all-vs-all
# run would grow it without limit. 65536 intervals cover any bench
# window by orders of magnitude; older entries simply fall off.
_INTERVALS: deque[tuple[float, float]] = deque(maxlen=65536)
_COUNTS: Counter[str] = Counter()


def reset() -> float:
    """Clear recorded intervals; returns the window start timestamp."""
    with _LOCK:
        _INTERVALS.clear()
    return time.monotonic()


def record(
    start: float, end: float | None = None, *, kernel: str | None = None
) -> None:
    """Record one dispatch's [submit, observed] interval (and count it
    under ``kernel``)."""
    if end is None:
        end = time.monotonic()
    with _LOCK:
        _INTERVALS.append((start, end))
        if kernel is not None:
            _COUNTS[kernel] += 1


def dispatches(kernel: str) -> int:
    """Dispatches of ``kernel`` recorded since the process started."""
    with _LOCK:
        return _COUNTS[kernel]


def now() -> float:
    return time.monotonic()


def busy_fraction(window_start: float, window_end: float | None = None) -> float:
    """Union length of recorded intervals clipped to the window / window."""
    if window_end is None:
        window_end = time.monotonic()
    span = window_end - window_start
    if span <= 0:
        return 0.0
    with _LOCK:
        ivs = sorted(
            (max(s, window_start), min(e, window_end))
            for s, e in _INTERVALS
            if e > window_start and s < window_end
        )
    busy = 0.0
    cur_s = cur_e = None
    for s, e in ivs:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return min(1.0, busy / span)
