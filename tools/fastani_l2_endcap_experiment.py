"""Round-4 fastANI L2-slide experiment: superwindow end-cap (NEGATIVE).

Hypothesis: MashMap's computeL2MappedRegions loops while the
superwindow-end iterator has not reached the last indexed minimizer, so
window anchors t with t + Q.len past the sequence's LAST index entry
are never evaluated -- predicting the MIBY01000011 self anomaly (last
full fragment ends 1 bp from the contig end; fixture prints 99.9953)
while bacterial selves (large len-mod-3000 remainders) stay exactly 100.

Measured result (this script): capping anchors at
last_entry_first_step - Q.len makes the last MIBY fragment map at an
anchor ~100 steps earlier, which lands it in the PREVIOUS fragment's
reference bin; the cgi bin dedup then drops it -> 5/6 retained at
100.0000. The fixture requires 6/6 retained with one fragment at
reduced J (~99.97), so the end-cap mechanism is REFUTED alongside the
round-3 sweeps (entry-anchored-only, point-membership variants,
freqThreshold masking). The anomaly needs a window at wpos >= 15000
whose membership loses ~2-3 sketch hashes -- which no run- or
point-membership reading of the index reproduces; fastANI's binary or
source remains the only oracle that can pin it.

Run: JAX_PLATFORMS=cpu python tools/fastani_l2_endcap_experiment.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import numpy as np

from pyani_plus_tpu.genomes import decode_sequence, load_genome
from pyani_plus_tpu.methods import fastani as fa
from pyani_plus_tpu.ops import fastani_map as fm
from pyani_plus_tpu.ops.fastani_map import RefIndex


def search_with_cap(query_hashes, ref, w_steps, s, frag_span, min_anchor):
    """_search_mappings_numpy with the superwindow end-cap applied."""
    lo = np.searchsorted(ref.hashes_sorted, query_hashes, side="left")
    hi = np.searchsorted(ref.hashes_sorted, query_hashes, side="right")
    counts = hi - lo
    nz = counts > 0
    if not nz.any():
        return 0, -1, -1
    entry_idx = ref.sorted_entry[
        np.concatenate(
            [np.arange(c) + start for c, start in zip(counts[nz], lo[nz])]
        )
    ]
    hit_seq = ref.seq_ids[entry_idx]
    hit_t = ref.first_steps[entry_idx]
    order = np.lexsort((hit_t, hit_seq))
    hit_seq, hit_t = hit_seq[order], hit_t[order]
    best = (0, -1, -1)
    for sid in np.unique(hit_seq):
        t_hits = hit_t[hit_seq == sid]
        starts = np.maximum(t_hits - frag_span + 1, min_anchor)
        ends = np.maximum(t_hits, starts)
        regions = []
        for a, b in zip(starts, ends):
            a, b = int(a), int(b)
            if regions and a <= regions[-1][1]:
                regions[-1] = (regions[-1][0], max(regions[-1][1], b))
            else:
                regions.append((a, b))
        b_lo, b_hi = ref.seq_bounds[int(sid)]
        seq_hash = ref.hashes[b_lo:b_hi]
        seq_first = ref.first_steps[b_lo:b_hi]
        seq_last = ref.last_steps[b_lo:b_hi]
        cap = int(seq_first[-1]) - frag_span  # THE EXPERIMENT
        for a, b in regions:
            if a > cap:
                continue
            b = min(b, cap)
            run_mask = (seq_last >= a) & (seq_first <= b + w_steps - 1)
            if not run_mask.any():
                continue
            e_hash = seq_hash[run_mask]
            e_first = seq_first[run_mask]
            e_last = seq_last[run_mask]
            events = np.unique(
                np.clip(
                    np.concatenate([e_first - w_steps + 1, e_last + 1, [a]]),
                    a,
                    b,
                )
            )
            shared, _t, t_end = fm._evaluate_region(
                query_hashes, e_hash, e_first, e_last, events, w_steps, s, b
            )
            if shared > best[0]:
                best = (shared, t_end, int(sid))
    return best


def main() -> None:
    g = load_genome("/root/reference/tests/fixtures/MIBY01000011.fasta")
    idx = RefIndex.build([decode_sequence(r.codes) for r in g.records], 16, 24)
    print("default:", fa.compute_pair(g, idx, g.length, 3000, 16, 0.2))
    original = fm._search_mappings_numpy

    def patched(qh, ref, w_steps, s, frag_span, min_anchor):
        return search_with_cap(qh, ref, w_steps, s, frag_span, min_anchor)

    fm._search_mappings_numpy = patched
    # bypass the native path so the patched numpy search runs
    import pyani_plus_tpu.native as native

    native_fn = native.fastani_map_fragment_native
    native.fastani_map_fragment_native = lambda *a, **k: None
    try:
        print("end-cap:", fa.compute_pair(g, idx, g.length, 3000, 16, 0.2))
    finally:
        fm._search_mappings_numpy = original
        native.fastani_map_fragment_native = native_fn
    print("fixture: (99.9953, 6, 6)  -> end-cap drops to 5/6: REFUTED")


if __name__ == "__main__":
    main()
