// Banded free-end extensions for ANIm/dnadiff on an NVIDIA Hopper GPU.
//
// One warp owns one extension task for its whole life. The 121 live band
// columns (2 * BAND + 1) are padded to 128 and held as 4 consecutive
// cells per lane, so every DP state -- M, D and I, each as (score,
// errors, nonid, gapcols) -- and the per-column best-cell records stay in
// registers while the warp walks the rows. A row costs a few in-lane
// moves, one shuffle for the vertical predecessor, a 5-step shuffle scan
// for the horizontal-run closure and one warp max for the give-up rule.
//
// Contract: bit-identical to native/band.cpp::band_affine(free_end=1)
// and ops/extend.py::_band_dp, tie rules included:
//   - M predecessor best3 prefers M >= D >= I (strict-greater takeovers);
//   - D prefers gap continuation on ties;
//   - I sources the LATEST running-max base (the scan's right operand
//     wins ties);
//   - the best cell updates on a strictly greater score, or an equal
//     score with larger i + j;
//   - the give-up rule (stop_rows rows without improvement) ends the
//     task exactly where the host row loop breaks.
//
// Best-cell tracking is deferred: each column keeps the running max of
// the packed key cs * 32768 + (2i + k), which orders cells by score and
// then by i + j (j = k + i - BAND). Keys fit int32 while 2 * rows + 127 <
// 32768 and 3 * rows * 32768 < 2^31; the Python wrapper sends longer
// tasks to the host kernel (ops/extend_gpu.py MAX_ROWS).
//
// Inputs (XLA FFI, one launch per call):
//   meta  int32[T, 4]  (a_offset, m, b_offset, n) per task
//   a     uint8[A]     all a tails, concatenated
//   b     uint8[B]     all b tails, concatenated
// Output:
//   out   int32[T, 6]  (best_i, best_j, best_score, errors, nonid, gapcols)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> band_extend.cu
// (ops/extend_gpu.py builds it on first use).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int BAND = 60;
constexpr int WIDTH = 2 * BAND + 1;
constexpr int CELLS = 4;  // band cells per lane: 32 lanes x 4 = 128 columns
constexpr int NEG = -1000000000;
constexpr int HALF_NEG = NEG / 2;
constexpr int WARPS_PER_BLOCK = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int PAD = 255;  // code that never matches

struct Run {
  int key;  // running max of base + open - extend * (k + 1)
  int e;    // errors at the source minus its column
  int n;    // nonid - errors at the source
  int g;    // gapcols - errors at the source
};

// Right operand wins ties: the horizontal run starts at the LATEST base.
__device__ __forceinline__ Run combine(const Run &left, const Run &right) {
  return left.key > right.key ? left : right;
}

__device__ __forceinline__ Run shfl_up(const Run &x, int delta) {
  Run out;
  out.key = __shfl_up_sync(FULL, x.key, delta);
  out.e = __shfl_up_sync(FULL, x.e, delta);
  out.n = __shfl_up_sync(FULL, x.n, delta);
  out.g = __shfl_up_sync(FULL, x.g, delta);
  return out;
}

__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
    band_extend_kernel(const int32_t *__restrict__ meta,
                       const uint8_t *__restrict__ a_all,
                       const uint8_t *__restrict__ b_all,
                       int32_t *__restrict__ out, int64_t tasks, int stop_rows,
                       int match, int mismatch, int gap_open, int gap_extend) {
  const int64_t task =
      (int64_t)blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= tasks) return;  // warp-uniform
  const int a_off = meta[4 * task];
  const int m = meta[4 * task + 1];
  const int b_off = meta[4 * task + 2];
  const int n = meta[4 * task + 3];
  const uint8_t *a = a_all + a_off;
  const uint8_t *b = b_all + b_off;

  int Ms[CELLS], Me[CELLS], Mn[CELLS], Mg[CELLS];
  int Ds[CELLS], De[CELLS], Dn[CELLS], Dg[CELLS];
  int Is[CELLS], Ie[CELLS], In[CELLS], Ig[CELLS];
  int colkey[CELLS], coli[CELLS], cole[CELLS], coln[CELLS], colg[CELLS];
  int bwin[CELLS];  // b[j - 1] of each cell for the current row

  // --- row 0: origin in M at j == 0; I holds the horizontal runs.
  int best_key = -1;
#pragma unroll
  for (int c = 0; c < CELLS; c++) {
    const int k = CELLS * lane + c;
    const int j = k - BAND;
    const bool col_ok = k < WIDTH;
    Ms[c] = (col_ok && j == 0) ? 0 : NEG;
    Me[c] = Mn[c] = Mg[c] = 0;
    Ds[c] = NEG;
    De[c] = Dn[c] = Dg[c] = 0;
    const bool i_ok = col_ok && j >= 1 && j <= n;
    Is[c] = i_ok ? gap_open + gap_extend * (j - 1) : NEG;
    Ie[c] = In[c] = Ig[c] = i_ok ? j : 0;
    const int cs = Ms[c] >= Is[c] ? Ms[c] : Is[c];
    const int ce = Ms[c] >= Is[c] ? 0 : Ie[c];
    colkey[c] = cs >= 0 ? cs * 32768 + k : -1;
    coli[c] = 0;
    cole[c] = coln[c] = colg[c] = cs >= 0 ? ce : 0;  // row 0: e == n == g
    best_key = max(best_key, colkey[c]);
    // row 1 reads b[k - BAND]
    const int idx = k - BAND;
    bwin[c] = (idx >= 0 && idx < n) ? b[idx] : PAD;
  }
  best_key = __reduce_max_sync(FULL, best_key);

  int rows_since = 0;
  int a_reg = PAD;
  for (int i = 1; i <= m; i++) {
    if (((i - 1) & 31) == 0) {
      const int idx = i - 1 + lane;
      a_reg = idx < m ? a[idx] : PAD;
    }
    const int ac = __shfl_sync(FULL, a_reg, (i - 1) & 31);

    // D source at each column of the previous row: what the cell one
    // column to the left gets in this row (open from max(M, I), tie M;
    // continue from D, tie continue).
    int ss[CELLS], se[CELLS], sn[CELLS], sg[CELLS];
#pragma unroll
    for (int c = 0; c < CELLS; c++) {
      int os = Ms[c], oe = Me[c], on = Mn[c], og = Mg[c];
      if (Is[c] > os) {
        os = Is[c];
        oe = Ie[c];
        on = In[c];
        og = Ig[c];
      }
      const int open_s = os > HALF_NEG ? os + gap_open : NEG;
      const int cont_s = Ds[c] > HALF_NEG ? Ds[c] + gap_extend : NEG;
      const bool take_cont = cont_s >= open_s;
      ss[c] = take_cont ? cont_s : open_s;
      se[c] = (take_cont ? De[c] : oe) + 1;
      sn[c] = (take_cont ? Dn[c] : on) + 1;
      sg[c] = (take_cont ? Dg[c] : og) + 1;
    }
    // column k + 1 of the previous row: in-lane, or lane + 1's cell 0
    int up_s[CELLS], up_e[CELLS], up_n[CELLS], up_g[CELLS];
#pragma unroll
    for (int c = 0; c < CELLS - 1; c++) {
      up_s[c] = ss[c + 1];
      up_e[c] = se[c + 1];
      up_n[c] = sn[c + 1];
      up_g[c] = sg[c + 1];
    }
    {
      const int s = __shfl_down_sync(FULL, ss[0], 1);
      const int e = __shfl_down_sync(FULL, se[0], 1);
      const int nn = __shfl_down_sync(FULL, sn[0], 1);
      const int g = __shfl_down_sync(FULL, sg[0], 1);
      const bool edge = lane == 31;
      up_s[CELLS - 1] = edge ? NEG : s;
      up_e[CELLS - 1] = edge ? 0 : e;
      up_n[CELLS - 1] = edge ? 0 : nn;
      up_g[CELLS - 1] = edge ? 0 : g;
    }

    Run x[CELLS];
    bool valid[CELLS], in_b[CELLS];
#pragma unroll
    for (int c = 0; c < CELLS; c++) {
      const int k = CELLS * lane + c;
      const int j = k + i - BAND;
      valid[c] = k < WIDTH && j >= 0 && j <= n;
      in_b[c] = valid[c] && j >= 1;
      // --- M: diagonal predecessor (same column), best3 M >= D >= I
      int ps = Ms[c], pe = Me[c], pn = Mn[c], pg = Mg[c];
      if (Ds[c] > ps) {
        ps = Ds[c];
        pe = De[c];
        pn = Dn[c];
        pg = Dg[c];
      }
      if (Is[c] > ps) {
        ps = Is[c];
        pe = Ie[c];
        pn = In[c];
        pg = Ig[c];
      }
      const int bc = bwin[c];
      const bool sub_ok = bc == ac && ac < 4 && bc < 4;
      const bool live_m = in_b[c] && ps > HALF_NEG;
      Ms[c] = live_m ? ps + (sub_ok ? match : mismatch) : NEG;
      Me[c] = live_m ? pe + (sub_ok ? 0 : 1) : 0;
      Mn[c] = live_m ? pn + (bc == ac ? 0 : 1) : 0;
      Mg[c] = live_m ? pg : 0;
      // --- D: vertical predecessor from column k + 1
      const bool dead_d = !valid[c] || up_s[c] <= HALF_NEG;
      Ds[c] = dead_d ? NEG : up_s[c];
      De[c] = dead_d ? 0 : up_e[c];
      Dn[c] = dead_d ? 0 : up_n[c];
      Dg[c] = dead_d ? 0 : up_g[c];
      // --- horizontal-run keys from base = max(M, D), tie M
      const bool base_m = Ms[c] >= Ds[c];
      const int bs = base_m ? Ms[c] : Ds[c];
      const int be = base_m ? Me[c] : De[c];
      const int bn = base_m ? Mn[c] : Dn[c];
      const int bg = base_m ? Mg[c] : Dg[c];
      x[c].key =
          bs > HALF_NEG ? bs + gap_open - gap_extend * (k + 1) : NEG;
      x[c].e = be - k;
      x[c].n = bn - be;
      x[c].g = bg - be;
    }

    // --- I: exclusive prefix (latest source) over the row's run keys.
    // In-lane inclusive scan, warp inclusive scan of the lane totals,
    // then each cell's exclusive prefix.
    Run incl[CELLS];
    incl[0] = x[0];
#pragma unroll
    for (int c = 1; c < CELLS; c++) incl[c] = combine(incl[c - 1], x[c]);
    Run total = incl[CELLS - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Run left = shfl_up(total, d);
      if (lane >= d) total = combine(left, total);
    }
    Run before = shfl_up(total, 1);
    if (lane == 0) before = Run{NEG, 0, 0, 0};

    int row_key = -1;
#pragma unroll
    for (int c = 0; c < CELLS; c++) {
      const int k = CELLS * lane + c;
      const Run left = c == 0 ? before : combine(before, incl[c - 1]);
      const bool ok_i = in_b[c] && left.key > HALF_NEG;
      const int e_full = left.e + k;
      Is[c] = ok_i ? left.key + gap_extend * k : NEG;
      Ie[c] = ok_i ? e_full : 0;
      In[c] = ok_i ? e_full + left.n : 0;
      Ig[c] = ok_i ? e_full + left.g : 0;

      // --- best cell of this column, cell best3 M >= D >= I
      int cs = Ms[c], ce = Me[c], cn = Mn[c], cg = Mg[c];
      if (Ds[c] > cs) {
        cs = Ds[c];
        ce = De[c];
        cn = Dn[c];
        cg = Dg[c];
      }
      if (Is[c] > cs) {
        cs = Is[c];
        ce = Ie[c];
        cn = In[c];
        cg = Ig[c];
      }
      const int key = cs >= 0 ? cs * 32768 + (2 * i + k) : -1;
      if (key > colkey[c]) {  // keys never tie within a column
        colkey[c] = key;
        coli[c] = i;
        cole[c] = ce;
        coln[c] = cn;
        colg[c] = cg;
      }
      row_key = max(row_key, key);
    }
    row_key = __reduce_max_sync(FULL, row_key);
    if (row_key > best_key) {
      best_key = row_key;
      rows_since = 0;
    } else if (stop_rows > 0 && ++rows_since >= stop_rows) {
      break;  // warp-uniform: every lane saw the same row_key
    }

    // slide the b window one column left for the next row
    const int next = __shfl_down_sync(FULL, bwin[0], 1);
#pragma unroll
    for (int c = 0; c < CELLS - 1; c++) bwin[c] = bwin[c + 1];
    if (lane == 31) {
      const int idx = CELLS * 32 - 1 + (i + 1) - BAND - 1;
      bwin[CELLS - 1] = (idx >= 0 && idx < n) ? b[idx] : PAD;
    } else {
      bwin[CELLS - 1] = next;
    }
  }

  // Global winner: the max packed key; among key ties the largest column
  // (a tie across columns means the larger-k cell sits on an earlier row,
  // which the host's strictly-greater update keeps).
  int gkey = -1;
#pragma unroll
  for (int c = 0; c < CELLS; c++) gkey = max(gkey, colkey[c]);
  gkey = __reduce_max_sync(FULL, gkey);
  int k_mine = -1;
#pragma unroll
  for (int c = 0; c < CELLS; c++)
    if (colkey[c] == gkey) k_mine = CELLS * lane + c;
  const int k_sel = __reduce_max_sync(FULL, k_mine);
  if (k_sel >= 0 && k_sel / CELLS == lane) {
    const int c = k_sel % CELLS;
    int32_t *o = out + 6 * task;
    o[0] = coli[c];
    o[1] = coli[c] + k_sel - BAND;
    o[2] = gkey >> 15;
    o[3] = cole[c];
    o[4] = coln[c];
    o[5] = colg[c];
  }
}

ffi::Error BandExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> meta,
                          ffi::Buffer<ffi::U8> a, ffi::Buffer<ffi::U8> b,
                          ffi::ResultBuffer<ffi::S32> out, int32_t stop_rows,
                          int32_t match, int32_t mismatch, int32_t gap_open,
                          int32_t gap_extend) {
  const auto dims = meta.dimensions();
  if (dims.size() != 2 || dims[1] != 4) {
    return ffi::Error::InvalidArgument("band_extend: meta must be (T, 4)");
  }
  const int64_t tasks = dims[0];
  if (tasks == 0) return ffi::Error::Success();
  const int64_t blocks = (tasks + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  band_extend_kernel<<<(unsigned)blocks, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      meta.typed_data(), a.typed_data(), b.typed_data(), out->typed_data(),
      tasks, stop_rows, match, mismatch, gap_open, gap_extend);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("band_extend launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PyaniBandExtend, BandExtendImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("stop_rows")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend"));
