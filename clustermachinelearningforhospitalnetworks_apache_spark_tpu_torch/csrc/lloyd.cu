// Lloyd-step kernels for Hopper (sm_90a): K1 fused Lloyd statistics and K2
// fused assignment.
//
// Replaces, in the JAX package:
//   K1  ops/pallas_kernels.py::fused_lloyd_stats (body _lloyd_kernel,
//       pallas_call in _lloyd_call)
//   K2  ops/pallas_kernels.py::fused_assign (body _assign_kernel,
//       pallas_call in _assign_call)
//
// What they compute (the same functions as the TPU kernels, not their block
// walk):
//   d2[r, c] = max(|x_r|^2 - 2 x_r.c_c + |c_c|^2, 0), 1e30 where c_valid[c] <= 0
//   K2: assign[r] = argmin_c d2[r, c] (first index on ties), min_d2[r]
//   K1: sums[c] = sum_{r: assign[r]=c} w_r x_r, counts[c] = sum w_r,
//       cost = sum_r w_r min_d2[r]
//
// What bounds them on an H100: at k=256, d=8 one row costs k(2d+3) ~ 4.9k f32
// operations against (d+1)*4 = 36 bytes read, about 135 operations per byte,
// so both kernels are bound by the CUDA cores' f32 rate (67 TFLOP/s), not by
// HBM (3.35 TB/s), until the cross term moves onto the tensor cores.
//
// Design:
//   * One thread scores one row against every center (K2: R rows, below); a
//     block walks row tiles in a grid-stride loop over an occupancy-sized
//     grid.
//   * Centers, |c|^2 and c_valid live in shared memory with rows padded to
//     DP (a multiple of 4) so the inner product reads float4 broadcasts.  When
//     all k centers do not fit in the 48 KB budget they are tiled through it;
//     the running min/argmin is carried from one tile to the next.
//   * The TPU kernel accumulated into one output block across a sequential
//     grid.  Here blocks run in parallel, so each block writes one partial
//     (sums, counts, cost) and a second kernel reduces the partials in block
//     order, in float64.  No atomics: a run is bit-for-bit repeatable on
//     one card.
//   * K1's accumulation uses every thread on work proportional to the rows,
//     not to k x rows.  After a tile's argmin the block sorts the keys
//     (cluster, row) of its kThreads rows (a bitonic network: shuffles
//     below a warp, shared memory above), so each cluster's rows form one
//     segment in row order; rows past n or of weight 0 sort last and add
//     nothing.  The work items are the pairs (segment, feature) plus one
//     count slot per segment, taken by the threads in a fixed stride with
//     lanes on consecutive features, so reads of x and of the accumulators
//     coalesce.  Item (c, j) loads acc[c][j] once, runs fmaf(w_r, x_rj, a)
//     over the segment's rows in row order and stores it back: each
//     (cluster, feature) of a block is one fmaf chain in row order from the
//     block's running value, as an owner thread per cluster computes it.
//   * The accumulators sit in shared memory when k*(d+1) floats fit beside
//     the distance loop's buffers under the opt-in limit, else in the
//     block's own partial (touched once per (segment, feature) per tile).
//     The plan (center tile, accumulators' home, shared bytes, grid) comes
//     from ops/lloyd.py::lloyd_plan; this file checks that the shared bytes
//     agree with it.  At d=64, k=1024 the partial buffer is blocks x 66,561
//     floats (266 KB a block); the plan keeps all partials under 256 MB.
//   * Rows past n are masked inside the kernel; n == 0 is handled by the
//     caller (nothing to launch).
//
// K2's distance loop.  The bound counts k(2d+3) = 19 f32 operations a (row,
// center) pair at d=8, 9.5 FFMA slots; the loop is bound by the instructions
// it dispatches.  One row a thread (scan_centers) dispatches about 23 a pair
// (sm_90a SASS at DP = 8: 8 FFMAs; three FADDs and an FMNMX for the d2
// epilogue; the compare and two selects; and, once a center, its shared
// loads, the branch on c_valid and the loop), at about 1.3 scheduler cycles
// an instruction on an H100.  So K2 gives a thread R rows
// (assign_kernel<DP, R>, scan_centers_rows): a block tile is kThreads * R
// rows, row r of thread t being base + r * kThreads + t so that loads and
// stores stay coalesced, and each staged center is read from shared memory,
// tested and looped over once for the R rows: about 19 instructions a pair
// at R = 4.  Each row's d2 is scan_centers' expression, the same fmaf chain
// in the same order, and its centers are walked in the same ascending order,
// so K2's output is bit-for-bit that of one row a thread at every input.  R
// by padded width (assign_rows_max, mirrored in ops/lloyd.py): the most rows
// that ptxas keeps in registers without spills at two blocks an SM
// (__launch_bounds__(kThreads, 2)): 4 up to DP = 16 (80 registers at DP = 8,
// 121 at 16), 2 at DP = 32 (127), 1 from DP = 64 (R = 2 there takes 173
// registers, one block an SM).  ops/lloyd.py::assign_plan takes R > 1 only
// when the launch still has a tile of kThreads * R rows for every SM, so a
// small request keeps R = 1, the one-row-a-thread loop.  K1 keeps
// scan_centers: its accumulation sorts the tile's rows one a thread.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;           // rows per tile == threads per block
constexpr int kRowBits = 8;             // kThreads == 1 << kRowBits
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemBudget = 48 * 1024;  // the center tile's budget
constexpr float kBig = 1e30f;
// K1 sort keys are (cluster << kRowBits | row) with cluster k for rows that
// add nothing, so k stays below 2^(32 - kRowBits).
constexpr int kMaxCenters = (1 << (32 - kRowBits)) - 1;
// K1's words after the centers: sorted keys, weights, the cost reduce,
// segment heads (kThreads + 1) and per-warp segment and row counts.
constexpr int kStatsWords = 4 * kThreads + 1 + 2 * kWarps;

struct Geometry {
  int dp;          // padded feature width (4, 8, 16, 32, 64 or 128)
  int kt;          // centers per shared-memory tile (== k when resident)
  size_t smem;     // dynamic shared memory bytes
};

int padded_width(int d) {
  if (d <= 4) return 4;
  if (d <= 8) return 8;
  if (d <= 16) return 16;
  if (d <= 32) return 32;
  if (d <= 64) return 64;
  if (d <= 128) return 128;
  return -1;
}

// K2's shared-memory plan for one (d, k) shape: all centers, or tiles of
// them, in the 48 KB budget.
bool plan(int d, int k, Geometry* g) {
  g->dp = padded_width(d);
  if (g->dp < 0 || k < 1) return false;
  const size_t per_center = (size_t)(g->dp + 2) * sizeof(float);
  g->kt = (size_t)k * per_center <= (size_t)kSmemBudget
              ? k
              : (int)(kSmemBudget / per_center) / 32 * 32;
  if (g->kt < 1) return false;
  g->smem = (size_t)g->kt * per_center;
  return true;
}

// K1's dynamic shared memory for a plan (ops/lloyd.py::lloyd_plan).
size_t stats_smem(int dp, int kt, int k, int d, int acc_smem) {
  return ((size_t)kt * (dp + 2) + kStatsWords +
          (acc_smem ? (size_t)k * d + k : 0)) * sizeof(float);
}

// Centers [c0, c0 + kh) into shared memory: rows zero-padded to DP, their
// squared norms, and the validity mask.
template <int DP>
__device__ void load_centers(const float* __restrict__ centers,
                             const float* __restrict__ c_valid, int c0, int kh,
                             int d, float* cs, float* csq, float* cval) {
  for (int i = threadIdx.x; i < kh * DP; i += kThreads) {
    const int c = i / DP, j = i - c * DP;
    cs[i] = j < d ? centers[(long long)(c0 + c) * d + j] : 0.f;
  }
  for (int c = threadIdx.x; c < kh; c += kThreads) {
    const float* row = centers + (long long)(c0 + c) * d;
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(row[j], row[j], s);
    csq[c] = s;
    cval[c] = c_valid[c0 + c];
  }
}

template <int DP>
__device__ __forceinline__ void load_row(const float* __restrict__ x,
                                         long long row, int d, bool valid,
                                         float (&xr)[DP], float& xsq) {
  xsq = 0.f;
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    xr[j] = (valid && j < d) ? __ldg(x + row * d + j) : 0.f;
    xsq = fmaf(xr[j], xr[j], xsq);
  }
}

// Scores one row against kh staged centers, ascending; strict < keeps the
// first index on ties, as jnp.argmin does.
template <int DP>
__device__ __forceinline__ void scan_centers(const float (&xr)[DP], float xsq,
                                             const float* cs, const float* csq,
                                             const float* cval, int kh, int c0,
                                             float& best, int& arg) {
  const float4* cs4 = reinterpret_cast<const float4*>(cs);
  for (int c = 0; c < kh; ++c) {
    float cross = 0.f;
#pragma unroll
    for (int q = 0; q < DP / 4; ++q) {
      const float4 v = cs4[c * (DP / 4) + q];
      cross = fmaf(xr[4 * q + 0], v.x, cross);
      cross = fmaf(xr[4 * q + 1], v.y, cross);
      cross = fmaf(xr[4 * q + 2], v.z, cross);
      cross = fmaf(xr[4 * q + 3], v.w, cross);
    }
    float d2 = fmaxf(xsq - 2.f * cross + csq[c], 0.f);
    if (!(cval[c] > 0.f)) d2 = kBig;
    if (d2 < best) {
      best = d2;
      arg = c0 + c;
    }
  }
}

// Min/argmin of one row over all k centers: one pass over resident centers,
// or a walk over tiles that every thread of the block joins.
template <int DP>
__device__ __forceinline__ void row_argmin(
    const float (&xr)[DP], float xsq, const float* __restrict__ centers,
    const float* __restrict__ c_valid, int d, int k, int kt, float* cs,
    float* csq, float* cval, float& best, int& arg) {
  best = INFINITY;
  arg = 0;
  if (kt >= k) {
    scan_centers<DP>(xr, xsq, cs, csq, cval, k, 0, best, arg);
    return;
  }
  for (int c0 = 0; c0 < k; c0 += kt) {
    const int kh = min(kt, k - c0);
    __syncthreads();
    load_centers<DP>(centers, c_valid, c0, kh, d, cs, csq, cval);
    __syncthreads();
    scan_centers<DP>(xr, xsq, cs, csq, cval, kh, c0, best, arg);
  }
}

// K2's rows a thread at padded width DP (R_MAX; see the note at the top).
constexpr int assign_rows_max(int dp) { return dp <= 16 ? 4 : dp <= 32 ? 2 : 1; }

// K2: R rows of one thread scored against kh staged centers, ascending.
// Each center's float4s, |c|^2 and c_valid are read from shared memory once
// for the R rows; each row's cross term is scan_centers' fmaf chain (q
// ascending; x, y, z, w) and its d2, validity and compare are scan_centers'
// statements, so row r ends with the best and arg that scan_centers gives
// it alone.
template <int DP, int R>
__device__ __forceinline__ void scan_centers_rows(
    const float (&xr)[R][DP], const float (&xsq)[R], const float* cs,
    const float* csq, const float* cval, int kh, int c0, float (&best)[R],
    int (&arg)[R]) {
  const float4* cs4 = reinterpret_cast<const float4*>(cs);
  for (int c = 0; c < kh; ++c) {
    float cross[R];
#pragma unroll
    for (int r = 0; r < R; ++r) cross[r] = 0.f;
#pragma unroll
    for (int q = 0; q < DP / 4; ++q) {
      const float4 v = cs4[c * (DP / 4) + q];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        cross[r] = fmaf(xr[r][4 * q + 0], v.x, cross[r]);
        cross[r] = fmaf(xr[r][4 * q + 1], v.y, cross[r]);
        cross[r] = fmaf(xr[r][4 * q + 2], v.z, cross[r]);
        cross[r] = fmaf(xr[r][4 * q + 3], v.w, cross[r]);
      }
    }
    const float sq = csq[c];
    const float cv = cval[c];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float d2 = fmaxf(xsq[r] - 2.f * cross[r] + sq, 0.f);
      if (!(cv > 0.f)) d2 = kBig;
      if (d2 < best[r]) {
        best[r] = d2;
        arg[r] = c0 + c;
      }
    }
  }
}

// A block minimum of 2 caps a thread at 128 registers, which the R rows
// of assign_rows_max(DP) fit without spills; R = 1 leaves ptxas its own
// choice, as one row a thread always had.
template <int DP, int R>
__global__ void __launch_bounds__(kThreads, R > 1 ? 2 : 0)
    assign_kernel(const float* __restrict__ x, const float* __restrict__ centers,
                  const float* __restrict__ c_valid, long long n, int d, int k,
                  int kt, int* __restrict__ out_assign,
                  float* __restrict__ out_d2) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* csq = cs + (size_t)kt * DP;
  float* cval = csq + kt;
  if (kt >= k) {
    load_centers<DP>(centers, c_valid, 0, k, d, cs, csq, cval);
    __syncthreads();
  }
  constexpr long long kTile = (long long)kThreads * R;
  for (long long base = (long long)blockIdx.x * kTile; base < n;
       base += (long long)gridDim.x * kTile) {
    float xr[R][DP], xsq[R], best[R];
    int arg[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * kThreads + threadIdx.x;
      load_row<DP>(x, row, d, row < n, xr[r], xsq[r]);
      best[r] = INFINITY;
      arg[r] = 0;
    }
    if (kt >= k) {
      scan_centers_rows<DP, R>(xr, xsq, cs, csq, cval, k, 0, best, arg);
    } else {
      // every thread joins each tile's barriers, rows past n too
      for (int c0 = 0; c0 < k; c0 += kt) {
        const int kh = min(kt, k - c0);
        __syncthreads();
        load_centers<DP>(centers, c_valid, c0, kh, d, cs, csq, cval);
        __syncthreads();
        scan_centers_rows<DP, R>(xr, xsq, cs, csq, cval, kh, c0, best, arg);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = base + r * kThreads + threadIdx.x;
      if (row < n) {
        out_assign[row] = arg[r];
        out_d2[row] = best[r];
      }
    }
  }
}

using AssignKernel = void (*)(const float*, const float*, const float*,
                              long long, int, int, int, int*, float*);

// assign_kernel<DP, rows>, or null for a rows count K2 does not take at DP.
template <int DP>
AssignKernel assign_kernel_for(int rows) {
  if (rows == 1) return assign_kernel<DP, 1>;
  if constexpr (assign_rows_max(DP) >= 2)
    if (rows == 2) return assign_kernel<DP, 2>;
  if constexpr (assign_rows_max(DP) >= 4)
    if (rows == 4) return assign_kernel<DP, 4>;
  return nullptr;
}

// Sorts the block's kThreads keys ascending, one per thread: thread t
// returns the key of rank t.  A bitonic network; strides below a warp go
// through shuffles, wider ones through shared memory, alternating between
// `buf0` and `buf1` (kThreads words each) so that each such stage takes one
// barrier: a buffer is written again only after the next stage's barrier.
// The loops stay rolled: unrolled, the compiler hoists every stage's thread
// masks out of the caller's tile loop, where they spill beside the row.
__device__ __forceinline__ unsigned block_sort(unsigned v, unsigned* buf0,
                                               unsigned* buf1) {
  const int t = threadIdx.x;
  int wide = 0;
#pragma unroll 1
  for (int size = 2; size <= kThreads; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      unsigned o;
      if (stride >= 32) {
        unsigned* buf = (++wide & 1) ? buf0 : buf1;
        buf[t] = v;
        __syncthreads();
        o = buf[t ^ stride];
      } else {
        o = __shfl_xor_sync(kFull, v, stride);
      }
      const bool up = (t & size) == 0;      // this run sorts ascending
      const bool low = (t & stride) == 0;   // this thread holds the pair's lower slot
      v = low == up ? min(v, o) : max(v, o);
    }
  }
  return v;
}

// A block minimum of 0 leaves ptxas its own register choice: at DP <= 8
// 48 registers, five blocks an SM, no spill.  Wider rows spill under that
// choice; with a minimum of one block an SM they take the registers they
// need.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 8 ? 0 : 1)
    lloyd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ centers,
                 const float* __restrict__ c_valid, long long n, int d, int k,
                 int kt, int acc_smem, float* partials) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* csq = cs + (size_t)kt * DP;
  float* cval = csq + kt;
  unsigned* s_key = reinterpret_cast<unsigned*>(cval + kt);
  float* s_w = reinterpret_cast<float*>(s_key + kThreads);
  float* s_red = s_w + kThreads;
  int* s_head = reinterpret_cast<int*>(s_red + kThreads);  // kThreads + 1
  int* s_wseg = s_head + kThreads + 1;                      // kWarps
  int* s_wlive = s_wseg + kWarps;                           // kWarps
  const long long kd = (long long)k * d;
  const long long P = kd + k + 1;
  float* part = partials + (long long)blockIdx.x * P;
  // written and read back by different threads across tiles: no
  // __restrict__, no read-only loads; __syncthreads orders them
  float* acc = acc_smem ? reinterpret_cast<float*>(s_wlive + kWarps) : part;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (long long i = threadIdx.x; i < kd + k; i += kThreads) acc[i] = 0.f;
  if (kt >= k) load_centers<DP>(centers, c_valid, 0, k, d, cs, csq, cval);

  float cost = 0.f;
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    __syncthreads();  // centers staged; the previous tile's items are done
    const long long row = base + threadIdx.x;
    const bool valid = row < n;
    float xr[DP], xsq, best;
    int arg;
    load_row<DP>(x, row, d, valid, xr, xsq);
    row_argmin<DP>(xr, xsq, centers, c_valid, d, k, kt, cs, csq, cval, best,
                   arg);
    const float wr = valid ? w[row] : 0.f;
    if (wr != 0.f) cost = fmaf(best, wr, cost);

    // Group the tile's rows by cluster, stably: sort (cluster, row).
    s_w[threadIdx.x] = wr;
    const unsigned key =
        ((unsigned)(wr != 0.f ? arg : k) << kRowBits) | (unsigned)threadIdx.x;
    const unsigned sk =
        block_sort(key, s_key, reinterpret_cast<unsigned*>(s_red));
    // the sort's last shared stage read s_red: s_key is free
    s_key[threadIdx.x] = sk;
    __syncthreads();
    const int c_me = (int)(sk >> kRowBits);
    const bool live = c_me < k;
    const bool head =
        live && (threadIdx.x == 0 ||
                 (int)(s_key[threadIdx.x - 1] >> kRowBits) != c_me);
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned lives = __ballot_sync(kFull, live);
    if (lane == 0) {
      s_wseg[warp] = __popc(heads);
      s_wlive[warp] = __popc(lives);
    }
    __syncthreads();
    int seg = __popc(heads & ((1u << lane) - 1)), nseg = 0, nlive = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      if (i < warp) seg += s_wseg[i];
      nseg += s_wseg[i];
      nlive += s_wlive[i];
    }
    if (head) s_head[seg] = threadIdx.x;
    if (threadIdx.x == 0) s_head[nseg] = nlive;
    __syncthreads();

    // Segmented sums: item (segment s, slot j), j < d a feature, j == d the
    // count; each an fmaf chain (an add chain for the count) in row order
    // from the block's running value.
    const int dd = d + 1;
    for (int i = threadIdx.x; i < nseg * dd; i += kThreads) {
      const int s = i / dd;
      const int j = i - s * dd;
      const int p0 = s_head[s], p1 = s_head[s + 1];
      const int c = (int)(s_key[p0] >> kRowBits);
      float* slot = j < d ? acc + (long long)c * d + j : acc + kd + c;
      float a = *slot;
      if (j < d) {
        const float* xj = x + base * d + j;
        for (int p = p0; p < p1; ++p) {
          const int r = (int)(s_key[p] & (kThreads - 1));
          a = fmaf(s_w[r], __ldg(xj + (long long)r * d), a);
        }
      } else {
        for (int p = p0; p < p1; ++p) a += s_w[s_key[p] & (kThreads - 1)];
      }
      *slot = a;
    }
  }

  // Block cost in a fixed tree order.
  s_red[threadIdx.x] = cost;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) s_red[threadIdx.x] += s_red[threadIdx.x + s];
    __syncthreads();
  }
  if (acc_smem)
    for (long long i = threadIdx.x; i < kd + k; i += kThreads) part[i] = acc[i];
  if (threadIdx.x == 0) part[P - 1] = s_red[0];
}

// out[i] = sum over blocks, in block order, of partials[b][i]; float64 sum.
__global__ void reduce_partials(const float* __restrict__ partials, int blocks,
                                long long P, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < P;
       i += (long long)gridDim.x * blockDim.x) {
    double s = 0.0;
    for (int b = 0; b < blocks; ++b) s += (double)partials[(long long)b * P + i];
    out[i] = (float)s;
  }
}

#define DISPATCH_DP(dp, ...)                              \
  switch (dp) {                                           \
    case 4: { constexpr int DP = 4; __VA_ARGS__; } break;     \
    case 8: { constexpr int DP = 8; __VA_ARGS__; } break;     \
    case 16: { constexpr int DP = 16; __VA_ARGS__; } break;   \
    case 32: { constexpr int DP = 32; __VA_ARGS__; } break;   \
    case 64: { constexpr int DP = 64; __VA_ARGS__; } break;   \
    case 128: { constexpr int DP = 128; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;           \
  }

}  // namespace

extern "C" {

// K2 blocks resident on one SM for assign_kernel<padded_width(d), rows> at
// `smem` bytes of dynamic shared memory, for ops/lloyd.py::assign_plan's
// grid.  Returns 0 or a cudaError_t code; cudaErrorInvalidValue for a rows
// count K2 does not take at this width.
int lloyd_assign_occupancy(int d, int rows, int smem, int* per_sm) {
  AssignKernel kernel = nullptr;
  DISPATCH_DP(padded_width(d), kernel = assign_kernel_for<DP>(rows));
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                            kThreads, smem);
}

// K1 blocks resident on one SM at `smem` bytes of dynamic shared memory,
// for ops/lloyd.py::lloyd_plan's grid.  Returns 0 or a cudaError_t code.
int lloyd_stats_occupancy(int d, int smem, int* per_sm) {
  cudaError_t e = cudaSuccess;
  DISPATCH_DP(padded_width(d), {
    const auto kernel = lloyd_kernel<DP>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  });
  return (int)e;
}

// K1 with the plan of ops/lloyd.py::lloyd_plan (center tile kt, accumulators
// in shared memory or not, shared bytes, grid): partials (blocks * P floats,
// scratch) -> out (P floats: sums (k, d), counts (k,), cost).  Returns 0 or
// a cudaError_t code; cudaErrorInvalidValue when the plan does not fit the
// shape.
int lloyd_stats_launch(const float* x, const float* w, const float* centers,
                       const float* c_valid, long long n, int d, int k, int kt,
                       int acc_smem, int smem, int blocks, float* partials,
                       float* out, void* stream) {
  const int dp = padded_width(d);
  if (dp < 0 || k < 1 || k > kMaxCenters || kt < 1 || kt > k || blocks < 1 ||
      (size_t)smem != stats_smem(dp, kt, k, d, acc_smem))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  DISPATCH_DP(dp, {
    const auto kernel = lloyd_kernel<DP>;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      kernel<<<blocks, kThreads, smem, s>>>(x, w, centers, c_valid, n, d, k, kt,
                                            acc_smem, partials);
  });
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long P = (long long)k * d + k + 1;
  const int rblocks = (int)((P + kThreads - 1) / kThreads);
  reduce_partials<<<rblocks, kThreads, 0, s>>>(partials, blocks, P, out);
  return (int)cudaGetLastError();
}

// K2 with the plan of ops/lloyd.py::assign_plan (rows a thread, shared
// bytes, grid): out_assign (n,) int32, out_d2 (n,) float32.  Returns 0 or a
// cudaError_t code; cudaErrorInvalidValue when the plan does not fit the
// shape or `rows` is not taken at this width.
int lloyd_assign_launch(const float* x, const float* centers,
                        const float* c_valid, long long n, int d, int k,
                        int rows, int smem, int blocks, int* out_assign,
                        float* out_d2, void* stream) {
  Geometry g;
  if (!plan(d, k, &g) || blocks < 1 || (size_t)smem != g.smem)
    return (int)cudaErrorInvalidValue;
  AssignKernel kernel = nullptr;
  DISPATCH_DP(g.dp, kernel = assign_kernel_for<DP>(rows));
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kThreads, g.smem, static_cast<cudaStream_t>(stream)>>>(
      x, centers, c_valid, n, d, k, g.kt, out_assign, out_d2);
  return (int)cudaGetLastError();
}

const char* lloyd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
