// Level-histogram kernel for Hopper (sm_90a): K3 fused_level_hist.
//
// Replaces, in the JAX package:
//   K3  ops/pallas_kernels.py::fused_level_hist (body _hist_kernel,
//       pallas_call in _hist_call), called per tree level from
//       models/tree/engine.py::_make_level_hist.
//
// What it computes (the same function as the TPU kernel, not its d small
// matrix products per grid step):
//   hist[t, p, f, b, s] = sum_r [pos[t, r] = p] * w[t, r] * base[s, r]
//                               * [binned[f, r] = b]
//   binned (d, n) int32, base (S, n) f32, w (T, n) f32, pos (T, n) int32
//   (-1 off the frontier) -> hist (T, LN, d, B, S) f32.  Rows with pos
//   outside [0, LN), w == 0 or a bin outside [0, B) add nothing.
//
// What bounds it on an H100: the bytes bound is each input read once,
// 4 * n * (d + S + 2T) bytes, about 0.12 ms at n = 2M, d = 8, S = 3, T = 20
// (HBM 3.35 TB/s).  The kernel runs 9-24x above that, bound by the
// grouping: one __match_any_sync per (32 rows, tree, feature) and the
// leaders' serial group sums.  Taking the match out alone (a timing cut,
// k3_variants.py --cuts) removes 0.24-1.05 ms of the 1.04-2.94 ms a launch
// takes at the main shapes; staging, prologue and barriers alone run
// 0.2-1.0 ms.
//
// Design:
//   * A histogram, not a matrix product.  A block owns TB trees, one row
//     range and one output tile per tree (a range of frontier nodes x a
//     range of features) in shared memory.  Tiles and TB are sized by the
//     caller (ops/tree_hist.py hist_plan) to fit the shared-memory budget,
//     so a deep tree (LN = 1024) splits into node tiles instead of failing.
//   * Row tiles staged once per block.  The block walks its rows in tiles
//     of kTile = 128 rows and copies each tile's inputs (its features'
//     bins, the S base rows, pos and w of each of its trees) into a
//     double-buffered ring in shared memory with cp.async: 16-byte copies
//     when every row start is 16-byte aligned (n % 4 == 0), else 4-byte
//     copies; nothing past a row's end is read.  Tile i+1's copy is in
//     flight while the warps group tile i.  Once a tile has landed, one
//     prologue per (tree, row) writes w*base for every stat (padded so one
//     vector load reads them) and turns pos into the key offset of the
//     row's node, or -1 when the row adds nothing.  So the bins and base
//     rows go through L2 once per TB trees, not once per tree, and no warp
//     repeats another's loads.
//   * Deterministic, no float atomics.  Each warp takes (tree, feature)
//     pairs of the block and owns that pair's (node, bin, stat) slice.  For
//     each 32-row step the lanes that hit the same (node, bin) are grouped
//     with __match_any_sync; the lowest lane of each group sums the group's
//     w*base values in lane (row) order and adds the sum to the bin; steps
//     run in row order.  For the same row blocks this is, bit for bit, the
//     float32 chain of every (tree, row block, node, feature, bin, stat)
//     that the one-tree-a-block kernel before it computed
//     (k3_versions.py holds the two to torch.equal).
//   * Blocks run in parallel with no order, so each block writes a partial
//     tile per tree and a second kernel sums the partials in block order in
//     float64 (as K1 does in csrc/lloyd.cu).  With one row block per tree
//     the first kernel writes the output directly.  Two launches give
//     bit-identical results on one card.
//   * The grid (tree groups x row blocks x tiles) is sized by hist_plan
//     to whole waves of the blocks the card really holds at once, from
//     tree_hist_occupancy below, so no wave runs nearly empty.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLogTile = 7;
constexpr int kTile = 1 << kLogTile;  // rows a block stages at once (ops/tree_hist.py ROW_TILE)
constexpr int kSteps = kTile / 32;
constexpr int kMaxThreads = 512;  // ops/tree_hist.py MAX_WARPS * 32
// three resident blocks' worth of registers (at most 42 a thread) keeps
// ptxas from spilling and lets the small-tile plans hold 6-8 blocks an SM
constexpr int kMinBlocks = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A row's w*base values in shared memory, padded so that one vector load
// reads them: 2 floats at S = 2, 4 at S = 3, else S.
__host__ __device__ constexpr int stat_pad(int S) { return S == 3 ? 4 : S; }

// Shared layout, in 4-byte words: ring[2][dt + S + 2*TB][kTile] (bins,
// base, pos, w), then wb[TB][kTile][stat_pad(S)], then
// hist[TB][LNt * dt * B * S].  ops/tree_hist.py::smem_bytes computes the
// same size.
__host__ __device__ inline long long stage_words(int dt, int S, int TB) {
  return (long long)kTile * (2LL * (dt + S + 2 * TB) + (long long)TB * stat_pad(S));
}

// v[s] = p[s] for s < kS, one vector load at kS = 2 and 3
template <int kS>
__device__ __forceinline__ void load_stats(const float* p, float (&v)[kS]) {
  if constexpr (kS == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else if constexpr (kS == 3) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
  } else {
#pragma unroll
    for (int s = 0; s < kS; ++s) v[s] = p[s];
  }
}

// Copy rows [r0, r0 + cnt) of the block's arrays into one ring buffer.
// Array a of the buffer: a < dtt bins of feature f0 + a; then S base rows;
// then pos of trees t0 .. t0 + tbn - 1; then their w.  Slots of features
// past dtt and trees past tbn are left as they are and never read.
__device__ __forceinline__ void stage_tile(int* buf, const int* binned, const float* base,
                                           const float* w, const int* pos, long long n,
                                           int f0, int dtt, int dt, int S, int t0, int tbn,
                                           int TB, long long r0, int cnt, bool vec) {
  const int narr = dtt + S + 2 * tbn;
  const int shift = vec ? kLogTile - 2 : kLogTile;  // log2 of the copies per array
  for (int i = threadIdx.x; i < narr << shift; i += blockDim.x) {
    const int a = i >> shift;
    const int c = i - (a << shift);
    const int e = vec ? 4 * c : c;
    if (e >= cnt) continue;
    const void* src;
    int slot;
    if (a < dtt) {
      src = binned + (size_t)(f0 + a) * n;
      slot = a;
    } else if (a < dtt + S) {
      src = base + (size_t)(a - dtt) * n;
      slot = dt + (a - dtt);
    } else if (a < dtt + S + tbn) {
      src = pos + (size_t)(t0 + a - dtt - S) * n;
      slot = dt + S + (a - dtt - S);
    } else {
      src = w + (size_t)(t0 + a - dtt - S - tbn) * n;
      slot = dt + S + TB + (a - dtt - S - tbn);
    }
    const int* s = static_cast<const int*>(src) + r0 + e;
    int* d = buf + slot * kTile + e;
    if (vec)
      cp_async16(d, s);
    else
      cp_async4(d, s);
  }
  cp_async_commit();
}

// kS > 0 fixes the stat count at compile time (the trees' S = 2 and 3), so
// the stat loops unroll; kS == 0 takes S from the argument.
template <int kS>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
level_hist_kernel(const int* __restrict__ binned, const float* __restrict__ base,
                  const float* __restrict__ w, const int* __restrict__ pos, long long n,
                  int d, int S_arg, int B, int LN, int T, int LNt, int dt, int TB,
                  int n_ptiles, long long rows_per_block, int vec, float* __restrict__ dst) {
  extern __shared__ __align__(16) int smem[];
  const int S = kS > 0 ? kS : S_arg;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t0 = blockIdx.x * TB;
  const int bx = blockIdx.y;
  const int tbn = min(TB, T - t0);
  const int pt = blockIdx.z % n_ptiles;
  const int ft = blockIdx.z / n_ptiles;
  const int p0 = pt * LNt;
  const int f0 = ft * dt;
  const int lnt = min(LNt, LN - p0);
  const int dtt = min(dt, d - f0);
  const int BS = B * S;
  const int tile = lnt * dtt * BS;        // floats of one tree's tile in use
  const int tstride = LNt * dt * BS;      // floats reserved per tree
  const int ring = (dt + S + 2 * TB) * kTile;

  const int SP = stat_pad(S);
  int* rings = smem;
  float* wb = reinterpret_cast<float*>(smem + 2 * ring);
  float* hist = wb + TB * kTile * SP;
  for (int i = threadIdx.x; i < tbn * tstride; i += blockDim.x) hist[i] = 0.f;

  const long long r_begin = (long long)bx * rows_per_block;
  const long long r_end = min(n, r_begin + rows_per_block);
  const int rows = (int)(r_end - r_begin);  // at most MAX_ROWS_PER_BLOCK
  const int ntiles = (rows + kTile - 1) / kTile;
  const bool v = vec != 0;
  const unsigned below = (1u << lane) - 1u;  // lanes below this one
  const int nodeB = dtt * B;                 // key stride of one node
  // this warp's first (tree, feature) pair, and the step to its next
  const int tb_first = warp / dtt, fl_first = warp - tb_first * dtt;
  const int tb_step = nwarps / dtt, fl_step = nwarps - tb_step * dtt;

  stage_tile(rings, binned, base, w, pos, n, f0, dtt, dt, S, t0, tbn, TB, r_begin,
             min(kTile, rows), v);
  for (int it = 0; it < ntiles; ++it) {
    // tile `it` has landed, and every warp is done with tile it - 1, whose
    // buffer and wb the next copy and this tile's prologue reuse
    cp_async_wait_all();
    __syncthreads();
    const int off = it * kTile;
    const int cnt = min(kTile, rows - off);
    if (it + 1 < ntiles)
      stage_tile(rings + ((it + 1) & 1) * ring, binned, base, w, pos, n, f0, dtt, dt, S,
                 t0, tbn, TB, r_begin + off + kTile, min(kTile, rows - off - kTile), v);
    int* buf = rings + (it & 1) * ring;
    const int* bins_s = buf;
    const float* base_s = reinterpret_cast<const float*>(buf + dt * kTile);
    int* node_s = buf + (dt + S) * kTile;
    const float* w_s = reinterpret_cast<const float*>(buf + (dt + S + TB) * kTile);

    // the prologue, once per (tree, row): w * base per stat, and the key
    // offset of the row's node inside this tile, (p - p0) * dtt * B, or -1
    // when the row adds nothing
    for (int i = threadIdx.x; i < tbn * kTile; i += blockDim.x) {
      const int r = i & (kTile - 1);
      const int p = node_s[i];
      const float wv = w_s[i];
      const bool ok = r < cnt && p >= p0 && p < p0 + lnt && wv != 0.f;
      float* o = wb + i * SP;
      for (int s = 0; s < S; ++s) o[s] = wv * base_s[s * kTile + r];
      node_s[i] = ok ? (p - p0) * nodeB : -1;
    }
    __syncthreads();

    int tb = tb_first, fl = fl_first;
    for (int pair = warp; pair < tbn * dtt; pair += nwarps) {
      const int* nd = node_s + tb * kTile;
      const int* bn = bins_s + fl * kTile;
      const float* sc = wb + tb * kTile * SP;
      float* ht = hist + tb * tstride;
      // the key of a row is its bin's place in the tree's tile, (node *
      // dtt + fl) * B + bin, or -1; all kSteps groupings are issued before
      // the first group sum
      const int fB = fl * B;
      int key[kSteps];
      unsigned peers[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int nk = nd[u * 32 + lane];
        const int bin = bn[u * 32 + lane];
        key[u] = nk >= 0 && (unsigned)bin < (unsigned)B ? nk + fB + bin : -1;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        // only the lanes that hit a bin take part in the grouping
        const unsigned hits = __ballot_sync(kFull, key[u] >= 0);
        peers[u] = key[u] >= 0 ? __match_any_sync(hits, key[u]) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        // the lowest lane of each group leads it
        if (key[u] < 0 || (peers[u] & below)) continue;
        float* h = ht + key[u] * S;
        const float* su = sc + u * 32 * SP;
        if constexpr (kS > 0) {
          // one pass over the group for all stats: each stat's sum still
          // runs in lane order
          float acc[kS];
#pragma unroll
          for (int s = 0; s < kS; ++s) acc[s] = 0.f;
          unsigned m = peers[u];
          while (m) {
            const int j = __ffs(m) - 1;
            m &= m - 1;
            float x[kS];
            load_stats<kS>(su + j * SP, x);
#pragma unroll
            for (int s = 0; s < kS; ++s) acc[s] += x[s];
          }
#pragma unroll
          for (int s = 0; s < kS; ++s) h[s] += acc[s];
        } else {
          for (int s = 0; s < S; ++s) {
            float acc = 0.f;
            unsigned m = peers[u];
            while (m) {
              const int j = __ffs(m) - 1;
              m &= m - 1;
              acc += su[j * SP + s];
            }
            h[s] += acc;
          }
        }
      }
      fl += fl_step;
      tb += tb_step;
      if (fl >= dtt) {
        fl -= dtt;
        ++tb;
      }
    }
  }
  __syncthreads();

  // each tree's tile -> its (tree, row block) slice of dst, laid out (LN, d, B, S)
  for (int tb = 0; tb < tbn; ++tb) {
    const float* ht = hist + (size_t)tb * tstride;
    float* out = dst + ((size_t)(t0 + tb) * gridDim.y + bx) * ((size_t)LN * d * BS);
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
      const int pl = i / (dtt * BS);
      const int rem = i - pl * dtt * BS;
      const int fl = rem / BS;
      const int bs = rem - fl * BS;
      out[((size_t)(p0 + pl) * d + f0 + fl) * BS + bs] = ht[i];
    }
  }
}

// out[t, e] = sum over row blocks bx (in order) of partial[t, bx, e]
__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int T, int blocks_x,
                                   long long per_tree) {
  const long long total = (long long)T * per_tree;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / per_tree;
    const long long e = i - t * per_tree;
    const float* src = partial + (size_t)t * blocks_x * per_tree + e;
    double acc = 0.0;
    for (int b = 0; b < blocks_x; ++b) acc += (double)src[(size_t)b * per_tree];
    out[i] = (float)acc;
  }
}

using KernelFn = void (*)(const int*, const float*, const float*, const int*, long long,
                          int, int, int, int, int, int, int, int, int, long long, int,
                          float*);

KernelFn pick(int S) {
  return S == 2 ? level_hist_kernel<2> : S == 3 ? level_hist_kernel<3> : level_hist_kernel<0>;
}

}  // namespace

extern "C" {

// K3 blocks resident on one SM for the instantiation of stat count S at
// `nwarps` warps and `smem_bytes` of dynamic shared memory (the CUDA
// occupancy API).  Returns 0 or a cudaError_t code.
int tree_hist_occupancy(int S, int nwarps, int smem_bytes, int* per_sm) {
  if (S < 1 || nwarps < 1 || nwarps * 32 > kMaxThreads || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const KernelFn kernel = pick(S);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, nwarps * 32,
                                                      (size_t)smem_bytes);
  return (int)e;
}

// One K3 launch.  The plan (node tile LNt, feature tile dt, trees a block
// TB, node tiles, feature tiles, warps per block, row blocks per tree,
// rows per block, dynamic shared memory) comes from
// ops/tree_hist.py::hist_plan.  With blocks_x == 1 the kernel writes `out`
// directly and `partial` is unused; else `partial` holds
// T * blocks_x * LN*d*B*S floats.  Returns 0 or a cudaError_t code;
// cudaErrorInvalidValue for a plan that does not fit the shape.
int tree_hist_launch(const int* binned, const float* base, const float* w,
                     const int* pos, long long n, int d, int S, int B, int LN,
                     int T, int LNt, int dt, int TB, int n_ptiles, int n_ftiles,
                     int nwarps, int blocks_x, long long rows_per_block,
                     int smem_bytes, float* partial, float* out, void* stream) {
  const int n_tgroups = TB > 0 ? (T + TB - 1) / TB : 0;
  if (n < 1 || d < 1 || S < 1 || B < 1 || LN < 1 || T < 1 || LNt < 1 || dt < 1 ||
      TB < 1 || TB > T || nwarps < 1 || nwarps * 32 > kMaxThreads || blocks_x < 1 ||
      rows_per_block < 1 || rows_per_block % 32 != 0 || rows_per_block > (1LL << 30) ||
      (long long)(blocks_x - 1) * rows_per_block >= n ||
      (long long)blocks_x * rows_per_block < n || blocks_x > 65535 ||
      (long long)n_ptiles * LNt < LN || (long long)n_ftiles * dt < d ||
      (long long)n_ptiles * n_ftiles > 65535 ||
      (long long)smem_bytes !=
          4 * (stage_words(dt, S, TB) + (long long)TB * LNt * dt * B * S))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const KernelFn kernel = pick(S);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  // 16-byte copies need every row start 16-byte aligned
  const bool vec = n % 4 == 0 && ((reinterpret_cast<size_t>(binned) |
                                   reinterpret_cast<size_t>(base) |
                                   reinterpret_cast<size_t>(w) |
                                   reinterpret_cast<size_t>(pos)) & 15) == 0;
  dim3 grid(n_tgroups, blocks_x, n_ptiles * n_ftiles);
  float* dst = blocks_x == 1 ? out : partial;
  kernel<<<grid, nwarps * 32, smem_bytes, s>>>(binned, base, w, pos, n, d, S, B, LN, T,
                                               LNt, dt, TB, n_ptiles, rows_per_block,
                                               vec ? 1 : 0, dst);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (blocks_x > 1) {
    const long long per_tree = (long long)LN * d * B * S;
    const long long total = (long long)T * per_tree;
    long long blocks = (total + 255) / 256;
    if (blocks > 8192) blocks = 8192;
    hist_reduce_kernel<<<(int)blocks, 256, 0, s>>>(partial, out, T, blocks_x,
                                                   per_tree);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* tree_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
