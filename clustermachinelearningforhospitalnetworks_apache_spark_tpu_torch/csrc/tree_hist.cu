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
// What bounds it on an H100: per (tree, row) it reads pos and w (8 bytes),
// the row's d bins and S stats, and does d*S adds, so it is bound by bytes
// (HBM 3.35 TB/s): at n = 2M, d = 8, S = 3, T = 20 the least time is about
// 0.12 ms a launch.  This first version reads the shared bins and stats
// once per tree (from L2 when they fit), which costs more than that bound.
//
// Design:
//   * A histogram, not a matrix product.  Each block owns one tree and one
//     output tile (a range of frontier nodes x a range of features) in
//     shared memory, and walks one contiguous range of rows 32 at a time.
//     Tiles are sized by the caller (ops/tree_hist.py hist_plan) to fit the
//     shared-memory budget, so a deep tree (LN = 1024) splits into node
//     tiles instead of failing.
//   * Deterministic, no float atomics.  One warp owns a feature's
//     (node, bin, stat) slice of the tile.  For each 32-row step the lanes
//     that hit the same (node, bin) are grouped with __match_any_sync; the
//     lowest lane of each group sums the group's w*base values in lane
//     (row) order from a per-warp scratch and adds the sum to the bin.
//     A warp loads kUnroll steps before it uses the first, so several
//     loads are in flight per warp; rows still reach a bin in row order.
//   * Blocks run in parallel with no order, so each block writes a partial
//     tile and a second kernel sums the partials in block order in float64
//     (as K1 does in csrc/lloyd.cu).  With one row block per tree the first
//     kernel writes the output directly.  Two launches give bit-identical
//     results on one card.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // 32-row steps per loop trip (ops/tree_hist.py UNROLL)

// kS > 0 fixes the stat count at compile time (the trees' S = 2 and 3), so
// the stat loops unroll and their loads are all issued together; kS == 0
// takes S from the argument.
template <int kS>
__global__ void level_hist_kernel(const int* __restrict__ binned,
                                  const float* __restrict__ base,
                                  const float* __restrict__ w,
                                  const int* __restrict__ pos, long long n,
                                  int d, int S_arg, int B, int LN, int LNt, int dt,
                                  int n_ptiles, long long rows_per_block,
                                  float* __restrict__ dst) {
  extern __shared__ float smem[];
  const int S = kS > 0 ? kS : S_arg;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t = blockIdx.y;
  const int pt = blockIdx.z % n_ptiles;
  const int ft = blockIdx.z / n_ptiles;
  const int p0 = pt * LNt;
  const int f0 = ft * dt;
  const int lnt = min(LNt, LN - p0);
  const int dtt = min(dt, d - f0);
  const int BS = B * S;
  const int tile = lnt * dtt * BS;

  float* hist = smem;
  float* scratch = smem + (size_t)LNt * dt * BS + (size_t)warp * kUnroll * 32 * S;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(n, r_begin + rows_per_block);
  const int* pos_t = pos + (size_t)t * n;
  const float* w_t = w + (size_t)t * n;

  // kUnroll steps of 32 rows at a time: every load of the group is issued
  // before the first is used, so a warp keeps several in flight.  Rows
  // still reach each bin in row order.
  for (long long r0 = r_begin; r0 < r_end; r0 += 32 * kUnroll) {
    int p[kUnroll];
    float wv[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = r0 + u * 32 + lane;
      const bool in = r < r_end;
      p[u] = in ? pos_t[r] : -1;
      wv[u] = in ? w_t[r] : 0.f;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + u * 32 + lane;
        b[u] = r < r_end ? base[(size_t)s * n + r] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) scratch[(u * 32 + lane) * S + s] = wv[u] * b[u];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      ok[u] = p[u] >= p0 && p[u] < p0 + lnt && wv[u] != 0.f;
    __syncwarp();
    for (int fl = warp; fl < dtt; fl += nwarps) {
      const int* bf = binned + (size_t)(f0 + fl) * n;
      int bin[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + u * 32 + lane;
        bin[u] = r < r_end ? bf[r] : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool hit = ok[u] && bin[u] >= 0 && bin[u] < B;
        const int key = hit ? (p[u] - p0) * B + bin[u] : -1;
        const unsigned peers = __match_any_sync(kFull, key);
        if (hit && lane == __ffs(peers) - 1) {
          float* h = hist + ((size_t)(p[u] - p0) * dtt + fl) * BS + (size_t)bin[u] * S;
          const float* sc = scratch + u * 32 * S;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            float acc = 0.f;
            unsigned m = peers;
            while (m) {
              const int j = __ffs(m) - 1;
              m &= m - 1;
              acc += sc[j * S + s];
            }
            h[s] += acc;
          }
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // tile -> this (tree, row block)'s slice of dst, laid out (LN, d, B, S)
  float* out = dst + ((size_t)t * gridDim.x + blockIdx.x) * ((size_t)LN * d * BS);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int pl = i / (dtt * BS);
    const int rem = i - pl * dtt * BS;
    const int fl = rem / BS;
    const int bs = rem - fl * BS;
    out[((size_t)(p0 + pl) * d + f0 + fl) * BS + bs] = hist[i];
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

}  // namespace

extern "C" {

// One K3 launch.  The plan (node tile LNt, feature tile dt, node tiles,
// feature tiles, warps per block, row blocks per tree, rows per block,
// dynamic shared memory) comes from ops/tree_hist.py::hist_plan.  With
// blocks_x == 1 the kernel writes `out` directly and `partial` is unused;
// else `partial` holds T * blocks_x * LN*d*B*S floats.  Returns 0 or a
// cudaError_t code.
int tree_hist_launch(const int* binned, const float* base, const float* w,
                     const int* pos, long long n, int d, int S, int B, int LN,
                     int T, int LNt, int dt, int n_ptiles, int n_ftiles,
                     int nwarps, int blocks_x, long long rows_per_block,
                     int smem_bytes, float* partial, float* out, void* stream) {
  if (n < 1 || d < 1 || S < 1 || B < 1 || LN < 1 || T < 1 || LNt < 1 ||
      dt < 1 || nwarps < 1 || nwarps > 32 || blocks_x < 1 || T > 65535 ||
      (long long)n_ptiles * n_ftiles > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = S == 2 ? level_hist_kernel<2>
                : S == 3 ? level_hist_kernel<3> : level_hist_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(blocks_x, T, n_ptiles * n_ftiles);
  float* dst = blocks_x == 1 ? out : partial;
  kernel<<<grid, nwarps * 32, smem_bytes, s>>>(
      binned, base, w, pos, n, d, S, B, LN, LNt, dt, n_ptiles, rows_per_block,
      dst);
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
