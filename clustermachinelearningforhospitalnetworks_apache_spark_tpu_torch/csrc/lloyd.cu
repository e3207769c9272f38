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
//   * One thread scores one row against every center; a block walks row tiles
//     of kThreads rows in a grid-stride loop over an occupancy-sized grid.
//   * Centers, |c|^2 and c_valid live in shared memory with rows padded to
//     DP (a multiple of 4) so the inner product reads float4 broadcasts.  When
//     all k centers do not fit in the 48 KB budget they are tiled through it;
//     the running min/argmin is carried from one tile to the next.
//   * The TPU kernel accumulated into one output block across a sequential
//     grid.  Here blocks run in parallel, so each block writes one partial
//     (sums, counts, cost) and a second kernel reduces the partials in block
//     order, in float64.  Inside a block each cluster is owned by one thread,
//     which adds its rows in row order: no atomics, so a run is bit-for-bit
//     repeatable on one card.  The owner's accumulators sit in shared memory
//     when they fit beside the centers, else in the block's own partial.
//   * Rows past n are masked inside the kernel; n == 0 is handled by the
//     caller (nothing to launch).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;           // rows per tile == threads per block
constexpr int kSmemBudget = 48 * 1024;  // stays under the default opt-in limit
constexpr float kBig = 1e30f;

struct Geometry {
  int dp;          // padded feature width (4, 8, 16, 32, 64 or 128)
  int kt;          // centers per shared-memory tile (== k when resident)
  int acc_smem;    // K1: per-cluster accumulators in shared memory
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

// Shared-memory plan for one (d, k) shape; stats selects K1's extra buffers.
bool plan(int d, int k, bool stats, Geometry* g) {
  g->dp = padded_width(d);
  if (g->dp < 0 || k < 1) return false;
  const size_t per_center = (size_t)(g->dp + 2) * sizeof(float);
  const size_t extra = stats ? 3 * kThreads * sizeof(float) : 0;
  const size_t acc = ((size_t)k * d + k) * sizeof(float);
  const size_t avail = kSmemBudget - extra;
  if ((size_t)k * per_center <= avail) {
    g->kt = k;
    g->acc_smem = stats && (size_t)k * per_center + acc <= avail;
  } else {
    g->kt = (int)(avail / per_center) / 32 * 32;
    g->acc_smem = 0;
  }
  if (g->kt < 1) return false;
  g->smem = (size_t)g->kt * per_center + extra +
            (g->acc_smem ? acc : 0);
  return true;
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

template <int DP>
__global__ void __launch_bounds__(kThreads)
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
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    const long long row = base + threadIdx.x;
    const bool valid = row < n;
    float xr[DP], xsq, best;
    int arg;
    load_row<DP>(x, row, d, valid, xr, xsq);
    row_argmin<DP>(xr, xsq, centers, c_valid, d, k, kt, cs, csq, cval, best,
                   arg);
    if (valid) {
      out_assign[row] = arg;
      out_d2[row] = best;
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    lloyd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ centers,
                 const float* __restrict__ c_valid, long long n, int d, int k,
                 int kt, int acc_smem, float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  float* cs = reinterpret_cast<float*>(smem4);
  float* csq = cs + (size_t)kt * DP;
  float* cval = csq + kt;
  int* s_asg = reinterpret_cast<int*>(cval + kt);
  float* s_w = reinterpret_cast<float*>(s_asg + kThreads);
  float* s_red = s_w + kThreads;
  const long long kd = (long long)k * d;
  const long long P = kd + k + 1;
  float* part = partials + (long long)blockIdx.x * P;
  float* acc = acc_smem ? s_red + kThreads : part;

  // Each cluster's accumulators are touched only by its owner thread.
  for (int c = threadIdx.x; c < k; c += kThreads) {
    for (int j = 0; j < d; ++j) acc[(long long)c * d + j] = 0.f;
    acc[kd + c] = 0.f;
  }
  if (kt >= k) {
    load_centers<DP>(centers, c_valid, 0, k, d, cs, csq, cval);
    __syncthreads();
  }

  float cost = 0.f;
  for (long long base = (long long)blockIdx.x * kThreads; base < n;
       base += (long long)gridDim.x * kThreads) {
    const long long row = base + threadIdx.x;
    const bool valid = row < n;
    float xr[DP], xsq, best;
    int arg;
    load_row<DP>(x, row, d, valid, xr, xsq);
    row_argmin<DP>(xr, xsq, centers, c_valid, d, k, kt, cs, csq, cval, best,
                   arg);
    const float wr = valid ? w[row] : 0.f;
    if (wr != 0.f) cost = fmaf(best, wr, cost);

    __syncthreads();  // the previous tile's owners are done with s_asg/s_w
    s_asg[threadIdx.x] = arg;
    s_w[threadIdx.x] = wr;
    __syncthreads();

    const long long left = n - base;
    const int rows_here = left < kThreads ? (int)left : kThreads;
    for (int c = threadIdx.x; c < k; c += kThreads) {
      float a[DP], cnt = 0.f;
      bool any = false;
      for (int r = 0; r < rows_here; ++r) {
        const float wv = s_w[r];
        if (s_asg[r] != c || wv == 0.f) continue;
        if (!any) {
          any = true;
#pragma unroll
          for (int j = 0; j < DP; ++j)
            a[j] = j < d ? acc[(long long)c * d + j] : 0.f;
          cnt = acc[kd + c];
        }
        const float* xrow = x + (base + r) * d;
#pragma unroll
        for (int j = 0; j < DP; ++j)
          if (j < d) a[j] = fmaf(wv, __ldg(xrow + j), a[j]);
        cnt += wv;
      }
      if (any) {
#pragma unroll
        for (int j = 0; j < DP; ++j)
          if (j < d) acc[(long long)c * d + j] = a[j];
        acc[kd + c] = cnt;
      }
    }
  }

  // Block cost in a fixed tree order.
  s_red[threadIdx.x] = cost;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) s_red[threadIdx.x] += s_red[threadIdx.x + s];
    __syncthreads();
  }
  if (acc_smem) {
    for (int c = threadIdx.x; c < k; c += kThreads) {
      for (int j = 0; j < d; ++j)
        part[(long long)c * d + j] = acc[(long long)c * d + j];
      part[kd + c] = acc[kd + c];
    }
  }
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

template <typename F>
int occupancy_blocks(F kernel, size_t smem, long long n, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(tiles < cap ? (tiles > 0 ? tiles : 1) : cap);
  return 0;
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

// Grid size for one launch of K1 (stats != 0) or K2; the caller sizes K1's
// partial buffer as blocks * (k*d + k + 1) floats.  Returns 0 or a
// cudaError_t code.
int lloyd_num_blocks(long long n, int d, int k, int stats, int* blocks) {
  Geometry g;
  if (!plan(d, k, stats != 0, &g)) return (int)cudaErrorInvalidValue;
  int rc = 0;
  if (stats) {
    DISPATCH_DP(g.dp, rc = occupancy_blocks(lloyd_kernel<DP>, g.smem, n, blocks));
  } else {
    DISPATCH_DP(g.dp, rc = occupancy_blocks(assign_kernel<DP>, g.smem, n, blocks));
  }
  return rc;
}

// K1: partials (blocks * P floats, scratch) -> out (P floats: sums (k, d),
// counts (k,), cost).
int lloyd_stats_launch(const float* x, const float* w, const float* centers,
                       const float* c_valid, long long n, int d, int k,
                       int blocks, float* partials, float* out,
                       void* stream) {
  Geometry g;
  if (!plan(d, k, true, &g) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_DP(g.dp, lloyd_kernel<DP><<<blocks, kThreads, g.smem, s>>>(
                        x, w, centers, c_valid, n, d, k, g.kt, g.acc_smem,
                        partials));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long P = (long long)k * d + k + 1;
  const int rblocks = (int)((P + kThreads - 1) / kThreads);
  reduce_partials<<<rblocks, kThreads, 0, s>>>(partials, blocks, P, out);
  return (int)cudaGetLastError();
}

// K2: out_assign (n,) int32, out_d2 (n,) float32.
int lloyd_assign_launch(const float* x, const float* centers,
                        const float* c_valid, long long n, int d, int k,
                        int blocks, int* out_assign, float* out_d2,
                        void* stream) {
  Geometry g;
  if (!plan(d, k, false, &g) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DISPATCH_DP(g.dp, assign_kernel<DP><<<blocks, kThreads, g.smem, s>>>(
                        x, centers, c_valid, n, d, k, g.kt, out_assign,
                        out_d2));
  return (int)cudaGetLastError();
}

const char* lloyd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
