// FDS kernels for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Build (ops/cuda_kernels.py does this at first use, one nvcc per source
// file, then one link):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//        -c fds_kernels.cu -o fds_kernels.o   (the same for moments_v2.cu)
//   nvcc -shared -o libfds_kernels.so fds_kernels.o moments_v2.o
// No --use_fast_math: the calibrate kernels use IEEE division and square
// root (__fdiv_rn, __fsqrt_rn) and unfused multiply/add (__fmul_rn,
// __fadd_rn), so they round exactly like the plain PyTorch version, which
// runs the same float32 operations one at a time.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moments_common.cuh"

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive float32 values starting at p; `rem` = columns left in
// the row. VEC: one 16-byte load (caller guarantees alignment and rem >= 4).
template <bool VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p, int rem, float (&o)[4]) {
  if (VEC) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = k < rem ? __ldg(p + k) : 0.f;
  }
}

// Four consecutive bf16 values widened to float32 (VEC: one 8-byte load).
template <bool VEC>
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ p, int rem, float (&o)[4]) {
  if (VEC) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    o[0] = __low2float(lo); o[1] = __high2float(lo);
    o[2] = __low2float(hi); o[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = k < rem ? __bfloat162float(p[k]) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ p, int rem, const float (&o)[4]) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k < rem) p[k] = o[k];
  }
}

// ---------------------------------------------------------------------------
// K1 / K2: FDS calibrate, forward and backward.
//
// Replaces imbalanced_regression_tpu/ops/pallas_kernels.py: _calibrate_kernel
// (forward, reached through pallas_calibrate) and _calibrate_bwd_kernel (its
// custom-VJP backward).
//   forward:  out = mask ? (x - m1[e]) * sqrt(clip(v2[e] / v1[e], lo, hi)) + m2[e] : x
//   backward: dx  = g * (mask ? sqrt(clip(v2[e] / v1[e], lo, hi)) : 1)
//   mask = col_ok & (v1sum[e] >= 1e-10) & ok & (0 <= e < B), with
//   col_ok = v1 != 0 (nonzero mode) or v1 > 0 & v2 >= 0 (positive mode).
//
// Bound on the H100: memory. Per element it reads x, writes out and reads
// the four (two, backward) gathered table values, for ~10 float operations:
// about 1 operation per byte, far below the card's ~20 float32 operations
// per byte. At the age slice's shapes (N = 64, D = 2048, B = 100) the whole
// call moves a few MB, i.e. a few microseconds at 3.35 TB/s, so the launch
// itself dominates; at the NYUD2 train step's (N = 554,496 pixels, D = 128,
// B = 93) x in and out are 568 MB, ~0.17 ms.
//
// Design: the TPU kernel gathers each sample's bucket rows with a one-hot
// matmul because the TPU has no dynamic gather. Here each row reads its own
// e and ok once and loads its table rows directly by index, with 16-byte
// vector loads along D where D % 4 == 0 and the pointers are aligned. One
// thread owns four consecutive columns of one row; a 64 x 4 block covers
// 256 columns of 4 rows, so neighbouring threads touch neighbouring
// addresses. The grid's x axis walks the row blocks (the NYUD2 step has
// 138,624 of them, beyond the 65,535 of the y axis). Rows that are gated off copy x through without reading any
// table. The table rows of popular buckets are re-read by many rows and hit
// in L2 (the four [100, 2048] tables are 3.3 MB).
template <typename T, bool VEC, bool BWD>
__global__ void __launch_bounds__(256) calibrate_kernel(
    const T* __restrict__ x, const int* __restrict__ e, const bool* __restrict__ ok,
    const float* __restrict__ m1, const float* __restrict__ v1,
    const float* __restrict__ m2, const float* __restrict__ v2,
    const float* __restrict__ v1sum, float* __restrict__ out,
    int n, int d, int nb, float lo, float hi, int positive) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * 4;
  if (row >= n || col >= d) return;
  const int rem = d - col;
  const size_t off = static_cast<size_t>(row) * d + col;

  float xv[4];
  load4<VEC>(x + off, rem, xv);
  const int b = e[row];
  const bool row_on = b >= 0 && b < nb && ok[row] && v1sum[b] >= 1e-10f;
  if (row_on) {
    const size_t so = static_cast<size_t>(b) * d + col;
    float s1[4], s2[4], a1[4], a2[4];
    load4<VEC>(v1 + so, rem, s1);
    load4<VEC>(v2 + so, rem, s2);
    if (!BWD) {
      load4<VEC>(m1 + so, rem, a1);
      load4<VEC>(m2 + so, rem, a2);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool col_ok = positive ? (s1[k] > 0.f && s2[k] >= 0.f) : (s1[k] != 0.f);
      if (!col_ok) continue;
      const float r = __fdiv_rn(s2[k], s1[k]);
      // clamp as torch.clamp does: a NaN ratio stays NaN
      const float f = r < lo ? lo : (r > hi ? hi : r);
      const float s = __fsqrt_rn(f);
      xv[k] = BWD ? __fmul_rn(xv[k], s) : __fadd_rn(__fmul_rn(__fsub_rn(xv[k], a1[k]), s), a2[k]);
    }
  }
  store4<VEC>(out + off, rem, xv);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, bool BWD>
int launch_calibrate(const T* x, const int* e, const bool* ok, const float* m1,
                     const float* v1, const float* m2, const float* v2,
                     const float* v1sum, float* out, int n, int d, int nb, float lo,
                     float hi, int positive, cudaStream_t stream) {
  if (n == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(64, 4);
  // row blocks on x (up to 2^31 - 1; y and z stop at 65,535), column tiles on y
  const dim3 grid((n + block.y - 1) / block.y, (d + 4 * block.x - 1) / (4 * block.x));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  bool vec = d % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(v1, 16) &&
             aligned(v2, 16) && aligned(out, 16);
  if (!BWD) vec = vec && aligned(m1, 16) && aligned(m2, 16);
  if (vec)
    calibrate_kernel<T, true, BWD><<<grid, block, 0, stream>>>(
        x, e, ok, m1, v1, m2, v2, v1sum, out, n, d, nb, lo, hi, positive);
  else
    calibrate_kernel<T, false, BWD><<<grid, block, 0, stream>>>(
        x, e, ok, m1, v1, m2, v2, v1sum, out, n, d, nb, lo, hi, positive);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3: segment moments.
//
// Replaces imbalanced_regression_tpu/ops/pallas_kernels.py: _moments_kernel
// (reached through pallas_moments): per bucket b, count[b], sum[b, :] and
// sum-of-squares[b, :] of the feature rows with idx == b; rows whose idx is
// outside [0, B) (the -1 of padding) contribute nothing. float32
// accumulation.
//
// Bound on the H100: memory. Each feature value is read once and costs
// three operations. On the age path (N = 64, D = 2048, B = 100) the outputs
// (1.6 MB) outweigh the input and launch overhead dominates; on the NYUD2
// stats pass (N = 32 x 114 x 152 = 554,496 pixels, D = 128, B = 93) the
// 284 MB of features are the traffic: ~0.085 ms at 3.35 TB/s.
//
// Design: deterministic, with no float atomics. The TPU kernel contracts a
// one-hot [B, T] tile with the features on the MXU and carries the sums
// across the sequential grid. Here the grid is (32-column tiles of D) x
// (row chunks, moments_common.cuh): at D = 128 the four column tiles alone
// would leave 128 of 132 SMs idle, so the rows are cut into chunks until
// the blocks fill the card, and a second pass adds the chunks' partials in
// chunk order. Within a block each warp takes every nwarps-th row of the
// chunk; a lane owns one column, so a row is one coalesced 128-byte load,
// and the lane adds it into the warp's own [B, 32] accumulators in shared
// memory (one lane per address: no races). A warp starts the loads of U
// rows before it adds any of them, so U loads per warp are in flight. At
// the end the block adds its warps' accumulators in warp order. The order
// of every sum is fixed by (N, chunks, nwarps), so two runs give the same
// bits. Counts are kept only by the blocks of column tile 0 (as
// pl.when(i_d == 0) does), by lane 0 of each warp.
//
// Outputs: counts [chunks][nb], sums and sumsq [chunks][nb][d] (with one
// chunk, the final outputs).
template <typename T, int U>
__global__ void __launch_bounds__(256) moments_kernel(
    const T* __restrict__ f, const int* __restrict__ idx, float* __restrict__ counts,
    float* __restrict__ sums, float* __restrict__ sumsq, int n, int d, int nb, int chunk_rows) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int chunk = blockIdx.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const int acc_len = 2 * nb * 32;  // per warp: sums [nb][32], then sumsq [nb][32]
  float* acc = smem + warp * acc_len;
  float* cnt = smem + nwarps * acc_len;  // [nwarps][nb]
  const bool do_count = blockIdx.x == 0;

  const int total = nwarps * acc_len + nwarps * nb;
  for (int i = threadIdx.x; i < total; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  for (int r0 = r_begin + warp; r0 < r_end; r0 += nwarps * U) {
    int b[U];
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * nwarps;
      const bool in = r < r_end;
      b[u] = in ? __ldg(idx + r) : -1;
      v[u] = in && col < d ? to_float(f[static_cast<size_t>(r) * d + col]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (b[u] < 0 || b[u] >= nb) continue;  // the same for the whole warp
      if (col < d) {
        acc[b[u] * 32 + lane] += v[u];
        acc[(nb + b[u]) * 32 + lane] += __fmul_rn(v[u], v[u]);
      }
      if (do_count && lane == 0) cnt[warp * nb + b[u]] += 1.f;
    }
  }
  __syncthreads();

  const size_t out = static_cast<size_t>(chunk) * nb * d;
  for (int i = threadIdx.x; i < nb * 32; i += blockDim.x) {
    const int b = i >> 5, l = i & 31;
    const int c = blockIdx.x * 32 + l;
    if (c >= d) continue;
    float s = 0.f, q = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      s += smem[w * acc_len + b * 32 + l];
      q += smem[w * acc_len + (nb + b) * 32 + l];
    }
    sums[out + static_cast<size_t>(b) * d + c] = s;
    sumsq[out + static_cast<size_t>(b) * d + c] = q;
  }
  if (do_count) {
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      float c = 0.f;
      for (int w = 0; w < nwarps; ++w) c += cnt[w * nb + b];
      counts[static_cast<size_t>(chunk) * nb + b] = c;
    }
  }
}

constexpr int kMomentsRowsInFlight = 16;  // U: rows a warp loads before it adds them

// With chunks > 1 the first pass writes the ws_* workspaces ([chunks][nb]
// and [chunks][nb][d]) and the second pass the outputs.
template <typename T>
int launch_moments(const T* f, const int* idx, float* counts, float* sums, float* sumsq,
                   float* ws_counts, float* ws_sums, float* ws_sumsq, int n, int d, int nb,
                   int chunks, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int per_warp = (2 * nb * 32 + nb) * static_cast<int>(sizeof(float));
  int nwarps = max_smem / per_warp;
  if (nwarps > 8) nwarps = 8;
  if (nwarps < 1 || d == 0 || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = nwarps * per_warp;
  auto kernel = moments_kernel<T, kMomentsRowsInFlight>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const bool split = chunks > 1;
  const dim3 grid((d + 31) / 32, chunks);
  kernel<<<grid, nwarps * 32, smem, stream>>>(f, idx, split ? ws_counts : counts,
                                              split ? ws_sums : sums, split ? ws_sumsq : sumsq,
                                              n, d, nb, rows_per_chunk(n, chunks));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !split) return err;
  return launch_reduce_chunks(ws_counts, ws_sums, ws_sumsq, counts, sums, sumsq, chunks, nb, d,
                              stream);
}

}  // namespace

extern "C" {

int fds_calibrate_fwd(const void* x, int x_bf16, const int* e, const bool* ok,
                      const float* m1, const float* v1, const float* m2, const float* v2,
                      const float* v1sum, float* out, int n, int d, int nb, float lo,
                      float hi, int positive, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_calibrate<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(x), e, ok, m1, v1, m2, v2, v1sum, out, n, d, nb,
        lo, hi, positive, s);
  return launch_calibrate<float, false>(static_cast<const float*>(x), e, ok, m1, v1, m2, v2,
                                        v1sum, out, n, d, nb, lo, hi, positive, s);
}

int fds_calibrate_bwd(const float* g, const int* e, const bool* ok, const float* v1,
                      const float* v2, const float* v1sum, float* out, int n, int d, int nb,
                      float lo, float hi, int positive, void* stream) {
  return launch_calibrate<float, true>(g, e, ok, nullptr, v1, nullptr, v2, v1sum, out, n, d,
                                       nb, lo, hi, positive, static_cast<cudaStream_t>(stream));
}

// ws_*: workspaces for chunks > 1 (may be null with one chunk).
int fds_segment_moments(const void* f, int f_bf16, const int* idx, float* counts, float* sums,
                        float* sumsq, float* ws_counts, float* ws_sums, float* ws_sumsq, int n,
                        int d, int nb, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f_bf16)
    return launch_moments<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(f), idx, counts,
                                         sums, sumsq, ws_counts, ws_sums, ws_sumsq, n, d, nb,
                                         chunks, s);
  return launch_moments<float>(static_cast<const float*>(f), idx, counts, sums, sumsq, ws_counts,
                               ws_sums, ws_sumsq, n, d, nb, chunks, s);
}

}  // extern "C"
