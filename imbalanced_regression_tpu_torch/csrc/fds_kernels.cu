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
//   forward:  out = mask ? (x - m1[e]) * s + m2[e] : x
//   backward: dx  = g * (mask ? s : 1),   s = sqrt(clip(v2[e] / v1[e], lo, hi))
//   mask = col_ok & (v1sum[e] >= 1e-10) & ok & (0 <= e < B), with
//   col_ok = v1 != 0 (nonzero mode) or v1 > 0 & v2 >= 0 (positive mode).
//
// Bound on the H100: memory. Per element the function reads x and writes
// out, and a few operations; the [B, D] tables are read once. At the NYUD2
// train step's shape (N = 554,496 pixel rows, D = 128, B = 93) x in and out
// are 568 MB, ~0.17 ms at 3.35 TB/s; at the age shapes (N = 64-256, D =
// 2048) the call moves a few MB, and its time is the launch and the
// latency of its dependent loads.
//
// The TPU kernel gathers each sample's bucket rows with a one-hot matmul
// (the TPU has no dynamic gather). Here each row gathers its bucket's
// values by index. A thread owns C consecutive columns of one row (C = 4:
// one 16-byte load, where D % 4 == 0 and the pointers are aligned; else
// C = 1), and a block is a few rows of a row tile whose threads are the
// tile's columns (ops/cuda_kernels.py: calibrate_plan): at D = 128 a row is
// 32 threads and a block 8 rows, with no idle thread. A thread's loads come
// in two waves: x, e[row] and ok[row]; then, for a row in range with its
// flag set, its bucket's values, all together.
//
// The plan picks one of two forms from the shapes:
// - direct (K2 at every shape, K1 at small N): calibrate_direct_kernel
//   gathers v1, v2, v1sum (and, forward, m1 and m2), applies the v1sum and
//   column guards after the loads, and divides and takes the square root
//   per element; a row the guards turn off skips the arithmetic.
// - factored (K1 at large N, where the per-element division and square
//   root of four gathered values hold back the memory stream):
//   calibrate_factor_kernel first writes, once per (bucket, column), the
//   factor s, m1 and m2 into a [3][B][D] scratch table, with the column
//   and v1sum guards folded in: an entry they turn off holds s = 1, m1 =
//   +0, m2 = -0, for which (x - m1) * s + m2 gives x bit for bit. Then
//   calibrate_gather_kernel gathers three values an element, which stay in
//   L1 (the depth table is 143 KB), and does a subtract, a multiply and an
//   add. K2's direct form gathers two values and keeps up with the memory
//   stream as it is.
//
// s is the same float32 value whether computed per element or per
// (bucket, column), so both forms are bit-equal to the plain version
// (ops/calibrate.py: calibrate_indexed, calibrate_indexed_grad).
constexpr int kCalibrateThreads = 256;  // a block

template <int C, typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, float (&o)[C]) {
  if constexpr (C == 4) {
    load4<true>(p, 4, o);
  } else {
    o[0] = to_float(p[0]);
  }
}

template <int C>
__device__ __forceinline__ void store_cols(float* __restrict__ p, const float (&o)[C]) {
  if constexpr (C == 4) {
    store4<true>(p, 4, o);
  } else {
    p[0] = o[0];
  }
}

__device__ __forceinline__ bool col_ok(float v1, float v2, int positive) {
  return positive ? (v1 > 0.f) & (v2 >= 0.f) : v1 != 0.f;
}

// sqrt(clip(v2 / v1, lo, hi)) with IEEE division and square root, clamped
// as torch.clamp does: a NaN ratio stays NaN. A column the guard turns off
// divides by 1, as the plain version does (its result is not used): a zero
// divisor would send the division down its slow path.
__device__ __forceinline__ float factor(bool on, float v1, float v2, float lo, float hi) {
  const float r = __fdiv_rn(v2, on ? v1 : 1.f);
  return __fsqrt_rn(r < lo ? lo : (r > hi ? hi : r));
}

template <bool BWD>
__device__ __forceinline__ float apply(float x, float m1, float s, float m2) {
  return BWD ? __fmul_rn(x, s) : __fadd_rn(__fmul_rn(__fsub_rn(x, m1), s), m2);
}

template <typename T, int C, bool BWD>
__global__ void __launch_bounds__(kCalibrateThreads) calibrate_direct_kernel(
    const T* __restrict__ x, const int* __restrict__ e, const bool* __restrict__ ok,
    const float* __restrict__ m1, const float* __restrict__ v1,
    const float* __restrict__ m2, const float* __restrict__ v2,
    const float* __restrict__ v1sum, float* __restrict__ out,
    int n, int d, int nb, float lo, float hi, int positive) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * C;
  if (row >= n || col >= d) return;
  const size_t off = static_cast<size_t>(row) * d + col;
  // wave 1: x and the row's bucket and flag
  float xv[C];
  load_cols<C>(x + off, xv);
  const int b = __ldg(e + row);
  const bool row_in = (b >= 0) & (b < nb) & ok[row];
  // wave 2, for a row in range with its flag set: v1sum and the table values
  const size_t so = static_cast<size_t>(row_in ? b : 0) * d + col;
  float vsum = 0.f;
  float s1[C] = {}, s2[C] = {}, a1[C] = {}, a2[C] = {};
  if (row_in) {
    vsum = __ldg(v1sum + b);
    load_cols<C>(v1 + so, s1);
    load_cols<C>(v2 + so, s2);
    if (!BWD) {
      load_cols<C>(m1 + so, a1);
      load_cols<C>(m2 + so, a2);
    }
  }
  if (row_in & (vsum >= 1e-10f)) {  // the same for the threads of a row
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const bool col_on = col_ok(s1[k], s2[k], positive);
      const float y = apply<BWD>(xv[k], BWD ? 0.f : a1[k], factor(col_on, s1[k], s2[k], lo, hi),
                                 BWD ? 0.f : a2[k]);
      xv[k] = col_on ? y : xv[k];
    }
  }
  store_cols<C>(out + off, xv);
}

// The factored form's table (K1): s [B][D], then m1 and m2 [B][D], the
// guards folded in. One thread C entries.
template <int C>
__global__ void __launch_bounds__(kCalibrateThreads) calibrate_factor_kernel(
    const float* __restrict__ m1, const float* __restrict__ v1, const float* __restrict__ m2,
    const float* __restrict__ v2, const float* __restrict__ v1sum, float* __restrict__ table,
    int d, int nb, float lo, float hi, int positive) {
  const int entries = nb * d;
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * C;
  if (i >= entries) return;
  float s1[C], s2[C], a1[C], a2[C], s[C];
  load_cols<C>(v1 + i, s1);
  load_cols<C>(v2 + i, s2);
  load_cols<C>(m1 + i, a1);
  load_cols<C>(m2 + i, a2);
  const bool bucket_on = __ldg(v1sum + i / d) >= 1e-10f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const bool on = bucket_on & col_ok(s1[k], s2[k], positive);
    s[k] = on ? factor(on, s1[k], s2[k], lo, hi) : 1.f;
    a1[k] = on ? a1[k] : 0.f;
    a2[k] = on ? a2[k] : -0.f;
  }
  store_cols<C>(table + i, s);
  store_cols<C>(table + entries + i, a1);
  store_cols<C>(table + 2 * entries + i, a2);
}

template <typename T, int C>
__global__ void __launch_bounds__(kCalibrateThreads) calibrate_gather_kernel(
    const T* __restrict__ x, const int* __restrict__ e, const bool* __restrict__ ok,
    const float* __restrict__ table, float* __restrict__ out, int n, int d, int nb) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * C;
  if (row >= n || col >= d) return;
  const size_t off = static_cast<size_t>(row) * d + col;
  // wave 1: x and the row's bucket and flag
  float xv[C];
  load_cols<C>(x + off, xv);
  const int b = __ldg(e + row);
  const bool row_in = (b >= 0) & (b < nb) & ok[row];
  // wave 2, for a row in range with its flag set: its bucket's entries
  if (row_in) {
    const size_t entries = static_cast<size_t>(nb) * d;
    const size_t so = static_cast<size_t>(b) * d + col;
    float s[C], a1[C], a2[C];
    load_cols<C>(table + so, s);
    load_cols<C>(table + entries + so, a1);
    load_cols<C>(table + 2 * entries + so, a2);
#pragma unroll
    for (int k = 0; k < C; ++k) xv[k] = apply<false>(xv[k], a1[k], s[k], a2[k]);
  }
  store_cols<C>(out + off, xv);
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The plan (ops/cuda_kernels.py: calibrate_plan): C = cols, a block of
// block_x x block_y threads, grid_x x grid_y blocks; with a scratch table
// (K1's factored form, [3][B][D] floats) the factor kernel first. Checked
// here against the shapes; a plan that does not fit them is refused.
template <typename T, bool BWD, int C>
int launch_calibrate_cols(const T* x, const int* e, const bool* ok, const float* m1,
                          const float* v1, const float* m2, const float* v2,
                          const float* v1sum, float* out, float* table, int n, int d, int nb,
                          float lo, float hi, int positive, int block_x, int block_y,
                          int grid_x, int grid_y, cudaStream_t stream) {
  if (C == 4) {
    bool vec = d % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(v1, 16) && aligned(v2, 16) &&
               aligned(out, 16) && aligned(table, 16);
    if (!BWD) vec = vec && aligned(m1, 16) && aligned(m2, 16);
    if (!vec) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (block_x * block_y > kCalibrateThreads || static_cast<long long>(grid_x) * block_y < n ||
      static_cast<long long>(grid_y) * block_x * C < d)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, grid_y), block(block_x, block_y);
  if constexpr (!BWD) {
    if (table != nullptr) {  // K1's factored form
      const int groups = nb * d / C;  // C divides d
      calibrate_factor_kernel<C><<<(groups + kCalibrateThreads - 1) / kCalibrateThreads,
                                   kCalibrateThreads, 0, stream>>>(m1, v1, m2, v2, v1sum, table, d,
                                                                   nb, lo, hi, positive);
      const int err = static_cast<int>(cudaGetLastError());
      if (err != 0) return err;
      calibrate_gather_kernel<T, C><<<grid, block, 0, stream>>>(x, e, ok, table, out, n, d, nb);
      return static_cast<int>(cudaGetLastError());
    }
  }
  calibrate_direct_kernel<T, C, BWD><<<grid, block, 0, stream>>>(
      x, e, ok, m1, v1, m2, v2, v1sum, out, n, d, nb, lo, hi, positive);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool BWD>
int launch_calibrate(const T* x, const int* e, const bool* ok, const float* m1,
                     const float* v1, const float* m2, const float* v2,
                     const float* v1sum, float* out, float* table, int n, int d, int nb,
                     float lo, float hi, int positive, int cols, int block_x, int block_y,
                     int grid_x, int grid_y, cudaStream_t stream) {
  if (n == 0 || d == 0) return static_cast<int>(cudaGetLastError());
  if (nb < 0 || (nb == 0 && table != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (cols == 4)
    return launch_calibrate_cols<T, BWD, 4>(x, e, ok, m1, v1, m2, v2, v1sum, out, table, n, d,
                                            nb, lo, hi, positive, block_x, block_y, grid_x,
                                            grid_y, stream);
  if (cols == 1)
    return launch_calibrate_cols<T, BWD, 1>(x, e, ok, m1, v1, m2, v2, v1sum, out, table, n, d,
                                            nb, lo, hi, positive, block_x, block_y, grid_x,
                                            grid_y, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// K3: segment moments.
//
// Replaces imbalanced_regression_tpu/ops/pallas_kernels.py: _moments_kernel
// (reached through pallas_moments): per bucket b, count[b], sum[b, :] and
// sum-of-squares[b, :] of the feature rows with idx == b; rows whose idx is
// outside [0, B) (the -1 of padding) contribute nothing. float32
// accumulation and no float atomics: every sum is taken in an order fixed
// by (N, D, B, the launch plan and the card), so two calls give the same
// bits.
//
// Bound on the H100: memory. Each valid feature value is read once and
// costs three operations. The port runs K3 at two shapes, with a kernel for
// each; the wrapper's moments_plan picks one from N:
// - the age stats pass (N = 64, D = 2048, B = 100): the outputs (1.6 MB)
//   outweigh the input, ~0.6 us at 3.35 TB/s, below the launch itself:
//   moments_short_kernel, sized by the work;
// - the NYUD2 stats pass (N = 32 x 114 x 152 = 554,496 pixels, D = 128,
//   B = 93): the 284 MB of features are the traffic, ~0.076 ms:
//   moments_split_kernel.
//
// The TPU kernel contracts a one-hot [B, T] tile with the features on the
// MXU and carries the sums across its sequential grid; neither kernel here
// builds a one-hot.

// Short-batch kernel. A warp owns one bucket and 128 columns (four per
// lane) and keeps their sums in registers, so there is no accumulator to
// zero in shared memory and no epilogue across warps: each output is
// written once. The block stages the batch's indices in shared memory; a
// warp finds its bucket's rows 32 at a time by ballot, then loads them
// kShortRowsInFlight at a time and adds them in row order. Each feature row
// is read by one warp per column tile. Counts are the ballots' popcounts,
// written by the warps of column tile 0. Grid: (128-column tiles) x (groups
// of kShortWarps buckets).
constexpr int kShortMaxRows = 4096;    // indices staged in shared memory (16 KB)
constexpr int kShortWarps = 8;         // buckets per block
constexpr int kShortRowsInFlight = 4;  // feature rows a warp loads before it adds them

template <typename T, bool VEC>
__global__ void __launch_bounds__(kShortWarps * 32) moments_short_kernel(
    const T* __restrict__ f, const int* __restrict__ idx, float* __restrict__ counts,
    float* __restrict__ sums, float* __restrict__ sumsq, int n, int d, int nb) {
  __shared__ int sidx[kShortMaxRows];
  for (int r = threadIdx.x; r < n; r += blockDim.x) sidx[r] = __ldg(idx + r);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y * kShortWarps + (threadIdx.x >> 5);
  if (b >= nb) return;  // the same for the whole warp
  const int col = blockIdx.x * 128 + lane * 4;
  const int rem = d - col;  // columns from this lane's first to the row's end (<= 0: none)
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  int count = 0;
  int r0 = -32;
  unsigned rows = 0u;  // rows of bucket b among r0 .. r0 + 31 not taken yet
  for (;;) {
    // the next kShortRowsInFlight rows of bucket b, in row order (-1: none left)
    int r[kShortRowsInFlight];
#pragma unroll
    for (int k = 0; k < kShortRowsInFlight; ++k) {
      while (rows == 0u && r0 + 32 < n) {  // uniform across the warp
        r0 += 32;
        rows = __ballot_sync(0xffffffffu, r0 + lane < n && sidx[r0 + lane] == b);
        count += __popc(rows);
      }
      r[k] = rows ? r0 + __ffs(rows) - 1 : -1;
      rows &= rows - 1u;
    }
    if (r[0] < 0) break;
    // unconditional loads (see moments_split_kernel): a missing row loads
    // row r[0] and a lane past the last column column 0, and neither is added
    float x[kShortRowsInFlight][4];
#pragma unroll
    for (int k = 0; k < kShortRowsInFlight; ++k)
      load4<VEC>(f + static_cast<size_t>(r[k] >= 0 ? r[k] : r[0]) * d + (rem > 0 ? col : 0),
                 rem > 0 ? rem : d, x[k]);
#pragma unroll
    for (int k = 0; k < kShortRowsInFlight; ++k) {
      if (r[k] < 0 || rem <= 0) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] += x[k][j];
        q[j] += __fmul_rn(x[k][j], x[k][j]);
      }
    }
  }
  if (rem > 0) {
    const size_t out = static_cast<size_t>(b) * d + col;
    store4<VEC>(sums + out, rem, s);
    store4<VEC>(sumsq + out, rem, q);
  }
  if (blockIdx.x == 0 && lane == 0) counts[b] = static_cast<float>(count);
}

// Row-split kernel. The grid is (32-column tiles of D) x (row chunks,
// moments_common.cuh): at D = 128 the four column tiles alone would leave
// 128 of 132 SMs idle, so the rows are cut into chunks until the blocks fill
// the card, and a second pass adds the chunks' partials in chunk order. A
// lane owns one column, so a row is one coalesced load. Each warp keeps its
// own (sum, sum of squares) per bucket and lane in shared memory, one float2
// (one 8-byte load and store per update), and the block its counts, as
// integers. At the end the block adds its warps' sums in warp order.
//
// A warp takes batches of U = kSplitRowsInFlight consecutive rows of its
// chunk (warp w the batches w, w + nwarps, ...): lane u loads the index of row u and stages
// the batch's buckets in the warp's shared memory, from where every lane
// reads four at a time. While the warp adds one batch, the loads of the next
// batch's rows (only rows inside the buckets) and the index after that are
// in flight. It adds a batch in groups of kMergeRows rows: the rows of one
// bucket are first added together in registers, in row order (the buckets
// are the same across the warp, so this is uniform work), which leaves one
// row per bucket, the leader; then every row of the group loads its slot,
// adds and stores it back, in three phases with no branch: a leader's slot is
// its bucket's, the other rows' a spare slot (bucket nb) that no output
// reads. With no two leaders on one address the phases pipeline, instead of
// running one read-add-write chain per row, each waiting for the last in
// case two rows share a bucket. Integer adds do not depend on their
// order, so the counts are shared-memory atomics (one lane per warp). The
// order of every float sum (row order within a group, then group, batch,
// warp and chunk order) is fixed by (N, chunks, nwarps).
constexpr int kMergeRows = 4;  // a group: the four buckets of one 16-byte load
// 32 rows (16 KB per SM of 8 warps at D = 128) cover HBM latency by
// Little's law; 16 were 11-13% slower on the H100.
constexpr int kSplitRowsInFlight = 32;

// Shared memory of the row split: per warp the (sum, sum of squares) slots
// [nb + 1][32] and the staged buckets of two batches [2][32], and the
// block's counts [nb + 1].
inline int split_bytes_per_warp(int nb) { return ((nb + 1) * 32 * 2 + 2 * 32) * 4; }
inline int split_bytes_per_block(int nb) { return (nb + 1) * 4; }

template <typename T>
__global__ void __launch_bounds__(256) moments_split_kernel(
    const T* __restrict__ f, const int* __restrict__ idx, float* __restrict__ counts,
    float* __restrict__ sums, float* __restrict__ sumsq, int n, int d, int nb, int chunk_rows) {
  constexpr int U = kSplitRowsInFlight;
  static_assert(U % kMergeRows == 0 && U <= 32, "one index per lane, whole merge groups");
  extern __shared__ float2 smem2[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int chunk = blockIdx.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const int slots = nb + 1;  // slot nb: the spare slot
  float2* acc = smem2 + warp * slots * 32 + lane;  // acc[b * 32]: this lane's slot of bucket b
  int* staged = reinterpret_cast<int*>(smem2 + nwarps * slots * 32) + warp * 2 * 32;  // [2][32]
  int* cnt = reinterpret_cast<int*>(smem2 + nwarps * slots * 32) + nwarps * 2 * 32;   // [slots]
  const bool do_count = blockIdx.x == 0;

  for (int i = threadIdx.x; i < nwarps * slots * 32; i += blockDim.x)
    smem2[i] = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < slots; i += blockDim.x) cnt[i] = 0;
  __syncthreads();

  // Batch r0's buckets into staged[buf] (-1: past the chunk or outside [0, nb)).
  auto stage = [&](int r0, int raw, int buf) {
    if (lane < U) staged[buf * 32 + lane] = r0 + lane < r_end && raw >= 0 && raw < nb ? raw : -1;
    __syncwarp();
  };
  // Every load below is unconditional, from an address inside the arrays: a
  // load under a predicate whose result is then selected compiles to a load
  // into a scratch register and a move that waits for it, and with the
  // scratch register reused, only a few loads are in flight at a time. So
  // the index loads clamp to the chunk's last row, and a row outside the
  // buckets loads row r0 (a lane past the last column, the last column):
  // none of these values reaches an output.
  auto load_index = [&](int r0) { return __ldg(idx + min(r0 + lane, r_end - 1)); };
  auto load_rows = [&](int r0, int buf, float (&v)[U]) {
    const T* rows = f + static_cast<size_t>(r0) * d + min(col, d - 1);
    const int4* b4 = reinterpret_cast<const int4*>(staged + buf * 32);
#pragma unroll
    for (int g = 0; g < U; g += 4) {
      const int4 b = b4[g / 4];
      v[g] = to_float(rows[b.x >= 0 ? g * d : 0]);
      v[g + 1] = to_float(rows[b.y >= 0 ? (g + 1) * d : 0]);
      v[g + 2] = to_float(rows[b.z >= 0 ? (g + 2) * d : 0]);
      v[g + 3] = to_float(rows[b.w >= 0 ? (g + 3) * d : 0]);
    }
  };
  auto add_rows = [&](int buf, const float (&v)[U]) {
    const int4* b4 = reinterpret_cast<const int4*>(staged + buf * 32);
#pragma unroll
    for (int g = 0; g < U; g += kMergeRows) {
      const int4 b4g = b4[g / kMergeRows];
      const int b[kMergeRows] = {b4g.x, b4g.y, b4g.z, b4g.w};
      float s[kMergeRows], q[kMergeRows];
      bool lead[kMergeRows];  // the group's first row of its bucket
#pragma unroll
      for (int k = 0; k < kMergeRows; ++k) {
        s[k] = v[g + k];
        q[k] = __fmul_rn(s[k], s[k]);
        lead[k] = b[k] >= 0;
      }
      // each row joins the earlier leader of its bucket, in row order
#pragma unroll
      for (int k = 1; k < kMergeRows; ++k) {
#pragma unroll
        for (int j = 0; j < k; ++j) {
          if (lead[j] && b[j] == b[k]) {
            s[j] += s[k];
            q[j] += q[k];
            lead[k] = false;
          }
        }
      }
      float2* p[kMergeRows];
      float2 a[kMergeRows];
#pragma unroll
      for (int k = 0; k < kMergeRows; ++k) p[k] = acc + (lead[k] ? b[k] : nb) * 32;
#pragma unroll
      for (int k = 0; k < kMergeRows; ++k) a[k] = *p[k];
#pragma unroll
      for (int k = 0; k < kMergeRows; ++k) *p[k] = make_float2(a[k].x + s[k], a[k].y + q[k]);
    }
    if (do_count && lane == 0) {
#pragma unroll
      for (int g = 0; g < U; g += 4) {
        const int4 b = b4[g / 4];
        if (b.x >= 0) atomicAdd(cnt + b.x, 1);
        if (b.y >= 0) atomicAdd(cnt + b.y, 1);
        if (b.z >= 0) atomicAdd(cnt + b.z, 1);
        if (b.w >= 0) atomicAdd(cnt + b.w, 1);
      }
    }
  };

  const int stride = nwarps * U;
  const int first = r_begin + warp * U;
  if (first < r_end) {  // the same for the whole warp
    stage(first, load_index(first), 0);
    float v[U];
    load_rows(first, 0, v);
    int raw = load_index(first + stride);
    int buf = 0;
    for (int r0 = first; r0 < r_end; r0 += stride) {
      const int next = r0 + stride;
      float vn[U];
      if (next < r_end) {  // the next batch's loads, in flight while this one is added
        stage(next, raw, buf ^ 1);
        load_rows(next, buf ^ 1, vn);
        raw = load_index(next + stride);
      }
      add_rows(buf, v);
#pragma unroll
      for (int u = 0; u < U; ++u) v[u] = vn[u];
      buf ^= 1;
      __syncwarp();  // staged[buf ^ 1] was read above; the next batch overwrites it
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
      const float2 a = smem2[(w * slots + b) * 32 + l];
      s += a.x;
      q += a.y;
    }
    sums[out + static_cast<size_t>(b) * d + c] = s;
    sumsq[out + static_cast<size_t>(b) * d + c] = q;
  }
  if (do_count)
    for (int b = threadIdx.x; b < nb; b += blockDim.x)
      counts[static_cast<size_t>(chunk) * nb + b] = static_cast<float>(cnt[b]);
}

// The launch plans of fds_segment_moments (ops/cuda_kernels.py: moments_plan).
constexpr int kShortBatch = 0;
constexpr int kRowSplit = 1;

// The card's opt-in shared memory per block, read once per device.
int max_shared_memory(int dev) {
  static int cached[64] = {};
  if (dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return cached[dev];
}

template <typename T>
int launch_short(const T* f, const int* idx, float* counts, float* sums, float* sumsq, int n,
                 int d, int nb, cudaStream_t stream) {
  if (n > kShortMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + 127) / 128, (nb + kShortWarps - 1) / kShortWarps);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned(f, 4 * sizeof(T)) && aligned(sums, 16) &&
                   aligned(sumsq, 16);
  if (vec)
    moments_short_kernel<T, true><<<grid, kShortWarps * 32, 0, stream>>>(f, idx, counts, sums,
                                                                          sumsq, n, d, nb);
  else
    moments_short_kernel<T, false><<<grid, kShortWarps * 32, 0, stream>>>(f, idx, counts, sums,
                                                                           sumsq, n, d, nb);
  return static_cast<int>(cudaGetLastError());
}

// With chunks > 1 the first pass writes the ws_* workspaces ([chunks][nb]
// and [chunks][nb][d]) and the second pass the outputs.
template <typename T>
int launch_split(const T* f, const int* idx, float* counts, float* sums, float* sumsq,
                 float* ws_counts, float* ws_sums, float* ws_sumsq, int n, int d, int nb,
                 int chunks, cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  const int max_smem = max_shared_memory(dev);
  const int nwarps = min(8, (max_smem - split_bytes_per_block(nb)) / split_bytes_per_warp(nb));
  if (nwarps < 1 || chunks < 1 || chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = moments_split_kernel<T>;
  // this instance may take the card's whole opt-in shared memory: set once per device
  static unsigned long long opted_in = 0;
  if (!(opted_in >> dev & 1ull)) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    opted_in |= 1ull << dev;
  }
  const bool split = chunks > 1;
  const dim3 grid((d + 31) / 32, chunks);
  const int smem = nwarps * split_bytes_per_warp(nb) + split_bytes_per_block(nb);
  kernel<<<grid, nwarps * 32, smem, stream>>>(
      f, idx, split ? ws_counts : counts, split ? ws_sums : sums, split ? ws_sumsq : sumsq, n, d,
      nb, rows_per_chunk(n, chunks));
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !split) return err;
  return launch_reduce_chunks(ws_counts, ws_sums, ws_sumsq, counts, sums, sumsq, chunks, nb, d,
                              stream);
}

template <typename T>
int launch_moments(const T* f, const int* idx, float* counts, float* sums, float* sumsq,
                   float* ws_counts, float* ws_sums, float* ws_sumsq, int n, int d, int nb,
                   int chunks, int kernel, cudaStream_t stream) {
  if (n < 0 || d < 1 || nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return static_cast<int>(cudaGetLastError());
  if (kernel == kShortBatch)
    return launch_short(f, idx, counts, sums, sumsq, n, d, nb, stream);
  if (kernel == kRowSplit)
    return launch_split<T>(f, idx, counts, sums, sumsq, ws_counts, ws_sums, ws_sumsq, n, d, nb,
                           chunks, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// table: scratch for the factored form ([3][nb][d] floats; null: the direct
// form); then the plan's cols, block_x, block_y, grid_x, grid_y.
int fds_calibrate_fwd(const void* x, int x_bf16, const int* e, const bool* ok,
                      const float* m1, const float* v1, const float* m2, const float* v2,
                      const float* v1sum, float* out, float* table, int n, int d, int nb,
                      float lo, float hi, int positive, int cols, int block_x, int block_y,
                      int grid_x, int grid_y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch_calibrate<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(x), e, ok, m1, v1, m2, v2, v1sum, out, table, n, d,
        nb, lo, hi, positive, cols, block_x, block_y, grid_x, grid_y, s);
  return launch_calibrate<float, false>(static_cast<const float*>(x), e, ok, m1, v1, m2, v2,
                                        v1sum, out, table, n, d, nb, lo, hi, positive, cols,
                                        block_x, block_y, grid_x, grid_y, s);
}

int fds_calibrate_bwd(const float* g, const int* e, const bool* ok, const float* v1,
                      const float* v2, const float* v1sum, float* out, int n, int d, int nb,
                      float lo, float hi, int positive, int cols, int block_x, int block_y,
                      int grid_x, int grid_y, void* stream) {
  return launch_calibrate<float, true>(g, e, ok, nullptr, v1, nullptr, v2, v1sum, out, nullptr,
                                       n, d, nb, lo, hi, positive, cols, block_x, block_y, grid_x,
                                       grid_y, static_cast<cudaStream_t>(stream));
}

// The most rows the short-batch kernel takes (ops/cuda_kernels.py checks
// its plan's threshold against this when it loads the library).
int fds_moments_short_max_rows() { return kShortMaxRows; }

// kernel 0: the short-batch kernel (n <= fds_moments_short_max_rows(), one
// chunk); kernel 1: the row split into `chunks` chunks. ws_*: workspaces for
// chunks > 1 (may be null with one chunk).
int fds_segment_moments(const void* f, int f_bf16, const int* idx, float* counts, float* sums,
                        float* sumsq, float* ws_counts, float* ws_sums, float* ws_sumsq, int n,
                        int d, int nb, int chunks, int kernel, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == kShortBatch && chunks != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (f_bf16)
    return launch_moments<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(f), idx, counts,
                                         sums, sumsq, ws_counts, ws_sums, ws_sumsq, n, d, nb,
                                         chunks, kernel, s);
  return launch_moments<float>(static_cast<const float*>(f), idx, counts, sums, sumsq, ws_counts,
                               ws_sums, ws_sumsq, n, d, nb, chunks, kernel, s);
}

}  // extern "C"
