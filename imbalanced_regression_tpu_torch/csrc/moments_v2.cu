// K4: split-precision segment moments on the tensor cores (sm_90a), bound
// to Python with ctypes (ops/cuda_kernels.py::segment_moments_v2).
//
// Replaces imbalanced_regression_tpu/ops/pallas_kernels.py:
// _moments_v2_kernel and _split3 (reached through pallas_moments_v2). The
// contract is K3's: per bucket b, count[b], sum[b, :] and sum-of-squares
// [b, :] of the float32 feature rows with idx == b; rows whose idx is
// outside [0, B) contribute nothing. The arithmetic is the TPU kernel's:
// f and f * f (rounded to float32 first) are each split into three bf16
// terms, h1 + h2 + h3 == x to float32 accuracy; a 0/1 one-hot, exact in
// bf16, multiplies the six terms on the tensor cores with float32
// accumulation; the three products of each quantity are added per output,
// (p1 + p2) + p3; the counts come from the one-hot.
//
// Bound on the H100: at the NYUD2 stats pass (N = 554,496 pixels, D = 128,
// B = 93) the features are 284 MB, ~0.085 ms at 3.35 TB/s; the dense
// one-hot products are 2 x 93 x N x 6D = 79 GFLOP, ~0.08 ms at the 989
// TFLOP/s bf16 peak. The two bounds are close, and this first version
// reaches neither: wmma (mma.sync) fragments, one stage of shared memory,
// no overlap of loads and products (wgmma and TMA are later work).
//
// Design:
// - Grid (16-column tiles of D) x (row chunks), the row split and the
//   fixed-order second pass of K3 (moments_common.cuh): deterministic.
// - One warp per split term (6 warps). A block walks its chunk in stages of
//   64 rows: it loads the rows' 16 float32 columns and their indices, writes
//   the six bf16 terms to shared memory as the B operand [64 rows][6 x 16],
//   and builds the one-hot [B padded to a multiple of 16][64 rows] there as
//   the A operand. Warp t then multiplies every 16-bucket tile of the one-hot
//   with its term's [16 rows][16 columns] tile, four k-steps per stage.
// - Accuracy: the tensor cores' float32 accumulation is not IEEE
//   round-to-nearest, so a long chain in one accumulator fragment would
//   drift. Each product starts from a zero fragment (at most 16 rows of one
//   bucket in it) and is added into the warp's running fragment with
//   ordinary float32 adds; each chunk's sum is then a float32 sum in row
//   order, as in K3.
// - Epilogue: the warps store their fragments to shared memory and the block
//   adds the three terms of each quantity per output.
//
// Entry point: fds_segment_moments_v2 (below); it launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "moments_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kCols = 16;                // feature columns per block
constexpr int kTerms = 6;                // h1, h2, h3 of f, then of f * f
constexpr int kRows = 64;                // rows per stage: four 16-row k-steps
constexpr int kThreads = kTerms * 32;    // one warp per term
constexpr int kLdG = kTerms * kCols + 8; // B operand row stride (bf16), padded
constexpr int kLdA = kRows + 8;          // A operand row stride (bf16), padded
constexpr int kMaxTiles = 8;             // up to 128 buckets
constexpr unsigned short kBf16One = 0x3F80;

__device__ __forceinline__ void split3(float x, __nv_bfloat16* h) {
  h[0] = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(h[0]));
  h[1] = __float2bfloat16_rn(r1);
  h[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h[1])));
}

template <int MT>
constexpr int smem_bytes() {
  constexpr int stage = (kRows * kLdG + MT * 16 * kLdA) * 2 + kRows * 4;
  constexpr int epilogue = kTerms * MT * 16 * kCols * 4;
  return stage > epilogue ? stage : epilogue;
}

// MT: 16-bucket tiles (B padded to MT * 16). Outputs: counts [chunks][nb],
// sums and sumsq [chunks][nb][d] (with one chunk, the final outputs).
template <int MT>
__global__ void __launch_bounds__(kThreads) moments_v2_kernel(
    const float* __restrict__ f, const int* __restrict__ idx, float* __restrict__ counts,
    float* __restrict__ sums, float* __restrict__ sumsq, int n, int d, int nb, int chunk_rows) {
  constexpr int BP = MT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* g = reinterpret_cast<__nv_bfloat16*>(smem);  // [kRows][kLdG]
  __nv_bfloat16* oh = g + kRows * kLdG;                        // [BP][kLdA]
  int* sidx = reinterpret_cast<int*>(oh + BP * kLdA);          // [kRows]
  float* stage = reinterpret_cast<float*>(smem);  // epilogue [kTerms][BP][kCols], aliases g/oh

  const int warp = threadIdx.x >> 5;  // the split term this warp multiplies
  const int c0 = blockIdx.x * kCols;
  const int chunk = blockIdx.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const bool do_count = blockIdx.x == 0;
  float count = 0.f;  // thread b < nb counts bucket b

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT], part;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
#pragma unroll
  for (int i = 0; i < MT; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
    // the stage's indices (-1: past the chunk, or outside [0, nb)) and the
    // six bf16 terms of its rows; rows and columns past the edge are zeros
    for (int t = threadIdx.x; t < kRows; t += kThreads) {
      const int r = r0 + t;
      const int e = r < r_end ? __ldg(idx + r) : -1;
      sidx[t] = e >= 0 && e < nb ? e : -1;
    }
    for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
      const int t = i / kCols, c = i % kCols;
      const int r = r0 + t, col = c0 + c;
      const float v = r < r_end && col < d ? __ldg(f + static_cast<size_t>(r) * d + col) : 0.f;
      __nv_bfloat16 h[kTerms];
      split3(v, h);
      split3(__fmul_rn(v, v), h + 3);
#pragma unroll
      for (int k = 0; k < kTerms; ++k) g[t * kLdG + k * kCols + c] = h[k];
    }
    __syncthreads();

    // one-hot [BP][kRows], eight bf16 (16 bytes) per store
    for (int i = threadIdx.x; i < BP * (kRows / 8); i += kThreads) {
      const int bucket = i / (kRows / 8), t8 = (i % (kRows / 8)) * 8;
      uint32_t w[4] = {0u, 0u, 0u, 0u};  // element k in the (k & 1)-th half of word k / 2
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (sidx[t8 + k] == bucket) w[k >> 1] |= static_cast<uint32_t>(kBf16One) << ((k & 1) * 16);
      *reinterpret_cast<uint4*>(oh + bucket * kLdA + t8) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    if (do_count && threadIdx.x < nb) {
      for (int t = 0; t < kRows; ++t) count += sidx[t] == static_cast<int>(threadIdx.x) ? 1.f : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      wmma::load_matrix_sync(b, g + kk * 16 * kLdG + warp * kCols, kLdG);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        wmma::load_matrix_sync(a, oh + i * 16 * kLdA + kk * 16, kLdA);
        wmma::fill_fragment(part, 0.f);
        wmma::mma_sync(part, a, b, part);
#pragma unroll
        for (int e = 0; e < part.num_elements; ++e) acc[i].x[e] += part.x[e];
      }
    }
    __syncthreads();  // the next stage (or the epilogue) overwrites g and oh
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
    wmma::store_matrix_sync(stage + (warp * BP + i * 16) * kCols, acc[i], kCols,
                            wmma::mem_row_major);
  __syncthreads();

  const size_t out = static_cast<size_t>(chunk) * nb * d;
  constexpr int term = BP * kCols;
  for (int i = threadIdx.x; i < nb * kCols; i += kThreads) {
    const int bucket = i / kCols, c = i % kCols, col = c0 + c;
    if (col >= d) continue;
    const float* s = stage + bucket * kCols + c;
    sums[out + static_cast<size_t>(bucket) * d + col] = (s[0] + s[term]) + s[2 * term];
    sumsq[out + static_cast<size_t>(bucket) * d + col] =
        (s[3 * term] + s[4 * term]) + s[5 * term];
  }
  if (do_count && threadIdx.x < nb) counts[static_cast<size_t>(chunk) * nb + threadIdx.x] = count;
}

template <int MT>
int launch_v2(const float* f, const int* idx, float* counts, float* sums, float* sumsq, int n,
              int d, int nb, int chunks, cudaStream_t stream) {
  constexpr int smem = smem_bytes<MT>();
  cudaFuncSetAttribute(moments_v2_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((d + kCols - 1) / kCols, chunks);
  moments_v2_kernel<MT><<<grid, kThreads, smem, stream>>>(f, idx, counts, sums, sumsq, n, d, nb,
                                                          rows_per_chunk(n, chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f [n, d] float32, idx [n] int32; outputs counts [nb], sums and sumsq
// [nb, d] float32; ws_*: workspaces [chunks][nb] and [chunks][nb][d] for
// chunks > 1 (may be null with one chunk). nb <= 128.
int fds_segment_moments_v2(const float* f, const int* idx, float* counts, float* sums,
                           float* sumsq, float* ws_counts, float* ws_sums, float* ws_sumsq, int n,
                           int d, int nb, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (nb + 15) / 16;
  if (d < 1 || nb < 1 || tiles > kMaxTiles || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool split = chunks > 1;
  float* c = split ? ws_counts : counts;
  float* su = split ? ws_sums : sums;
  float* sq = split ? ws_sumsq : sumsq;
  int err = 0;
  switch (tiles) {
    case 1: err = launch_v2<1>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
    case 2: err = launch_v2<2>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
    case 3: err = launch_v2<3>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
    case 4: err = launch_v2<4>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
    case 5: err = launch_v2<5>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
    case 6: err = launch_v2<6>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
    case 7: err = launch_v2<7>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
    default: err = launch_v2<8>(f, idx, c, su, sq, n, d, nb, chunks, s); break;
  }
  if (err != 0 || !split) return err;
  return launch_reduce_chunks(ws_counts, ws_sums, ws_sumsq, counts, sums, sumsq, chunks, nb, d,
                              s);
}

}  // extern "C"
