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
// (p1 + p2) + p3; the counts are integers.
//
// Bound on the H100: at the NYUD2 stats pass (N = 554,496 pixels, D = 128,
// B = 93) the features are 284 MB, ~0.085 ms at 3.35 TB/s. A dense one-hot
// product would be 2 x 96 x N x 6D = 82 GFLOP, as much time again at the
// bf16 peak, and more at mma.sync's rate; but a 16-row step touches at most
// 16 buckets, so the products that are not all zero are far fewer: on a
// random index ~10 of the 12 eight-bucket tiles a step, on a depth map's
// index (buckets in runs along image rows) 1-2. So the bytes bound K4 when
// it multiplies only those tiles and keeps its operands out of shared
// memory: a one-hot tile built there every few rows, behind block barriers,
// costs more than the rows themselves.
//
// Design: everything in registers, no shared-memory operand, no barrier in
// the row loop.
// - mma.sync.m16n8k16 (bf16 in, float32 out). A is the split terms,
//   transposed: M = 16 feature columns, K = 16 rows. B is the one-hot: K =
//   16 rows, N = 8 buckets (a bucket tile). With K on the rows, a thread's
//   A and B fragments cover the same four rows (2t, 2t+1, 2t+8, 2t+9 of the
//   step, t = lane % 4): each thread loads those rows' features and
//   indices, splits the features into bf16 pairs (cvt.rn.bf16x2) and builds
//   its one-hot words by comparing the indices with the tile's buckets.
// - Columns: lane group g = lane / 4 holds the mma rows g and g + 8, which
//   are mapped to the adjacent feature columns 2g and 2g + 1, so a thread
//   reads one 8-byte pair of each of its rows and the 8 lanes of a group
//   read one 64-byte row segment; the epilogue undoes the mapping.
// - Skipping: each lane sets the bits of the tiles its rows fall in, the
//   warp ORs them (__reduce_or_sync) and runs the products of those tiles
//   only, in a fully unrolled loop under a warp-uniform branch (the
//   accumulators keep static register indices). A skipped product is all
//   zeros, so skipping changes no sum.
// - Accuracy: the tensor cores' float32 accumulation is not IEEE
//   round-to-nearest, so each product starts from a zero fragment (at most
//   16 rows of one bucket) and (p1 + p2) + p3 is added to the running sum
//   with IEEE float32 adds: each chunk's sum is a float32 sum in row-step
//   order, as in K3.
// - Loads: unconditional, from a row clamped into the chunk (a row past
//   its end gets index -1 when it is used); the next kAhead steps' loads
//   are issued before a step's products.
// - Counts: integer shared-memory atomics by the lanes of group 0 in the
//   blocks of column tile 0 (exact in any order).
// - Row split: grid (16-column tiles) x (row chunks), kWarps warps a block
//   taking the chunk's 16-row steps in turn; the warps' sums are added in
//   warp order in shared memory at the end, then the chunks in chunk order
//   by the second pass (moments_common.cuh): deterministic. The chunk count
//   comes from the wrapper (one wave of kMinBlocksPerSM blocks a SM).
//
// Entry point: fds_segment_moments_v2 (below); it launches on the caller's
// stream, allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moments_common.cuh"

namespace {

constexpr int kWarps = 4;              // warps a block, on one column tile
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;              // feature columns a block (the mma's M)
constexpr int kTile = 8;               // buckets a tile (the mma's N)
constexpr int kStep = 16;              // rows a step (the mma's K)
constexpr int kMaxTiles = 16;          // up to 128 buckets
constexpr int kMinBlocksPerSM = 3;     // register cap 65536 / (3 * 128) = 170
constexpr int kAhead = 1;              // steps loaded ahead of the one multiplied
constexpr uint32_t kOneLo = 0x3F80u;   // bf16 1.0 in the low half of a word
constexpr uint32_t kOneHi = 0x3F800000u;

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 p) {
  return *reinterpret_cast<uint32_t*>(&p);
}

// The three bf16 terms of lo and hi (float32), each pair in one word, lo
// in the low half: h1 = bf16(x), h2 = bf16(x - h1), h3 = bf16(x - h1 - h2),
// every subtraction in float32 (ops/cuda_kernels.py::split3).
__device__ __forceinline__ void split3_pair(float lo, float hi, uint32_t& h1, uint32_t& h2,
                                            uint32_t& h3) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  h1 = as_u32(p);
  lo = __fsub_rn(lo, __low2float(p));
  hi = __fsub_rn(hi, __high2float(p));
  p = __floats2bfloat162_rn(lo, hi);
  h2 = as_u32(p);
  h3 = as_u32(__floats2bfloat162_rn(__fsub_rn(lo, __low2float(p)),
                                    __fsub_rn(hi, __high2float(p))));
}

// d = A B from a zero accumulator: A 16x16 (row-major fragment a), B 16x8
// (column-major fragment b0, b1), bf16 in, float32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// One step's loads of a thread: its four rows' two feature columns and
// indices, as loaded (validity is applied when the step is used).
struct Step {
  float2 v[4];
  int e[4];
};

// The step's row q (0..3) of thread t: 2t, 2t + 1, 2t + 8, 2t + 9.
__device__ __forceinline__ int row_of(int t, int q) { return 2 * t + (q & 1) + (q >> 1) * 8; }

template <bool VEC>
__device__ __forceinline__ void load_step(Step& s, const float* __restrict__ f,
                                          const int* __restrict__ idx, int r0, int last, int t,
                                          int d, int col_a, int col_b) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = min(r0 + row_of(t, q), last);
    const float* row = f + static_cast<size_t>(r) * d;
    s.e[q] = __ldg(idx + r);
    if (VEC) {
      s.v[q] = __ldg(reinterpret_cast<const float2*>(row + col_a));
    } else {
      s.v[q] = make_float2(__ldg(row + col_a), __ldg(row + col_b));
    }
  }
}

// NT: 8-bucket tiles (B padded to NT * 8). VEC: 8-byte feature loads (d
// even, f 8-byte aligned). Outputs: counts [chunks][nb], sums and sumsq
// [chunks][nb][d] (with one chunk, the final outputs).
template <int NT, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM) moments_v2_kernel(
    const float* __restrict__ f, const int* __restrict__ idx, float* __restrict__ counts,
    float* __restrict__ sums, float* __restrict__ sumsq, int n, int d, int nb, int chunk_rows) {
  constexpr int BP = NT * kTile;
  __shared__ int scount[BP];
  __shared__ __align__(16) float stage[2][BP][kCols];  // the block's (sum, sumsq) [bucket][column]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kCols;
  const int chunk = blockIdx.y;
  const int r_begin = chunk * chunk_rows;
  const int r_end = min(n, r_begin + chunk_rows);
  const bool counting = blockIdx.x == 0;
  // this thread's feature columns: mma rows g and g + 8 are columns 2g and
  // 2g + 1 of the tile; past the last column, a column inside the row (its
  // sums are never stored)
  const int col_a = VEC ? min(c0 + 2 * g, d - 2) : min(c0 + 2 * g, d - 1);
  const int col_b = min(c0 + 2 * g + 1, d - 1);
  for (int i = threadIdx.x; i < BP; i += kThreads) scount[i] = 0;
  __syncthreads();

  float acc_s[NT][4], acc_q[NT][4];  // running sums of f and of f * f, per tile
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_s[i][j] = acc_q[i][j] = 0.f;

  constexpr int stride = kWarps * kStep;
  int r0 = r_begin + warp * kStep;
  if (r0 < r_end) {
    const int last = r_end - 1;
    Step ring[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      load_step<VEC>(ring[a], f, idx, r0 + a * stride, last, t, d, col_a, col_b);
    for (; r0 < r_end; r0 += stride) {
      const Step s = ring[0];
#pragma unroll
      for (int a = 0; a + 1 < kAhead; ++a) ring[a] = ring[a + 1];
      load_step<VEC>(ring[kAhead - 1], f, idx, r0 + kAhead * stride, last, t, d, col_a, col_b);

      // indices: the bucket, or -1 (past the chunk, or outside [0, nb));
      // k[q] == 8 i marks row q in bucket 8 i + g, this lane's one-hot column
      int k[4];
      uint32_t bits = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = s.e[q];
        const bool ok = r0 + row_of(t, q) < r_end && e >= 0 && e < nb;
        k[q] = ok ? e - g : -1;
        bits |= ok ? 1u << ((e >> 3) & 31) : 0u;  // e >> 3: its tile
        if (counting && g == 0 && ok) atomicAdd(&scount[e], 1);
      }
      const uint32_t mask = __reduce_or_sync(0xffffffffu, bits);
      if (mask == 0) continue;

      // the mma's A fragments (rows g, g + 8 x steps 2t..2t+1, 2t+8..2t+9):
      // a[0] = (column 2g; rows 2t, 2t+1), a[1] = (2g + 1; 2t, 2t+1),
      // a[2] = (2g; 2t+8, 2t+9), a[3] = (2g + 1; 2t+8, 2t+9)
      uint32_t hf[3][4], hq[3][4];
      split3_pair(s.v[0].x, s.v[1].x, hf[0][0], hf[1][0], hf[2][0]);
      split3_pair(s.v[0].y, s.v[1].y, hf[0][1], hf[1][1], hf[2][1]);
      split3_pair(s.v[2].x, s.v[3].x, hf[0][2], hf[1][2], hf[2][2]);
      split3_pair(s.v[2].y, s.v[3].y, hf[0][3], hf[1][3], hf[2][3]);
      split3_pair(__fmul_rn(s.v[0].x, s.v[0].x), __fmul_rn(s.v[1].x, s.v[1].x), hq[0][0], hq[1][0],
                  hq[2][0]);
      split3_pair(__fmul_rn(s.v[0].y, s.v[0].y), __fmul_rn(s.v[1].y, s.v[1].y), hq[0][1], hq[1][1],
                  hq[2][1]);
      split3_pair(__fmul_rn(s.v[2].x, s.v[2].x), __fmul_rn(s.v[3].x, s.v[3].x), hq[0][2], hq[1][2],
                  hq[2][2]);
      split3_pair(__fmul_rn(s.v[2].y, s.v[2].y), __fmul_rn(s.v[3].y, s.v[3].y), hq[0][3], hq[1][3],
                  hq[2][3]);

#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (!(mask >> i & 1u)) continue;  // warp-uniform
        // the one-hot B fragment of tile i: column g (bucket 8i + g), steps
        // 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1)
        const uint32_t b0 = (k[0] == kTile * i ? kOneLo : 0u) | (k[1] == kTile * i ? kOneHi : 0u);
        const uint32_t b1 = (k[2] == kTile * i ? kOneLo : 0u) | (k[3] == kTile * i ? kOneHi : 0u);
        float p1[4], p2[4], p3[4];
        mma_bf16(p1, hf[0], b0, b1);
        mma_bf16(p2, hf[1], b0, b1);
        mma_bf16(p3, hf[2], b0, b1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_s[i][j] += (p1[j] + p2[j]) + p3[j];
        mma_bf16(p1, hq[0], b0, b1);
        mma_bf16(p2, hq[1], b0, b1);
        mma_bf16(p3, hq[2], b0, b1);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc_q[i][j] += (p1[j] + p2[j]) + p3[j];
      }
    }
  }

  // the warps' sums, added in warp order; accumulator j of tile i is
  // (column 2g + j / 2, bucket 8i + 2t + j % 2)
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* s = reinterpret_cast<float2*>(&stage[0][kTile * i + 2 * t + h][2 * g]);
          float2* q = reinterpret_cast<float2*>(&stage[1][kTile * i + 2 * t + h][2 * g]);
          const float2 vs = make_float2(acc_s[i][h], acc_s[i][2 + h]);
          const float2 vq = make_float2(acc_q[i][h], acc_q[i][2 + h]);
          if (w == 0) {
            *s = vs;
            *q = vq;
          } else {
            *s = make_float2(s->x + vs.x, s->y + vs.y);
            *q = make_float2(q->x + vq.x, q->y + vq.y);
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t out = static_cast<size_t>(chunk) * nb * d;
  for (int i = threadIdx.x; i < nb * kCols; i += kThreads) {
    const int bucket = i / kCols, c = i % kCols, col = c0 + c;
    if (col >= d) continue;
    sums[out + static_cast<size_t>(bucket) * d + col] = stage[0][bucket][c];
    sumsq[out + static_cast<size_t>(bucket) * d + col] = stage[1][bucket][c];
  }
  if (counting)
    for (int b = threadIdx.x; b < nb; b += kThreads)
      counts[static_cast<size_t>(chunk) * nb + b] = static_cast<float>(scount[b]);
}

template <int NT>
int launch_v2(const float* f, const int* idx, float* counts, float* sums, float* sumsq, int n,
              int d, int nb, int chunks, cudaStream_t stream) {
  const dim3 grid((d + kCols - 1) / kCols, chunks);
  const int rows = rows_per_chunk(n, chunks);
  if (d % 2 == 0 && reinterpret_cast<uintptr_t>(f) % 8 == 0)
    moments_v2_kernel<NT, true><<<grid, kThreads, 0, stream>>>(f, idx, counts, sums, sumsq, n, d,
                                                                nb, rows);
  else
    moments_v2_kernel<NT, false><<<grid, kThreads, 0, stream>>>(f, idx, counts, sums, sumsq, n, d,
                                                                 nb, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Blocks of K4 that one SM holds at once (the wrapper sizes the row chunks
// to one wave of them).
int fds_moments_v2_blocks_per_sm() { return kMinBlocksPerSM; }

// f [n, d] float32, idx [n] int32; outputs counts [nb], sums and sumsq
// [nb, d] float32; ws_*: workspaces [chunks][nb] and [chunks][nb][d] for
// chunks > 1 (may be null with one chunk). nb <= 128.
int fds_segment_moments_v2(const float* f, const int* idx, float* counts, float* sums,
                           float* sumsq, float* ws_counts, float* ws_sums, float* ws_sumsq, int n,
                           int d, int nb, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (nb + kTile - 1) / kTile;
  if (n < 0 || d < 1 || nb < 1 || tiles > kMaxTiles || chunks < 1 || chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool split = chunks > 1;
  float* c = split ? ws_counts : counts;
  float* su = split ? ws_sums : sums;
  float* sq = split ? ws_sumsq : sumsq;
  // tile counts rounded up to an instance (a tile past nb's is never
  // touched, so it is always skipped)
  int err = 0;
  if (tiles <= 1) err = launch_v2<1>(f, idx, c, su, sq, n, d, nb, chunks, s);
  else if (tiles <= 2) err = launch_v2<2>(f, idx, c, su, sq, n, d, nb, chunks, s);
  else if (tiles <= 4) err = launch_v2<4>(f, idx, c, su, sq, n, d, nb, chunks, s);
  else if (tiles <= 8) err = launch_v2<8>(f, idx, c, su, sq, n, d, nb, chunks, s);
  else if (tiles <= 12) err = launch_v2<12>(f, idx, c, su, sq, n, d, nb, chunks, s);
  else err = launch_v2<16>(f, idx, c, su, sq, n, d, nb, chunks, s);
  if (err != 0 || !split) return err;
  return launch_reduce_chunks(ws_counts, ws_sums, ws_sumsq, counts, sums, sumsq, chunks, nb, d,
                              s);
}

}  // extern "C"
