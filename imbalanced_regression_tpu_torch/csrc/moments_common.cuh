// The row split shared by the segment-moments kernels (K3 in
// fds_kernels.cu, K4 in moments_v2.cu).
//
// Both kernels cut the N rows into `chunks` contiguous chunks of
// ceil(N / chunks) rows; the block of (column tile, chunk) writes the
// partial counts [nb], sums and sums of squares [nb, d] of its chunk to
// slot `chunk` of a workspace. This second pass adds the slots in chunk
// order, one thread per output, so every sum has the same order in every
// run: with the chunk count a function of the shapes and the card alone,
// two runs give the same bits. With one chunk the first pass writes the
// outputs itself and this pass does not run.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

__global__ void __launch_bounds__(256) reduce_chunks_kernel(
    const float* __restrict__ ws_counts, const float* __restrict__ ws_sums,
    const float* __restrict__ ws_sumsq, float* __restrict__ counts, float* __restrict__ sums,
    float* __restrict__ sumsq, int chunks, int nb, int d) {
  const size_t per = static_cast<size_t>(nb) * d;
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < per) {
    float s = 0.f, q = 0.f;
    for (int c = 0; c < chunks; ++c) {
      s += ws_sums[c * per + i];
      q += ws_sumsq[c * per + i];
    }
    sums[i] = s;
    sumsq[i] = q;
  }
  if (i < static_cast<size_t>(nb)) {
    float n = 0.f;
    for (int c = 0; c < chunks; ++c) n += ws_counts[static_cast<size_t>(c) * nb + i];
    counts[i] = n;
  }
}

// Rows of each chunk: chunk c covers [c * rows, min(n, (c + 1) * rows)).
inline int rows_per_chunk(int n, int chunks) { return (n + chunks - 1) / chunks; }

inline int launch_reduce_chunks(const float* ws_counts, const float* ws_sums,
                                const float* ws_sumsq, float* counts, float* sums, float* sumsq,
                                int chunks, int nb, int d, cudaStream_t stream) {
  // one thread per [nb, d] output; the first nb threads also add the counts
  // (d >= 1, so nb * d >= nb)
  const unsigned blocks = static_cast<unsigned>((static_cast<size_t>(nb) * d + 255) / 256);
  reduce_chunks_kernel<<<blocks, 256, 0, stream>>>(ws_counts, ws_sums, ws_sumsq, counts, sums,
                                                   sumsq, chunks, nb, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
