// Token dispatch and combine of the expert-parallel DeepSeekMoE layer
// (models/deepseek_v2.py MoELayer), forward and backward, for NVIDIA Hopper
// (sm_90a), bound with ctypes.
//
// It replaces no TPU kernel: the JAX package has no mixture of experts. A
// chip of an expert-parallel deployment holds experts [lo, lo + E) of the
// router's 64; each token's top-K choices (K = 6) that fall among them are
// its held slots. The layer's expert products run as one grouped product
// over the held experts' rows in expert order (torch._grouped_mm), so the
// rows have to be sorted into that order first and the products' rows
// weighted and summed back per token after. Two constraints shape the
// design: the port replays each step as a CUDA graph, so nothing may read a
// count back to the host (every buffer is sized to the worst case, T x
// min(K, E) rows, and the per-expert offsets stay on the device), and graphed
// steps are held bit-equal to eager ones, so no sum may use atomics.
//
// Kernels (T tokens, K slots a token, D features):
// - moe_route_kernel: one block; a stable counting sort of the T x K slots by
//   held expert (slot order within an expert), written as each slot's row
//   pos[t, j] (-1 where the expert is not held) and the end of each expert's
//   rows offs[e]; adds each expert's rows and the tokens with a held slot to
//   the layer's device counters. The slots' held experts are read once,
//   coalesced, into shared memory (a byte a slot: 61,440 at the STS-B
//   cell), then each thread walks a contiguous run of them once a held
//   expert, between E block-wide scans. Latency-bound.
// - moe_gather_kernel: a block a token copies its row of x once to each of
//   its held rows. Bytes: the touched tokens' rows in, the held rows out.
// - moe_combine_fwd_kernel: out[t] = sum over held j in slot order of
//   w[t, j] * y[pos[t, j]], in float32. Bytes: the held rows of y in, [T, D]
//   float32 out.
// - moe_combine_bwd_kernel: dy[pos[t, j]] = w[t, j] * dout[t] (one to one:
//   each held row has one slot) and dw[t, j] = dout[t] . y[pos[t, j]], a
//   fixed reduction tree a slot. Bytes: dout and the held rows of y in, the
//   held rows of dy out.
// - moe_dispatch_bwd_kernel: dx[t] = sum over held j in slot order of
//   dxs[pos[t, j]], in float32 (a gather, so no atomics). Bytes: the held rows
//   of dxs in, [T, D] out.
// The row kernels are bound by bytes: one 16-byte access a thread (V values
// of T), 128 threads a token walking its row, the token's slots and weights
// staged in shared memory; V = 1 where D or a pointer does not allow it.
// Rows of xs, y and dy past the held ones (offs[E - 1] on) are never written
// or read here; the grouped product leaves them alone too.
//
// Numerics, shared with the plain versions (ops/moe_dispatch.py): the
// combine's products and sums are unfused (__fmul_rn, __fadd_rn) in slot
// order, as ATen's ``acc + w * y`` loop runs them; the dispatch backward sums
// in slot order. Each entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() (0 on success).

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRouteThreads = 1024;
constexpr int kRowThreads = 128;
constexpr int kMaxK = 16;  // slots a token (moe_max_k in ops/cuda_kernels.py)
// slots of one route (a byte each in shared memory; MOE_MAX_SLOTS in
// ops/cuda_kernels.py), and held experts (a signed byte each)
constexpr int kMaxRouteSlots = 200 * 1024;
constexpr int kMaxHeld = 127;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&o)[V]) {
  const Pack<T, V> k = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int u = 0; u < V; ++u) o[u] = to_float(k.v[u]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&o)[V]) {
  Pack<T, V> k;
#pragma unroll
  for (int u = 0; u < V; ++u) k.v[u] = from_float<T>(o[u]);
  *reinterpret_cast<Pack<T, V>*>(p) = k;
}

__device__ __forceinline__ int held_expert(const int64_t* idx, int s, int lo, int held) {
  const int64_t e = idx[s] - lo;
  return (e >= 0 && e < held) ? static_cast<int>(e) : -1;
}

__global__ void __launch_bounds__(kRouteThreads)
moe_route_kernel(const int64_t* __restrict__ idx, int slots, int k, int lo, int held,
                 int* __restrict__ pos, int* __restrict__ offs, long long* __restrict__ rows,
                 long long* __restrict__ touched) {
  using Scan = cub::BlockScan<int, kRouteThreads>;
  using Reduce = cub::BlockReduce<int, kRouteThreads>;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;
  extern __shared__ signed char key[];  // each slot's held expert, -1 where none
  for (int s = threadIdx.x; s < slots; s += kRouteThreads)
    key[s] = static_cast<signed char>(held_expert(idx, s, lo, held));
  __syncthreads();
  // a contiguous run of slots a thread, so that the scan over threads keeps
  // the slot order
  const int per = (slots + kRouteThreads - 1) / kRouteThreads;
  const int begin = min(slots, static_cast<int>(threadIdx.x) * per);
  const int end = min(slots, begin + per);
  int first = 0;  // slots that are their token's first held slot
  for (int s = begin; s < end; ++s) {
    if (key[s] < 0) {
      pos[s] = -1;
      continue;
    }
    bool earlier = false;
    for (int r = s - s % k; r < s; ++r) earlier |= key[r] >= 0;
    first += !earlier;
  }
  const int tokens = Reduce(tmp.reduce).Sum(first);
  if (threadIdx.x == 0) *touched += tokens;
  int base = 0;
  for (int e = 0; e < held; ++e) {
    int count = 0;
    for (int s = begin; s < end; ++s) count += key[s] == e;
    int row, total;
    __syncthreads();  // tmp is reused
    Scan(tmp.scan).ExclusiveSum(count, row, total);
    row += base;
    if (count)
      for (int s = begin; s < end; ++s)
        if (key[s] == e) pos[s] = row++;
    base += total;
    if (threadIdx.x == 0) {
      offs[e] = base;
      rows[e] += total;
    }
  }
}

// the token's held rows (and weights) into shared memory; false where it
// has none
template <bool kWeights>
__device__ __forceinline__ bool stage_slots(const int* __restrict__ pos, const float* __restrict__ w,
                                            int t, int k, int* sp, float* sw) {
  __shared__ int any;
  if (threadIdx.x == 0) any = 0;
  __syncthreads();
  if (threadIdx.x < k) {
    const int p = pos[static_cast<int64_t>(t) * k + threadIdx.x];
    sp[threadIdx.x] = p;
    if (kWeights) sw[threadIdx.x] = w[static_cast<int64_t>(t) * k + threadIdx.x];
    if (p >= 0) any = 1;
  }
  __syncthreads();
  return any != 0;
}

template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
moe_gather_kernel(const T* __restrict__ x, const int* __restrict__ pos, T* __restrict__ xs, int k,
                  int d) {
  __shared__ int sp[kMaxK];
  const int t = blockIdx.x;
  if (!stage_slots<false>(pos, nullptr, t, k, sp, nullptr)) return;
  for (int c = threadIdx.x * V; c < d; c += kRowThreads * V) {
    const Pack<T, V> v = *reinterpret_cast<const Pack<T, V>*>(x + static_cast<int64_t>(t) * d + c);
    for (int j = 0; j < k; ++j)
      if (sp[j] >= 0) *reinterpret_cast<Pack<T, V>*>(xs + static_cast<int64_t>(sp[j]) * d + c) = v;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
moe_combine_fwd_kernel(const T* __restrict__ y, const float* __restrict__ w,
                       const int* __restrict__ pos, float* __restrict__ out, int k, int d) {
  __shared__ int sp[kMaxK];
  __shared__ float sw[kMaxK];
  const int t = blockIdx.x;
  stage_slots<true>(pos, w, t, k, sp, sw);
  for (int c = threadIdx.x * V; c < d; c += kRowThreads * V) {
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    for (int j = 0; j < k; ++j) {
      if (sp[j] < 0) continue;
      float v[V];
      load<T, V>(y + static_cast<int64_t>(sp[j]) * d + c, v);
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = __fadd_rn(acc[u], __fmul_rn(sw[j], v[u]));
    }
    store<float, V>(out + static_cast<int64_t>(t) * d + c, acc);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
moe_combine_bwd_kernel(const float* __restrict__ dout, const T* __restrict__ y,
                       const float* __restrict__ w, const int* __restrict__ pos,
                       T* __restrict__ dy, float* __restrict__ dw, int k, int d) {
  using Reduce = cub::BlockReduce<float, kRowThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  __shared__ int sp[kMaxK];
  __shared__ float sw[kMaxK];
  const int t = blockIdx.x;
  stage_slots<true>(pos, w, t, k, sp, sw);
  float part[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) part[j] = 0.f;
  for (int c = threadIdx.x * V; c < d; c += kRowThreads * V) {
    float g[V];
    load<float, V>(dout + static_cast<int64_t>(t) * d + c, g);
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j >= k || sp[j] < 0) continue;
      const int64_t row = static_cast<int64_t>(sp[j]) * d + c;
      float v[V], out[V];
      load<T, V>(y + row, v);
#pragma unroll
      for (int u = 0; u < V; ++u) {
        part[j] = __fadd_rn(part[j], __fmul_rn(g[u], v[u]));
        out[u] = __fmul_rn(sw[j], g[u]);
      }
      store<T, V>(dy + row, out);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j >= k) break;
    __syncthreads();  // tmp is reused
    const float sum = Reduce(tmp).Sum(part[j]);
    if (threadIdx.x == 0) dw[static_cast<int64_t>(t) * k + j] = sp[j] >= 0 ? sum : 0.f;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kRowThreads)
moe_dispatch_bwd_kernel(const T* __restrict__ dxs, const int* __restrict__ pos,
                        T* __restrict__ dx, int k, int d) {
  __shared__ int sp[kMaxK];
  const int t = blockIdx.x;
  stage_slots<false>(pos, nullptr, t, k, sp, nullptr);
  for (int c = threadIdx.x * V; c < d; c += kRowThreads * V) {
    float acc[V];
#pragma unroll
    for (int u = 0; u < V; ++u) acc[u] = 0.f;
    for (int j = 0; j < k; ++j) {
      if (sp[j] < 0) continue;
      float v[V];
      load<T, V>(dxs + static_cast<int64_t>(sp[j]) * d + c, v);
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = __fadd_rn(acc[u], v[u]);
    }
    store<T, V>(dx + static_cast<int64_t>(t) * d + c, acc);
  }
}

template <typename T>
int launch_gather(const void* x, const int* pos, void* xs, int vec, int tokens, int k, int d,
                  cudaStream_t s) {
  const T* a = static_cast<const T*>(x);
  T* b = static_cast<T*>(xs);
  constexpr int V = 16 / sizeof(T);
  if (vec)
    moe_gather_kernel<T, V><<<tokens, kRowThreads, 0, s>>>(a, pos, b, k, d);
  else
    moe_gather_kernel<T, 1><<<tokens, kRowThreads, 0, s>>>(a, pos, b, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine_fwd(const void* y, const float* w, const int* pos, float* out, int vec,
                       int tokens, int k, int d, cudaStream_t s) {
  const T* a = static_cast<const T*>(y);
  constexpr int V = 16 / sizeof(T);
  if (vec)
    moe_combine_fwd_kernel<T, V><<<tokens, kRowThreads, 0, s>>>(a, w, pos, out, k, d);
  else
    moe_combine_fwd_kernel<T, 1><<<tokens, kRowThreads, 0, s>>>(a, w, pos, out, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_combine_bwd(const float* dout, const void* y, const float* w, const int* pos, void* dy,
                       float* dw, int vec, int tokens, int k, int d, cudaStream_t s) {
  const T* a = static_cast<const T*>(y);
  T* b = static_cast<T*>(dy);
  constexpr int V = 16 / sizeof(T);
  if (vec)
    moe_combine_bwd_kernel<T, V><<<tokens, kRowThreads, 0, s>>>(dout, a, w, pos, b, dw, k, d);
  else
    moe_combine_bwd_kernel<T, 1><<<tokens, kRowThreads, 0, s>>>(dout, a, w, pos, b, dw, k, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dispatch_bwd(const void* dxs, const int* pos, void* dx, int vec, int tokens, int k,
                        int d, cudaStream_t s) {
  const T* a = static_cast<const T*>(dxs);
  T* b = static_cast<T*>(dx);
  constexpr int V = 16 / sizeof(T);
  if (vec)
    moe_dispatch_bwd_kernel<T, V><<<tokens, kRowThreads, 0, s>>>(a, pos, b, k, d);
  else
    moe_dispatch_bwd_kernel<T, 1><<<tokens, kRowThreads, 0, s>>>(a, pos, b, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int moe_max_k() { return kMaxK; }

// The route (one block) then the gather of x's rows into xs. idx: [tokens, k]
// int64 expert ids of the router's top-k; rows [held] and touched [1]: the
// layer's int64 counters, added to. bf16: x and xs are bf16 (else float32);
// vec: 16-byte accesses (D and every row pointer allow them), else one value
// a thread.
int moe_dispatch_fwd(const void* x, const int64_t* idx, int* pos, int* offs, void* xs,
                     long long* rows, long long* touched, int bf16, int vec, int tokens, int k,
                     int d, int lo, int held, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slots = tokens * k;
  if (slots > kMaxRouteSlots || held > kMaxHeld) return static_cast<int>(cudaErrorInvalidValue);
  if (slots > 48 * 1024)
    cudaFuncSetAttribute(moe_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, slots);
  moe_route_kernel<<<1, kRouteThreads, slots, s>>>(idx, slots, k, lo, held, pos, offs, rows,
                                                   touched);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (bf16) return launch_gather<__nv_bfloat16>(x, pos, xs, vec, tokens, k, d, s);
  return launch_gather<float>(x, pos, xs, vec, tokens, k, d, s);
}

int moe_dispatch_bwd(const void* dxs, const int* pos, void* dx, int bf16, int vec, int tokens,
                     int k, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_dispatch_bwd<__nv_bfloat16>(dxs, pos, dx, vec, tokens, k, d, s);
  return launch_dispatch_bwd<float>(dxs, pos, dx, vec, tokens, k, d, s);
}

int moe_combine_fwd(const void* y, const float* w, const int* pos, float* out, int bf16, int vec,
                    int tokens, int k, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_combine_fwd<__nv_bfloat16>(y, w, pos, out, vec, tokens, k, d, s);
  return launch_combine_fwd<float>(y, w, pos, out, vec, tokens, k, d, s);
}

int moe_combine_bwd(const float* dout, const void* y, const float* w, const int* pos, void* dy,
                    float* dw, int bf16, int vec, int tokens, int k, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_combine_bwd<__nv_bfloat16>(dout, y, w, pos, dy, dw, vec, tokens, k, d, s);
  return launch_combine_bwd<float>(dout, y, w, pos, dy, dw, vec, tokens, k, d, s);
}

}  // extern "C"
