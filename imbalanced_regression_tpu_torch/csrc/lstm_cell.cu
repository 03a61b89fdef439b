// The LSTM cell of the STS-B BiLSTM (models/bilstm_pair.py FusedLSTMLayer),
// forward and backward, for NVIDIA Hopper (sm_90a), bound with ctypes.
//
// It replaces no TPU kernel: the JAX package leaves the cell to XLA, which
// fuses it into the scan's loop body. Run eagerly, the same cell was about
// 13 kernels a time step forward and 20 backward (casts, a bf16 add, a
// chunk, three sigmoids, two tanh, the products and sums of the update),
// each reading and writing whole [2B, 4H] or [2B, H] float32 slices. One
// kernel a step does that work in registers and touches each operand once.
//
// Bound by bytes (about one flop a byte): at the STS-B cell's 512 rows x
// H = 1500 the forward reads xw_t and hw (bf16, 6 MB each) and c_{t-1}
// (float32, 3 MB) and writes c_t, h_t (float32) and h_t in bf16 for the
// next product, and with grad on the bf16 gates: ~29 MB, 8.7 us at
// 3.35 TB/s. The backward reads the gates, c_{t-1}, c_t, dh_t, the
// recurrent dh and dc_{t+1} and writes d_gates (bf16) and dc_t: ~31 MB.
// Design: one thread owns V = 4 hidden units of one row (one 8-byte bf16
// or 16-byte float32 load a gate; V = 1 where H % 4 != 0 or a pointer is
// not 16-byte aligned), every load issued before the first use, no shared
// memory; 512 rows x 375 unit groups = 750 blocks of 256 threads.
//
// Numerics, shared with the plain version (ops/lstm_cell.py): the gate
// pre-activations are xw_t + hw summed in the module type T (rounded to
// bf16 at full width) and taken to float32, gate order i, f, g, o; the
// forward's update runs unfused (__fmul_rn, __fadd_rn) with IEEE expf and
// tanhf, in ATen's order: c = sigmoid(f) * c + sigmoid(i) * tanh(g), h =
// sigmoid(o) * tanh(c), sigmoid(x) = 1 / (1 + exp(-x)). The saved gates are
// those pre-activations in T, exact, so the backward recomputes the
// nonlinearities in float32 as the forward had them.
//
// Layouts: xw, gates, d_gates [rows, steps, 4H] (T); c_all, hs, dhs [rows,
// steps, H] (float32); hprev [rows, steps, H] (T), where hprev[:, t] is the
// state h_{t-1} that step t multiplies (hprev[:, 0] = 0, written at t = 0);
// hw, dh_rec [rows, 4H] / [rows, H] (T); dc [rows, H] (float32, updated in
// place). Each entry point launches on the caller's stream, allocates
// nothing and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// V consecutive values of T, loaded or stored as one access (V * sizeof(T)
// bytes, which the caller aligns).
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

// ATen's sigmoid for float32: 1 / (1 + exp(-x)), IEEE division.
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
lstm_cell_fwd_kernel(const T* __restrict__ xw, const T* __restrict__ hw,
                     float* __restrict__ c_all, float* __restrict__ hs, T* __restrict__ hprev,
                     T* __restrict__ gates, int rows, int steps, int hid, int t) {
  const int groups = hid / V;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * groups) return;
  const int r = static_cast<int>(idx / groups);
  const int j = static_cast<int>(idx % groups) * V;
  const int64_t row_t = static_cast<int64_t>(r) * steps + t;  // (r, t) in [rows, steps]
  const int64_t g_off = row_t * 4 * hid + j;
  const int64_t s_off = row_t * hid + j;

  float a[4][V], cp[V];
#pragma unroll
  for (int k = 0; k < 4; ++k) load<T, V>(xw + g_off + k * hid, a[k]);
  if (t > 0) {
    float b[4][V];
#pragma unroll
    for (int k = 0; k < 4; ++k) load<T, V>(hw + (static_cast<int64_t>(r) * 4 + k) * hid + j, b[k]);
    load<float, V>(c_all + s_off - hid, cp);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int u = 0; u < V; ++u) a[k][u] = to_float(from_float<T>(__fadd_rn(a[k][u], b[k][u])));
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) cp[u] = 0.f;
  }
  if (gates != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) store<T, V>(gates + g_off + k * hid, a[k]);
  }
  float c[V], h[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float ig = __fmul_rn(sigmoid(a[0][u]), tanhf(a[2][u]));
    c[u] = __fadd_rn(__fmul_rn(sigmoid(a[1][u]), cp[u]), ig);
    h[u] = __fmul_rn(sigmoid(a[3][u]), tanhf(c[u]));
  }
  store<float, V>(c_all + s_off, c);
  store<float, V>(hs + s_off, h);
  if (t + 1 < steps) store<T, V>(hprev + s_off + hid, h);
  if (t == 0) {
    float zero[V];
#pragma unroll
    for (int u = 0; u < V; ++u) zero[u] = 0.f;
    store<T, V>(hprev + s_off, zero);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
lstm_cell_bwd_kernel(const T* __restrict__ gates, const float* __restrict__ c_all,
                     const float* __restrict__ dhs, const T* __restrict__ dh_rec,
                     float* __restrict__ dc, T* __restrict__ dg, int rows, int steps, int hid,
                     int t) {
  const int groups = hid / V;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(rows) * groups) return;
  const int r = static_cast<int>(idx / groups);
  const int j = static_cast<int>(idx % groups) * V;
  const int64_t row_t = static_cast<int64_t>(r) * steps + t;
  const int64_t g_off = row_t * 4 * hid + j;
  const int64_t s_off = row_t * hid + j;
  const int64_t carry = static_cast<int64_t>(r) * hid + j;  // in dh_rec and dc
  const bool last = t == steps - 1;

  float a[4][V], c[V], cp[V], dh[V], dcn[V];
#pragma unroll
  for (int k = 0; k < 4; ++k) load<T, V>(gates + g_off + k * hid, a[k]);
  load<float, V>(c_all + s_off, c);
  load<float, V>(dhs + s_off, dh);
  if (t > 0) {
    load<float, V>(c_all + s_off - hid, cp);
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) cp[u] = 0.f;
  }
  if (!last) {
    float rec[V];
    load<T, V>(dh_rec + carry, rec);
    load<float, V>(dc + carry, dcn);
#pragma unroll
    for (int u = 0; u < V; ++u) dh[u] += rec[u];
  } else {
#pragma unroll
    for (int u = 0; u < V; ++u) dcn[u] = 0.f;
  }
  float d[4][V], dc_out[V];
#pragma unroll
  for (int u = 0; u < V; ++u) {
    const float i = sigmoid(a[0][u]), f = sigmoid(a[1][u]), g = tanhf(a[2][u]);
    const float o = sigmoid(a[3][u]), tc = tanhf(c[u]);
    const float dcu = dcn[u] + dh[u] * o * (1.f - tc * tc);
    d[0][u] = dcu * g * i * (1.f - i);
    d[1][u] = dcu * cp[u] * f * (1.f - f);
    d[2][u] = dcu * i * (1.f - g * g);
    d[3][u] = dh[u] * tc * o * (1.f - o);
    dc_out[u] = dcu * f;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) store<T, V>(dg + g_off + k * hid, d[k]);
  store<float, V>(dc + carry, dc_out);
}

inline dim3 grid_of(int rows, int hid, int v) {
  const int64_t threads = static_cast<int64_t>(rows) * (hid / v);
  return dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
}

template <typename T>
int launch_fwd(const void* xw, const void* hw, float* c_all, float* hs, void* hprev, void* gates,
               int vec, int rows, int steps, int hid, int t, cudaStream_t s) {
  const T* x = static_cast<const T*>(xw);
  const T* w = static_cast<const T*>(hw);
  T* hp = static_cast<T*>(hprev);
  T* gs = static_cast<T*>(gates);
  if (vec)
    lstm_cell_fwd_kernel<T, 4><<<grid_of(rows, hid, 4), kThreads, 0, s>>>(
        x, w, c_all, hs, hp, gs, rows, steps, hid, t);
  else
    lstm_cell_fwd_kernel<T, 1><<<grid_of(rows, hid, 1), kThreads, 0, s>>>(
        x, w, c_all, hs, hp, gs, rows, steps, hid, t);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* gates, const float* c_all, const float* dhs, const void* dh_rec,
               float* dc, void* dg, int vec, int rows, int steps, int hid, int t, cudaStream_t s) {
  const T* gs = static_cast<const T*>(gates);
  const T* rec = static_cast<const T*>(dh_rec);
  T* d = static_cast<T*>(dg);
  if (vec)
    lstm_cell_bwd_kernel<T, 4><<<grid_of(rows, hid, 4), kThreads, 0, s>>>(
        gs, c_all, dhs, rec, dc, d, rows, steps, hid, t);
  else
    lstm_cell_bwd_kernel<T, 1><<<grid_of(rows, hid, 1), kThreads, 0, s>>>(
        gs, c_all, dhs, rec, dc, d, rows, steps, hid, t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Step t of the forward. bf16: T is bf16 (else float32); vec: 4 units a
// thread (H % 4 == 0, every pointer 16-byte aligned), else 1. hw is read
// for t > 0 only; gates may be null (no grad: nothing saved).
int lstm_cell_fwd(const void* xw, const void* hw, float* c_all, float* hs, void* hprev,
                  void* gates, int bf16, int vec, int rows, int steps, int hid, int t,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_fwd<__nv_bfloat16>(xw, hw, c_all, hs, hprev, gates, vec, rows, steps, hid, t, s);
  return launch_fwd<float>(xw, hw, c_all, hs, hprev, gates, vec, rows, steps, hid, t, s);
}

// Step t of the backward, t from steps - 1 down to 0. dh_rec and dc are
// read for t < steps - 1 only; dc is written at every t.
int lstm_cell_bwd(const void* gates, const float* c_all, const float* dhs, const void* dh_rec,
                  float* dc, void* dg, int bf16, int vec, int rows, int steps, int hid, int t,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_bwd<__nv_bfloat16>(gates, c_all, dhs, dh_rec, dc, dg, vec, rows, steps, hid, t, s);
  return launch_bwd<float>(gates, c_all, dhs, dh_rec, dc, dg, vec, rows, steps, hid, t, s);
}

}  // extern "C"
