// Fine-level Wilson--Dirac 9-point stencil kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:
//   K1 stencil_matvec   <- _stencil_kernel  (y = D v)
//   K2 stencil_residual <- _residual_kernel (r = b - D x, one pass)
//   K3 poly_step        <- _poly_kernel     (one root of x = p(D) r)
//
// Layout: complex tensors are interleaved (float2 / double2). Coefficients
// C[a, b, k, x, t] have shape (2, 2, 5, X, T); vectors v[p, s, x, t] have
// shape (B, 2, X, T), all C-contiguous. Taps k = 0..4 are the offsets
// (dx, dt) = (0,0), (0,+1), (0,-1), (+1,0), (-1,0) with periodic wrap, and
// out[i] reads v[(i + d) % n]. The on-site cross-spin coefficient is
// structurally zero, so a site needs 18 complex multiply-adds per probe.
//
// Bound: device-memory bandwidth. Per probe and site the kernel moves two
// complex inputs and two complex outputs and does 18 complex MACs (about
// 4.5 flop per byte in complex64), far below the card's ridge point. The
// design therefore minimises bytes: one thread owns one (x, t) site for
// both output spins, loads the site's 18 coefficients into registers once
// and reuses them for a chunk of probes (blockIdx.y), so coefficient
// traffic is amortised over the chunk. Threads of a warp own consecutive t,
// so every tap's load is coalesced; the neighbour re-reads of a row hit L1/L2
// instead of device memory. Wrap-around is index arithmetic, so any X, T is
// accepted. The kernels allocate nothing and launch on the caller's stream.
//
// K3 cannot keep a probe on chip across all roots the way the TPU kernel
// keeps it in VMEM (one 256^2 complex64 probe is 1 MB), so it is one fused
// launch per root: read cur (with neighbours) and x, write x += cur/theta and
// cur' = cur - D(cur/theta) into a second buffer (an in-place update would
// let a neighbour read a half-updated value).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProbeChunk = 8;

template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  V r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}

template <typename V>
__device__ __forceinline__ void cmac(V& acc, V a, V b) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
}

template <typename V>
__device__ __forceinline__ V czero() {
  V r;
  r.x = 0;
  r.y = 0;
  return r;
}

__device__ __forceinline__ constexpr bool tap_used(int a, int b, int k) {
  return !(a != b && k == 0);
}

template <typename V>
__device__ __forceinline__ void load_coeffs(const V* __restrict__ C,
                                            long long site, long long XT,
                                            V c[2][2][5]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int k = 0; k < 5; ++k)
        c[a][b][k] = tap_used(a, b, k) ? C[((a * 2 + b) * 5 + k) * XT + site]
                                       : czero<V>();
}

// Offsets within one spin plane of the five taps read by site (x, t).
__device__ __forceinline__ void tap_offsets(long long site, int X, int T,
                                            long long o[5]) {
  const int x = static_cast<int>(site / T);
  const int t = static_cast<int>(site - static_cast<long long>(x) * T);
  const int tp = (t + 1 == T) ? 0 : t + 1;
  const int tm = (t == 0) ? T - 1 : t - 1;
  const int xp = (x + 1 == X) ? 0 : x + 1;
  const int xm = (x == 0) ? X - 1 : x - 1;
  o[0] = site;
  o[1] = static_cast<long long>(x) * T + tp;
  o[2] = static_cast<long long>(x) * T + tm;
  o[3] = static_cast<long long>(xp) * T + t;
  o[4] = static_cast<long long>(xm) * T + t;
}

// y[a] = sum_{b, k} c[a][b][k] * (s * v[b][o_k]) for one probe; with
// kScaled = false the scale s is not applied.
template <typename V, bool kScaled>
__device__ __forceinline__ void apply_site(const V c[2][2][5],
                                           const V* __restrict__ v,
                                           long long XT, const long long o[5],
                                           V s, V y[2]) {
  V w[2][5];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const V val = v[b * XT + o[k]];
      w[b][k] = kScaled ? cmul(s, val) : val;
    }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    V acc = czero<V>();
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (tap_used(a, b, k)) cmac(acc, c[a][b][k], w[b][k]);
    y[a] = acc;
  }
}

// K1: y = D v.
template <typename V>
__global__ void __launch_bounds__(kThreads)
stencil_matvec_kernel(const V* __restrict__ C, const V* __restrict__ v,
                      V* __restrict__ y, int B, int X, int T) {
  const long long XT = static_cast<long long>(X) * T;
  const long long site = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (site >= XT) return;
  V c[2][2][5];
  load_coeffs(C, site, XT, c);
  long long o[5];
  tap_offsets(site, X, T, o);
  const int p0 = blockIdx.y * kProbeChunk;
  const int p1 = min(B, p0 + kProbeChunk);
  for (int p = p0; p < p1; ++p) {
    const long long base = static_cast<long long>(p) * 2 * XT;
    V out[2];
    apply_site<V, false>(c, v + base, XT, o, czero<V>(), out);
    y[base + site] = out[0];
    y[base + XT + site] = out[1];
  }
}

// K2: r = b - D x.
template <typename V>
__global__ void __launch_bounds__(kThreads)
stencil_residual_kernel(const V* __restrict__ C, const V* __restrict__ b,
                        const V* __restrict__ x, V* __restrict__ r, int B,
                        int X, int T) {
  const long long XT = static_cast<long long>(X) * T;
  const long long site = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (site >= XT) return;
  V c[2][2][5];
  load_coeffs(C, site, XT, c);
  long long o[5];
  tap_offsets(site, X, T, o);
  const int p0 = blockIdx.y * kProbeChunk;
  const int p1 = min(B, p0 + kProbeChunk);
  for (int p = p0; p < p1; ++p) {
    const long long base = static_cast<long long>(p) * 2 * XT;
    V out[2];
    apply_site<V, false>(c, x + base, XT, o, czero<V>(), out);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const V bv = b[base + s * XT + site];
      V rv;
      rv.x = bv.x - out[s].x;
      rv.y = bv.y - out[s].y;
      r[base + s * XT + site] = rv;
    }
  }
}

// K3, one root theta: step = cur * inv (inv = 1/theta); x = step when
// `first`, else x += step; with kApply, cur_out = cur - D step.
template <typename V, bool kApply>
__global__ void __launch_bounds__(kThreads)
poly_step_kernel(const V* __restrict__ C, const V* __restrict__ cur,
                 V* __restrict__ x, V* __restrict__ cur_out, V inv, int first,
                 int B, int X, int T) {
  const long long XT = static_cast<long long>(X) * T;
  const long long site = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (site >= XT) return;
  V c[2][2][5];
  long long o[5];
  if (kApply) {
    load_coeffs(C, site, XT, c);
    tap_offsets(site, X, T, o);
  }
  const int p0 = blockIdx.y * kProbeChunk;
  const int p1 = min(B, p0 + kProbeChunk);
  for (int p = p0; p < p1; ++p) {
    const long long base = static_cast<long long>(p) * 2 * XT;
    V cur_site[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      cur_site[s] = cur[base + s * XT + site];
      const V step = cmul(inv, cur_site[s]);
      V xv = step;
      if (!first) {
        const V old = x[base + s * XT + site];
        xv.x = old.x + step.x;
        xv.y = old.y + step.y;
      }
      x[base + s * XT + site] = xv;
    }
    if (kApply) {
      V out[2];
      apply_site<V, true>(c, cur + base, XT, o, inv, out);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        V nv;
        nv.x = cur_site[s].x - out[s].x;
        nv.y = cur_site[s].y - out[s].y;
        cur_out[base + s * XT + site] = nv;
      }
    }
  }
}

dim3 grid_for(int B, int X, int T) {
  const long long XT = static_cast<long long>(X) * T;
  return dim3(static_cast<unsigned>((XT + kThreads - 1) / kThreads),
              static_cast<unsigned>((B + kProbeChunk - 1) / kProbeChunk));
}

bool empty(int B, int X, int T) { return B <= 0 || X <= 0 || T <= 0; }

template <typename V>
int launch_matvec(const void* C, const void* v, void* y, int B, int X, int T,
                  void* stream) {
  if (empty(B, X, T)) return 0;
  stencil_matvec_kernel<V><<<grid_for(B, X, T), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(C), static_cast<const V*>(v), static_cast<V*>(y),
      B, X, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_residual(const void* C, const void* b, const void* x, void* r,
                    int B, int X, int T, void* stream) {
  if (empty(B, X, T)) return 0;
  stencil_residual_kernel<V><<<grid_for(B, X, T), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(C), static_cast<const V*>(b),
      static_cast<const V*>(x), static_cast<V*>(r), B, X, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_poly_step(const void* C, const void* cur, void* x, void* cur_out,
                     double inv_re, double inv_im, int first, int apply,
                     int B, int X, int T, void* stream) {
  if (empty(B, X, T)) return 0;
  V inv;
  inv.x = static_cast<decltype(inv.x)>(inv_re);
  inv.y = static_cast<decltype(inv.y)>(inv_im);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (apply) {
    poly_step_kernel<V, true><<<grid_for(B, X, T), kThreads, 0, s>>>(
        static_cast<const V*>(C), static_cast<const V*>(cur),
        static_cast<V*>(x), static_cast<V*>(cur_out), inv, first, B, X, T);
  } else {
    poly_step_kernel<V, false><<<grid_for(B, X, T), kThreads, 0, s>>>(
        static_cast<const V*>(C), static_cast<const V*>(cur),
        static_cast<V*>(x), static_cast<V*>(cur_out), inv, first, B, X, T);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() after its launch (0 = success).
extern "C" {

int dmlmc_stencil_matvec_c64(const void* C, const void* v, void* y, int B,
                             int X, int T, void* stream) {
  return launch_matvec<float2>(C, v, y, B, X, T, stream);
}

int dmlmc_stencil_matvec_c128(const void* C, const void* v, void* y, int B,
                              int X, int T, void* stream) {
  return launch_matvec<double2>(C, v, y, B, X, T, stream);
}

int dmlmc_stencil_residual_c64(const void* C, const void* b, const void* x,
                               void* r, int B, int X, int T, void* stream) {
  return launch_residual<float2>(C, b, x, r, B, X, T, stream);
}

int dmlmc_stencil_residual_c128(const void* C, const void* b, const void* x,
                                void* r, int B, int X, int T, void* stream) {
  return launch_residual<double2>(C, b, x, r, B, X, T, stream);
}

int dmlmc_stencil_poly_step_c64(const void* C, const void* cur, void* x,
                                void* cur_out, double inv_re, double inv_im,
                                int first, int apply, int B, int X, int T,
                                void* stream) {
  return launch_poly_step<float2>(C, cur, x, cur_out, inv_re, inv_im, first,
                                  apply, B, X, T, stream);
}

int dmlmc_stencil_poly_step_c128(const void* C, const void* cur, void* x,
                                 void* cur_out, double inv_re, double inv_im,
                                 int first, int apply, int B, int X, int T,
                                 void* stream) {
  return launch_poly_step<double2>(C, cur, x, cur_out, inv_re, inv_im, first,
                                   apply, B, X, T, stream);
}

}  // extern "C"
