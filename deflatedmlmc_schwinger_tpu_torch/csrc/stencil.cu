// Fine-level Wilson--Dirac 9-point stencil kernels for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of
// deflatedmlmc_schwinger_tpu/ops/pallas_stencil.py:
//   K1 stencil_matvec   <- _stencil_kernel  (y = D v)
//   K2 stencil_residual <- _residual_kernel (r = b - D x, one pass)
//      both by stencil_rows_kernel (row-staged tiles, below); the first
//      kernels, one thread per site (stencil_*_per_site_kernel), are kept
//      as the yardsticks the row kernel is timed against, on no path
//   K3 poly_tiled       <- _poly_kernel     (up to kMaxFuse roots of
//                                            x = p(D) r per launch)
//      poly_step        the earlier K3, one launch per root; kept as the
//                       yardstick the tiled kernel is timed against
// and, on the coarse levels, which have no TPU kernel:
//   K4 coarse_bsr       block-sparse block stencil: y = A v, r = b - A x and
//                       one root of the polynomial smoother per launch
//                       (section "K4" below)
//
// Layout: complex tensors are interleaved (float2 / double2). Coefficients
// C[a, b, k, x, t] have shape (2, 2, 5, X, T); vectors v[p, s, x, t] have
// shape (B, 2, X, T), all C-contiguous. Taps k = 0..4 are the offsets
// (dx, dt) = (0,0), (0,+1), (0,-1), (+1,0), (-1,0) with periodic wrap, and
// out[i] reads v[(i + d) % n]. The on-site cross-spin coefficient is
// structurally zero, so a site needs 18 complex multiply-adds per probe.
//
// Bounds (each input read once, each output written once, against the
// card's device-memory rate and its float32 rate outside the tensor cores;
// the coefficients differ per site, so this is no matrix product):
//
// K1, K2: device-memory bandwidth. Per probe and site they move two or
// three complex pairs and do 18 complex MACs, about 4.5 flop per byte in
// complex64, far below the ridge; the bound is (probe blocks moved x B + 18
// coefficient fields) x sites x itemsize / 3.35 TB/s. So the design moves
// each byte once and keeps copies in flight. stencil_rows_kernel: a block
// owns a tile of R whole lattice rows (x0 .. x0+R-1, all T sites; a lattice
// too wide for that is cut into column tiles of W sites) for a chunk of
// probes. For each probe it stages the two spins' R + 2 rows (its own and
// the periodic neighbours x0-1, x0+R) and, for K2, the R rows of b into a
// ring of S shared-memory stages. A row of one spin and probe is T*itemsize
// contiguous bytes, so where it is 16-byte aligned one elected thread
// copies it whole with cp.async.bulk, completing on the stage's mbarrier
// (armed with the stage's byte count); otherwise (odd T in complex64, a
// misaligned view, column tiles) every thread copies 8 or 16 bytes at a
// time with cp.async and arrives on the same mbarrier. The copies of probe
// p + S run while the block computes probes p+1 .. p+S-1. t+-1 taps come
// from the staged row (the wrap is index arithmetic there), x+-1 taps from
// the halo rows, so device memory sees each v byte once per block, plus the
// 2/R halo rows (mostly L2 hits). A thread owns fixed sites (two adjacent t
// in complex64, so its stores are 16 bytes; one in complex128) and keeps
// their 18 coefficients in registers for every probe of its chunk; the
// chunking (ops/stencil_kernels.py launch_plan) fills the SMs with few
// coefficient reloads. Products are fused multiply-adds (cfma) in the
// per-site kernel's order (tap outer, input spin inner).
//
// K3: as a function (r in; x and cur out) it moves no more than K2, but it
// applies D once per root, so from about six roots on its bound is the
// arithmetic (164 flop per site, probe and root), not the bytes. One launch
// per root (poly_step) moves 4 probe blocks per root through device memory
// and is bound by that traffic instead. poly_tiled keeps the recurrence on
// chip for up to kMaxFuse roots: a block owns a window of WX x WT sites of
// the lattice's periodic extension around a tile of (WX - 2 halo) x
// (WT - 2 halo) sites; a launch that applies D h <= halo times writes the
// tile, and the halo is recomputed by the neighbouring blocks. A thread owns
// a strip of S adjacent t-sites of one window row and keeps, for the whole
// launch, their 18 S coefficients (loaded once), their cur and their x sums
// (PB probes a pass) in registers. The earlier design held the coefficients
// in shared memory and read them again every root: 144 bytes a site against
// 64 of neighbours in complex64, so shared-memory bandwidth bound it. Now
// only cur goes through shared memory: the window as copied (this pass's and
// the next one's), then cur after each root, ping-ponged between two buffers
// so that a neighbour never reads a half-updated value (one barrier a root),
// laid out by element of the strip so that a warp's accesses are
// conflict-free. Per site, probe, spin and root a thread reads the x +- 1
// neighbours and, at its strip's ends, the t - 1 of the first site and the
// t + 1 of the last (inside a strip they are its own registers), and stores
// its new cur: 3 + 2/S elements against 44 fused multiply-adds. The register
// file bounds the window: 36 (complex64) or 72 (complex128) coefficient
// registers a site, nothing spilled. On an H100 one site and one probe a
// thread beat S = 2 and PB = 2 in both dtypes (bench_torch/k3_sweep.py): the
// registers of a second site or probe cost half the warps, and the warps
// hide the shared-memory reads. What bounds the kernel now: the root loop's
// multiply-adds alone run the float32 pipes at about half their rate; then,
// between the launches of a call, cur and x through device memory (about an
// eighth of a depth-16 call), the barriers and the shared-memory reads; and
// the halo (1.49 sites computed for a useful one at depth 4 in the complex64
// plan, the rows a tile does not need skipped, the columns not). The next
// pass's window and this pass's x are copied into shared memory by cp.async
// while the roots run, each thread copying (and later reading) only its own
// sites. The products are fused multiply-adds (cfma/cfms) in the per-site
// kernel's order: the on-site term, then tap outer and input spin inner.
//
// The kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

#include "device_common.cuh"

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

// K1 per site (the yardstick): y = D v.
template <typename V>
__global__ void __launch_bounds__(kThreads)
stencil_matvec_per_site_kernel(const V* __restrict__ C, const V* __restrict__ v,
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

// K2 per site (the yardstick): r = b - D x.
template <typename V>
__global__ void __launch_bounds__(kThreads)
stencil_residual_per_site_kernel(const V* __restrict__ C, const V* __restrict__ b,
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

// K3, one launch per root theta (the yardstick of the tiled kernel):
// step = cur * inv (inv = 1/theta); x = step when `first`, else x += step;
// with kApply, cur_out = cur - D step.
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
int launch_matvec_per_site(const void* C, const void* v, void* y, int B, int X, int T,
                  void* stream) {
  if (empty(B, X, T)) return 0;
  stencil_matvec_per_site_kernel<V><<<grid_for(B, X, T), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(C), static_cast<const V*>(v), static_cast<V*>(y),
      B, X, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_residual_per_site(const void* C, const void* b, const void* x, void* r,
                    int B, int X, int T, void* stream) {
  if (empty(B, X, T)) return 0;
  stencil_residual_per_site_kernel<V><<<grid_for(B, X, T), kThreads, 0,
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


// ---- K3, tiled: several roots per launch ------------------------------------

constexpr int kMaxFuse = 4;  // most roots one launch takes

template <typename V>
struct InvRoots {
  V v[kMaxFuse];  // 1 / theta_j, passed to the kernel by value
};

// Shared memory of the tiled kernel: the window of two passes as copied (this
// pass's and the next one's), cur of the window after a root twice
// (ping-pong), this pass's x as it arrives, and the roots.
template <typename V, int WX, int WT, int PB>
constexpr size_t tiled_smem_bytes() {
  return static_cast<size_t>(5) * PB * 2 * WX * WT * sizeof(V) +
         kMaxFuse * sizeof(V);
}

// acc += a * b and acc -= a * b as four fused multiply-adds each. Written
// out because `acc += a.x * b.x - a.y * b.y` may not be contracted into two
// of them (it would reassociate the sum) and compiles to six operations,
// and the tiled kernel is bound by the operations its warps execute.
template <typename V>
__device__ __forceinline__ void cfma(V& acc, V a, V b) {
  acc.x = fma(a.x, b.x, acc.x);
  acc.x = fma(-a.y, b.y, acc.x);
  acc.y = fma(a.x, b.y, acc.y);
  acc.y = fma(a.y, b.x, acc.y);
}

template <typename V>
__device__ __forceinline__ void cfms(V& acc, V a, V b) {
  acc.x = fma(-a.x, b.x, acc.x);
  acc.x = fma(a.y, b.y, acc.x);
  acc.y = fma(-a.x, b.y, acc.y);
  acc.y = fma(-a.y, b.x, acc.y);
}

__device__ __forceinline__ int wrap(int i, int n) {
  const int m = i % n;
  return m < 0 ? m + n : m;
}

// One element (N bytes) copied into shared memory asynchronously; with
// `valid` false the element is zeroed and nothing is read.
template <int N>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(smem_addr(dst)), "l"(src), "n"(N), "r"(valid ? N : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One block: the window of WX x WT lattice sites (periodic extension)
// around the tile of (WX - 2 halo) x (WT - 2 halo) sites at (x0, t0), for
// probes [blockIdx.y * probes_per_block, ...), PB probes a pass. The window
// starts napply sites before the tile. Thread i owns the strip of S sites
// (wi, wj0 .. wj0 + S - 1) of the window, wi = i / (WT / S) and
// wj0 = S (i % (WT / S)), and keeps their 18 S coefficients in registers for
// the whole launch.
//
// Root j: step = cur * inv_j, x += step, and for j < napply
// cur <- cur - D step, valid on rows j + 1 .. H - j, where H is the last row
// that the owned rows need (fewer in a ragged tile); other rows skip the
// stencil. t +- 1 inside a strip come from the thread's registers; the
// strip's two ends and its x +- 1 rows from the window in shared memory,
// which is laid out by element of the strip ([spin][k][row][strip]) so that
// a warp's loads and stores fall on distinct banks. A strip at the window's
// edge wraps within its row and computes values that no valid site reads.
// After napply applications the owned sites are exact. x is read (unless
// `first`) and written on them, in place; cur_out is written on them when
// the last root applies D (`apply_last`), and must not alias cur_in, whose
// halo other blocks still read.
template <typename V, int WX, int WT, int S, int PB>
__global__ void __launch_bounds__(WX * WT / S, 1)
poly_tiled_kernel(const V* __restrict__ C, const V* __restrict__ cur_in,
                  V* __restrict__ x, V* __restrict__ cur_out,
                  const InvRoots<V> inv, int nroots, int halo, int first,
                  int apply_last, int probes_per_block, int B, int X, int T) {
  static_assert(WT % S == 0, "a window row is whole strips");
  constexpr int NSTR = WT / S;       // strips of a window row
  constexpr int NT = WX * NSTR;      // threads, and elements of one plane
  constexpr int PROBE = 2 * S * NT;  // a probe's window: [spin][k][row][strip]
  constexpr int BUF = PB * PROBE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* sWin = reinterpret_cast<V*>(smem_raw);  // [2 passes][PB] windows as copied
  V* sCur = sWin + 2 * BUF;                  // [2 buffers][PB] cur after a root
  V* sX = sCur + 2 * BUF;                    // [PB] this pass's x
  V* sInv = sX + BUF;                        // [kMaxFuse]

  const int napply = apply_last ? nroots : nroots - 1;
  const int tile_x = WX - 2 * halo;
  const int tile_t = WT - 2 * halo;
  const int tiles_t = (T + tile_t - 1) / tile_t;
  const int x0 = (blockIdx.x / tiles_t) * tile_x;
  const int t0 = (blockIdx.x % tiles_t) * tile_t;
  const int own_x = min(tile_x, X - x0);
  const int own_t = min(tile_t, T - t0);
  const int i = threadIdx.x;
  const int wi = i / NSTR;
  const int sj = i - wi * NSTR;
  const int wj0 = sj * S;
  // The row applies D at roots j < row_roots: j < wi and wi <= H - j.
  const int row_roots = min(wi, min(WX - 1, own_x + 2 * napply - 1) - wi);
  // The neighbours t - 1 of the strip's first site and t + 1 of its last.
  const int i_tm = wi * NSTR + (sj == 0 ? NSTR - 1 : sj - 1);
  const int i_tp = wi * NSTR + (sj == NSTR - 1 ? 0 : sj + 1);
  const long long XT = static_cast<long long>(X) * T;
  const int grow = wrap(x0 + wi - napply, X) * T;
  const bool own_row = wi >= napply && wi - napply < own_x;
  int gsite[S];   // the strip's sites in the lattice
  bool owned[S];  // ... and which of them the tile owns
#pragma unroll
  for (int kk = 0; kk < S; ++kk) {
    const int ot = wj0 + kk - napply;
    gsite[kk] = grow + wrap(t0 + ot, T);
    owned[kk] = own_row && ot >= 0 && ot < own_t;
  }

  const int pbeg = blockIdx.y * probes_per_block;
  const int pend = min(B, pbeg + probes_per_block);
  const long long pstride = 2 * XT;  // elements per probe
  // Probes p .. p + PB - 1 of `src` at the strip's sites (those the tile
  // owns with `owned_only`) into `dst`, [PB][spin][k][thread], the same
  // index as in a window buffer; zeros past the block's probes. Each thread
  // reads back only what it copied itself.
  auto stage = [&](V* dst, const V* src, int p, bool owned_only) {
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const bool live = p + q < pend;
      const V* base = src + (live ? p + q : pbeg) * pstride;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int kk = 0; kk < S; ++kk)
          cp_async_elem<sizeof(V)>(dst + ((q * 2 + s) * S + kk) * NT + i,
                                   base + s * XT + gsite[kk],
                                   live && (owned[kk] || !owned_only));
    }
  };

  // The first window is on its way while the coefficients load.
  stage(sWin, cur_in, pbeg, false);
  cp_async_commit();
  V c0[S][2];        // on-site (a, a, 0)
  V ch[S][4][2][2];  // [site][tap - 1][input spin b][output spin a]
#pragma unroll
  for (int kk = 0; kk < S; ++kk) {
    const V* Cs = C + gsite[kk];
    c0[kk][0] = Cs[0];
    c0[kk][1] = Cs[15 * XT];
#pragma unroll
    for (int k = 1; k < 5; ++k)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        ch[kk][k - 1][b][0] = Cs[(b * 5 + k) * XT];
        ch[kk][k - 1][b][1] = Cs[((2 + b) * 5 + k) * XT];
      }
  }
  // The inverse roots, read once per root from shared memory (indexing the
  // by-value struct with the loop counter compiles to a chain of compares).
  if (i < kMaxFuse) sInv[i] = inv.v[i];

  for (int p = pbeg, w = 0; p < pend; p += PB, w ^= 1) {
    // Root 0 reads the window as copied; later roots ping-pong in sCur.
    const V* win = sWin + w * BUF;
    V own[PB][2][S], xacc[PB][2][S];
    cp_async_wait_all();
    __syncthreads();  // every thread's part of the window has arrived
#pragma unroll
    for (int q = 0; q < PB; ++q)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int kk = 0; kk < S; ++kk) {
          own[q][s][kk] = win[((q * 2 + s) * S + kk) * NT + i];
          xacc[q][s][kk] = czero<V>();
        }
    // The next pass's window (into the other buffer, read last a pass ago)
    // and this pass's x arrive during the roots.
    if (p + PB < pend) stage(sWin + (w ^ 1) * BUF, cur_in, p + PB, false);
    if (!first) stage(sX, x, p, true);
    cp_async_commit();

    for (int j = 0; j < nroots; ++j) {
      const V iv = sInv[j];
#pragma unroll
      for (int q = 0; q < PB; ++q)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int kk = 0; kk < S; ++kk) cfma(xacc[q][s][kk], iv, own[q][s][kk]);
      if (j < napply) {
        if (j < row_roots) {
          const V* src = j == 0 ? win : sCur + ((j - 1) & 1) * BUF;
          V* dst = sCur + (j & 1) * BUF;
#pragma unroll
          for (int q = 0; q < PB; ++q) {
            const V* sq = src + q * PROBE;
            // The on-site term first, then tap outer and input spin inner,
            // as the per-site kernel sums them.
            V acc[S][2];
#pragma unroll
            for (int kk = 0; kk < S; ++kk) {
              acc[kk][0] = cmul(c0[kk][0], own[q][0][kk]);
              acc[kk][1] = cmul(c0[kk][1], own[q][1][kk]);
            }
#pragma unroll
            for (int b = 0; b < 2; ++b)  // tap 1: (0, +1)
#pragma unroll
              for (int kk = 0; kk < S; ++kk) {
                const V w = kk + 1 < S ? own[q][b][kk + 1] : sq[b * S * NT + i_tp];
                cfma(acc[kk][0], ch[kk][0][b][0], w);
                cfma(acc[kk][1], ch[kk][0][b][1], w);
              }
#pragma unroll
            for (int b = 0; b < 2; ++b)  // tap 2: (0, -1)
#pragma unroll
              for (int kk = 0; kk < S; ++kk) {
                const V w = kk > 0 ? own[q][b][kk - 1]
                                   : sq[(b * S + S - 1) * NT + i_tm];
                cfma(acc[kk][0], ch[kk][1][b][0], w);
                cfma(acc[kk][1], ch[kk][1][b][1], w);
              }
#pragma unroll
            for (int b = 0; b < 2; ++b)  // tap 3: (+1, 0)
#pragma unroll
              for (int kk = 0; kk < S; ++kk) {
                const V w = sq[(b * S + kk) * NT + i + NSTR];
                cfma(acc[kk][0], ch[kk][2][b][0], w);
                cfma(acc[kk][1], ch[kk][2][b][1], w);
              }
#pragma unroll
            for (int b = 0; b < 2; ++b)  // tap 4: (-1, 0)
#pragma unroll
              for (int kk = 0; kk < S; ++kk) {
                const V w = sq[(b * S + kk) * NT + i - NSTR];
                cfma(acc[kk][0], ch[kk][3][b][0], w);
                cfma(acc[kk][1], ch[kk][3][b][1], w);
              }
            V* dq = dst + q * PROBE;
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int kk = 0; kk < S; ++kk) {
                cfms(own[q][s][kk], iv, acc[kk][s]);  // D step = inv * (D cur)
                dq[(s * S + kk) * NT + i] = own[q][s][kk];
              }
          }
        }
        __syncthreads();
      }
    }

    cp_async_wait_all();
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      if (p + q >= pend) break;
      const long long base = (p + q) * pstride;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int kk = 0; kk < S; ++kk) {
          if (!owned[kk]) continue;
          V xv = xacc[q][s][kk];
          if (!first) {
            const V old = sX[((q * 2 + s) * S + kk) * NT + i];
            xv.x = old.x + xv.x;
            xv.y = old.y + xv.y;
          }
          x[base + s * XT + gsite[kk]] = xv;
          if (apply_last) cur_out[base + s * XT + gsite[kk]] = own[q][s][kk];
        }
    }
  }
}

// Probes per block: the grid is tiles x chunks of probes, over `slots`
// blocks resident at a time on the card. Fewer chunks load a block's
// coefficients for more probes; more chunks fill the SMs. Picks the chunk
// count with the least (waves of blocks) x (probe passes per block + the
// coefficient load, taken as kCoeffCost passes).
inline int choose_probes_per_block(int B, int tiles, int pb, int slots) {
  constexpr int kCoeffCost = 1;
  long long best_cost = -1;
  int best = B;
  for (int chunks = 1; chunks <= B && chunks <= 4096; ++chunks) {
    int ppb = (B + chunks - 1) / chunks;
    ppb = (ppb + pb - 1) / pb * pb;
    const long long blocks = static_cast<long long>(tiles) * ((B + ppb - 1) / ppb);
    const long long waves = (blocks + slots - 1) / slots;
    const long long cost = waves * (ppb / pb + kCoeffCost);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = ppb;
    }
  }
  return best;
}

// What a launch needs to know of its device, found at the first launch
// there: the blocks the card holds at a time (by then the kernel's
// shared-memory attribute is set), and, per halo depth, the chunking chosen
// for the last (B, X, T). A solver launches the same few shapes over and
// over, so the launcher does no device query and no search on the way.
constexpr int kMaxDevices = 64;

struct TiledSetup {
  int slots = 0;  // 0: not yet set up
  struct Chunking {
    int B = 0, X = 0, T = 0, ppb = 0;
  } chunking[kMaxFuse + 1];
};

template <typename V, int WX, int WT, int S, int PB>
int launch_poly_tiled(const void* C, const void* cur_in, void* x, void* cur_out,
                      const double* inv_re_im, int nroots, int halo, int first,
                      int apply_last, int B, int X, int T, void* stream) {
  if (empty(B, X, T)) return 0;
  const int napply = apply_last ? nroots : nroots - 1;
  if (nroots < 1 || nroots > kMaxFuse || napply > halo || halo > kMaxFuse ||
      2 * halo >= WX || 2 * halo >= WT ||
      static_cast<long long>(X) * T > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  InvRoots<V> inv;
  for (int j = 0; j < kMaxFuse; ++j) {
    inv.v[j].x = static_cast<decltype(inv.v[j].x)>(j < nroots ? inv_re_im[2 * j] : 0.0);
    inv.v[j].y = static_cast<decltype(inv.v[j].y)>(j < nroots ? inv_re_im[2 * j + 1] : 0.0);
  }
  auto kernel = poly_tiled_kernel<V, WX, WT, S, PB>;
  constexpr int threads = WX * WT / S;
  constexpr size_t smem = tiled_smem_bytes<V, WX, WT, PB>();
  const int tile_x = WX - 2 * halo, tile_t = WT - 2 * halo;
  const int tiles = ((X + tile_x - 1) / tile_x) * ((T + tile_t - 1) / tile_t);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int ppb = 0;
  {
    static std::mutex mu;
    static TiledSetup setups[kMaxDevices];
    std::lock_guard<std::mutex> lock(mu);
    TiledSetup& setup = setups[dev];
    if (setup.slots == 0) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      setup.slots = sms * per_sm;
    }
    TiledSetup::Chunking& ch = setup.chunking[halo];
    if (ch.B != B || ch.X != X || ch.T != T) {
      ch.ppb = choose_probes_per_block(B, tiles, PB, setup.slots);
      ch.B = B;
      ch.X = X;
      ch.T = T;
    }
    ppb = ch.ppb;
  }
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((B + ppb - 1) / ppb));
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(C), static_cast<const V*>(cur_in),
      static_cast<V*>(x), static_cast<V*>(cur_out), inv, nroots, halo, first,
      apply_last, ppb, B, X, T);
  return static_cast<int>(cudaGetLastError());
}

// ---- K1/K2: row-staged tiles ---------------------------------------------
//
// The launch plan (rows R, columns W, probes per block, stages S, the copy
// path and the shared-memory bytes) is chosen by ops/stencil_kernels.py
// launch_plan and checked here: a plan this kernel cannot run is refused
// with cudaErrorInvalidValue.

constexpr int kRowsMaxThreads = 512;  // a thread owns one or two tile sites
constexpr int kRowsMaxStages = 8;
constexpr int kRowsBarBytes = kRowsMaxStages * 8;  // the stages' mbarriers
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
               :: "r"(smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

// Arrives on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// acc[a] = sum_{k, b} c[a][b][k] * w[b][k], tap k outer and input spin b
// inner as apply_site sums them, with fused multiply-adds.
template <typename V>
__device__ __forceinline__ void apply_taps(const V c[2][2][5], const V w[2][5],
                                           V out[2]) {
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    V acc = czero<V>();
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        if (tap_used(a, b, k)) cfma(acc, c[a][b][k], w[b][k]);
    out[a] = acc;
  }
}

__device__ __forceinline__ float2 lo(float4 q) { return make_float2(q.x, q.y); }
__device__ __forceinline__ float2 hi(float4 q) { return make_float2(q.z, q.w); }

// K1 (y = D v) and, with kResidual, K2 (y = b - D v). One block: the tile of
// R lattice rows from x0 and W columns from t0 (W = T: whole rows), for
// probes [blockIdx.y * ppb, ...). A stage holds, per spin, the rows
// x0 - 1 .. x0 + R (slot j: row x0 - 1 + j, wrapped) at a pitch of P
// elements, then for K2 the R rows of b. With kBulk the rows are whole and
// copied by cp.async.bulk, and the t+-1 taps wrap inside the row; otherwise
// every thread copies elements with cp.async, and a row holds its W tile
// columns and then the columns t0 - 1 and t0 + W (wrapped). Thread i owns
// tile sites i * SPT .. i * SPT + SPT - 1 (row-major). A stage is refilled
// after a barrier of the whole block (a producer warp that waits on "empty"
// barriers instead measured slower at every shape that matters, PERF.md).
template <typename V, bool kResidual, bool kBulk>
__global__ void __launch_bounds__(kRowsMaxThreads, 1)
stencil_rows_kernel(const V* __restrict__ C, const V* __restrict__ b,
                    const V* __restrict__ v, V* __restrict__ y, int B, int X,
                    int T, int R, int W, int ppb, int S, int P) {
  constexpr int SPT = sizeof(V) == 8 ? 2 : 1;  // sites per thread
  // complex64 whole rows: T is even, so a thread's two sites share a row and
  // are read and written as one 16-byte access
  constexpr bool kPairs = kBulk && SPT == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  V* stage0 = reinterpret_cast<V*>(smem_raw + kRowsBarBytes);

  const int tiles_t = (T + W - 1) / W;
  const int x0 = (blockIdx.x / tiles_t) * R;
  const int t0 = (blockIdx.x % tiles_t) * W;
  const int rows = min(R, X - x0);
  const int cols = min(W, T - t0);
  const int slots = R + 2;
  const int stage_elems = (2 * slots + (kResidual ? 2 * R : 0)) * P;
  const long long XT = static_cast<long long>(X) * T;
  const long long pstride = 2 * XT;  // elements per probe
  const int p0 = blockIdx.y * ppb;
  const int n = min(B - p0, ppb);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], kBulk ? 1 : nthr);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Stage probe i of this block into stage i % S.
  auto fill = [&](int i, bool issuer) {
    V* st = stage0 + (i % S) * stage_elems;
    uint64_t* bar = &bars[i % S];
    const V* vp = v + (p0 + i) * pstride;
    const V* bp = kResidual ? b + (p0 + i) * pstride : nullptr;
    if constexpr (kBulk) {
      if (issuer) {
        const unsigned row_bytes = static_cast<unsigned>(T) * sizeof(V);
        mbar_expect_tx(bar, (2 * (rows + 2) + (kResidual ? 2 * rows : 0)) * row_bytes);
        // the block's reads of this stage (generic proxy) come before the
        // copies into it (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        // one copy per row: merging a spin's adjacent rows into one copy
        // measured slower (PERF.md, bench_torch/k12_sweep.py)
        for (int s = 0; s < 2; ++s)
          for (int j = 0; j < rows + 2; ++j)
            bulk_copy(st + (s * slots + j) * P,
                      vp + s * XT + static_cast<long long>(wrap(x0 - 1 + j, X)) * T,
                      row_bytes, bar);
        if (kResidual)
          for (int s = 0; s < 2; ++s)
            for (int r = 0; r < rows; ++r)
              bulk_copy(st + (2 * slots + s * R + r) * P,
                        bp + s * XT + static_cast<long long>(x0 + r) * T, row_bytes, bar);
      }
    } else {
      const int wv = cols + 2;
      const int tl = wrap(t0 - 1, T), tr = wrap(t0 + cols, T);
      for (int e = tid; e < 2 * (rows + 2) * wv; e += nthr) {
        const int c = e % wv;
        const int sj = e / wv;
        const int j = sj % (rows + 2), s = sj / (rows + 2);
        const int t = c < cols ? t0 + c : (c == cols ? tl : tr);
        cp_async<sizeof(V)>(st + (s * slots + j) * P + c,
                            vp + s * XT + static_cast<long long>(wrap(x0 - 1 + j, X)) * T + t);
      }
      if (kResidual)
        for (int e = tid; e < 2 * rows * cols; e += nthr) {
          const int c = e % cols;
          const int sr = e / cols;
          const int r = sr % rows, s = sr / rows;
          cp_async<sizeof(V)>(st + (2 * slots + s * R + r) * P + c,
                              bp + s * XT + static_cast<long long>(x0 + r) * T + t0 + c);
        }
      cp_async_arrive(bar);
    }
  };

  for (int i = 0; i < min(S, n); ++i) fill(i, tid == 0);

  // This thread's sites and their coefficients, loaded while the first
  // stages are in flight and kept for every probe of the chunk.
  V c[SPT][2][2][5];
  int srow[SPT], scol[SPT], lft[SPT], rgt[SPT];
  bool own[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const int f = tid * SPT + q;
    srow[q] = f / W;
    scol[q] = f - srow[q] * W;
    own[q] = srow[q] < rows && scol[q] < cols;
    lft[q] = scol[q] > 0 ? scol[q] - 1 : (kBulk ? T - 1 : cols);
    rgt[q] = scol[q] < cols - 1 ? scol[q] + 1 : (kBulk ? 0 : cols + 1);
    const long long site = static_cast<long long>(x0 + srow[q]) * T + t0 + scol[q];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb)
#pragma unroll
        for (int k = 0; k < 5; ++k)
          c[q][a][bb][k] = (own[q] && tap_used(a, bb, k))
                               ? C[((a * 2 + bb) * 5 + k) * XT + site]
                               : czero<V>();
  }

  for (int i = 0; i < n; ++i) {
    const int s = i % S;
    mbar_wait(&bars[s], (i / S) & 1);
    const V* st = stage0 + s * stage_elems;
    V* yp = y + (p0 + i) * pstride;
    if constexpr (kPairs) {
      if (own[0]) {
        const int r = srow[0], c0 = scol[0];
        V w0[2][5], w1[2][5];  // the taps of sites c0 and c0 + 1
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const V* row = st + (bb * slots + r + 1) * P;
          const float4 mid = *reinterpret_cast<const float4*>(row + c0);
          const float4 up = *reinterpret_cast<const float4*>(row + P + c0);
          const float4 dn = *reinterpret_cast<const float4*>(row - P + c0);
          w0[bb][0] = lo(mid); w1[bb][0] = hi(mid);
          w0[bb][1] = hi(mid); w1[bb][1] = row[rgt[1]];
          w0[bb][2] = row[lft[0]]; w1[bb][2] = lo(mid);
          w0[bb][3] = lo(up); w1[bb][3] = hi(up);
          w0[bb][4] = lo(dn); w1[bb][4] = hi(dn);
        }
        V o0[2], o1[2];
        apply_taps(c[0], w0, o0);
        apply_taps(c[1], w1, o1);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          float4 out = make_float4(o0[a].x, o0[a].y, o1[a].x, o1[a].y);
          if (kResidual) {
            const float4 bv = *reinterpret_cast<const float4*>(
                st + (2 * slots + a * R + r) * P + c0);
            out = make_float4(bv.x - out.x, bv.y - out.y, bv.z - out.z, bv.w - out.w);
          }
          *reinterpret_cast<float4*>(yp + a * XT + static_cast<long long>(x0 + r) * T + c0) = out;
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < SPT; ++q) {
        if (!own[q]) continue;
        const int r = srow[q], cq = scol[q];
        V w[2][5];
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          const V* row = st + (bb * slots + r + 1) * P;
          w[bb][0] = row[cq];
          w[bb][1] = row[rgt[q]];
          w[bb][2] = row[lft[q]];
          w[bb][3] = row[P + cq];
          w[bb][4] = row[cq - P];
        }
        V o[2];
        apply_taps(c[q], w, o);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (kResidual) {
            const V bv = st[(2 * slots + a * R + r) * P + cq];
            o[a].x = bv.x - o[a].x;
            o[a].y = bv.y - o[a].y;
          }
          yp[a * XT + static_cast<long long>(x0 + r) * T + t0 + cq] = o[a];
        }
      }
    }
    if (i + S < n) {
      __syncthreads();  // every thread is done with stage s
      fill(i + S, tid == 0);
    }
  }
}

bool misaligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <typename V, bool kResidual, bool kBulk>
int launch_rows_t(const V* C, const V* b, const V* v, V* y, int B, int X,
                  int T, int R, int W, int ppb, int S, int P, int threads,
                  int smem, int dev, cudaStream_t stream) {
  auto kernel = stencil_rows_kernel<V, kResidual, kBulk>;
  // The shared-memory limit is raised at this kernel's first launch on a
  // device, which precedes any CUDA-graph capture of it.
  static std::atomic<bool> ready[kMaxDevices];
  if (!ready[dev].load(std::memory_order_acquire)) {
    static std::mutex mu;
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[dev].load(std::memory_order_relaxed)) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      ready[dev].store(true, std::memory_order_release);
    }
  }
  const dim3 grid(static_cast<unsigned>(((X + R - 1) / R) * ((T + W - 1) / W)),
                  static_cast<unsigned>((B + ppb - 1) / ppb));
  kernel<<<grid, threads, smem, stream>>>(C, b, v, y, B, X, T, R, W, ppb, S, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, bool kResidual>
int launch_rows(const void* C, const void* b, const void* v, void* y,
                const int* plan, void* stream) {
  const int B = plan[0], X = plan[1], T = plan[2], R = plan[3], W = plan[4],
            ppb = plan[5], S = plan[6], bulk = plan[7], smem = plan[8], dev = plan[9];
  if (empty(B, X, T)) return 0;
  constexpr int SPT = sizeof(V) == 8 ? 2 : 1;
  constexpr int kAlign = 16 / static_cast<int>(sizeof(V));  // elements per 16 bytes
  const int P = bulk ? T : (W + 2 + kAlign - 1) / kAlign * kAlign;
  const long long threads = (static_cast<long long>(R) * W + SPT - 1) / SPT;
  const long long stage =
      (2LL * (R + 2) + (kResidual ? 2LL * R : 0)) * P * static_cast<long long>(sizeof(V));
  const bool any_misaligned =
      misaligned16(v) || misaligned16(y) || (kResidual && misaligned16(b));
  bool ok = R >= 1 && R <= X && W >= 1 && W <= T && ppb >= 1 && S >= 1 &&
            S <= kRowsMaxStages && threads <= kRowsMaxThreads &&
            kRowsBarBytes + S * stage == smem && smem <= kMaxSmem && dev >= 0 &&
            dev < kMaxDevices && (B + ppb - 1) / ppb <= 65535;
  if (bulk) ok = ok && W == T && (T * sizeof(V)) % 16 == 0 && !any_misaligned;
  // complex128 elements are copied 16 bytes at a time on either path
  if (sizeof(V) == 16) ok = ok && !any_misaligned;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope;
  const cudaError_t err = scope.enter(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const V* Cv = static_cast<const V*>(C);
  const V* bv = static_cast<const V*>(b);
  const V* vv = static_cast<const V*>(v);
  V* yv = static_cast<V*>(y);
  const int nthr = static_cast<int>(threads);
  return bulk ? launch_rows_t<V, kResidual, true>(Cv, bv, vv, yv, B, X, T, R, W, ppb, S,
                                                  P, nthr, smem, dev, s)
              : launch_rows_t<V, kResidual, false>(Cv, bv, vv, yv, B, X, T, R, W, ppb, S,
                                                   P, nthr, smem, dev, s);
}

// The per-site yardsticks launched on device `dev`.
template <typename V>
int launch_matvec_per_site_on(const void* C, const void* v, void* y, int B, int X,
                              int T, int dev, void* stream) {
  DeviceScope scope;
  const cudaError_t err = scope.enter(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_matvec_per_site<V>(C, v, y, B, X, T, stream);
}

template <typename V>
int launch_residual_per_site_on(const void* C, const void* b, const void* x, void* r,
                                int B, int X, int T, int dev, void* stream) {
  DeviceScope scope;
  const cudaError_t err = scope.enter(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_residual_per_site<V>(C, b, x, r, B, X, T, stream);
}

// ---- K4: the coarse levels' block stencils, block-sparse --------------------
//
// Replaces no TPU kernel: the JAX package leaves the coarse levels to XLA (a
// gather and a batched matrix product over the grouped band of
// mg/hierarchy.py pack_grouped). A coarse operator is a cyclic block stencil
// whose (dc, dc) blocks are mostly exact zeros that the aggregation leaves:
// at 128^2, 20.6% of level 1's stored entries are nonzero and 50% of level
// 2's, so the grouped band multiplies 11.6x and 6.7x the entries it needs.
// K4 reads the operator as block-sparse rows (ops/block_kernels.py
// block_layout): the 2 x 2 sub-blocks that hold a nonzero entry, per row of
// sub-blocks their column indices and values. On the H100 sub-blocks of 2
// beat 1, 4 and 8 at both coarse levels of the 128^2 hierarchy (PERF.md), so
// the kernel is built for 2 alone (coarse blocks are (2k, 2k)).
//
// Bound: at B = 128 a level-1 root moves cur and x in and x and cur' out
// (4 x 8.4 MB in complex64) and 2.2 MB of nonzero values, 10.7 us at
// 3.35 TB/s, against 4.1 us of nonzero arithmetic at 67 TFLOP/s; a level-2
// root 2.7 us. Both are small enough that the L2 (50 MB) holds a level's
// vectors between its launches, and the time goes to the loads: the
// operator's values, re-read for every chunk of probes, and B probes'
// inputs. So a thread owns one operator row for a chunk of kP probes and
// loads its row's values once per sub-block for all kP; a warp is 32
// consecutive rows, so that its stores and its reads of x, b and its own
// cur are contiguous (256 bytes in complex64), and the 2 lanes of one
// sub-block row read the same 2 inputs (one sector); the 8 warps of a block
// take successive probe chunks of the same 32 rows, so the values reach a
// block from L2 once and its other warps from L1. The kP sums stay in
// registers and the products are fused multiply-adds (cfma) in full
// float32 / float64.
//
// Forms (kMode), one launch each: y = A v; r = b - A x; one root of the
// polynomial smoother, step = cur / theta, x = step on the first root else
// x + step, and cur' = cur - A step, computed as cur - (1 / theta) (A cur);
// and the last root without the application, x += cur / theta.

constexpr int kBsrS = 2;      // sub-block size
constexpr int kBsrWarps = 8;  // warps a block (4 and 16 within 3%, PERF.md)
constexpr int kBsrMatvec = 0;
constexpr int kBsrResidual = 1;
constexpr int kBsrRoot = 2;
constexpr int kBsrLast = 3;

// Two consecutive elements, 16 bytes a load, through the read-only
// (non-coherent) path: the values and `in`, which no thread of a launch
// writes.
template <typename V>
__device__ __forceinline__ void load_pair(const V* __restrict__ p, V (&v)[kBsrS]) {
  if constexpr (sizeof(V) == 8) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0].x = t.x;
    v[0].y = t.y;
    v[1].x = t.z;
    v[1].y = t.w;
  } else {
    v[0] = __ldg(p);
    v[1] = __ldg(p + 1);
  }
}

// Vectors are (B, n), n = nbr * 2, C-contiguous. `in` is v (matvec), x
// (residual) or cur (roots); `b` the right-hand side (residual); `x` the
// smoother's iterate (roots); `out` y, r or cur'. Block (32, kBsrWarps):
// thread (lane, warp) owns row r = blockIdx.x * 32 + lane (row r % 2 of
// sub-block row r / 2) for probes p0 .. p0 + kP - 1, p0 = (blockIdx.y *
// kBsrWarps + warp) * kP.
template <typename V, int kP, int kMode>
__global__ void __launch_bounds__(kBsrWarps * 32)
coarse_bsr_kernel(const int* __restrict__ rowptr, const int* __restrict__ cols,
                  const V* __restrict__ vals, const V* __restrict__ in,
                  const V* __restrict__ b, V* __restrict__ x, V* __restrict__ out,
                  V inv, int first, int B, int nbr) {
  constexpr int S = kBsrS;
  const long long n = static_cast<long long>(nbr) * S;
  const long long r = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  const int p0 = (blockIdx.y * kBsrWarps + threadIdx.y) * kP;
  if (r >= n || p0 >= B) return;
  const int np = min(kP, B - p0);
  V acc[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) acc[j] = czero<V>();
  if (kMode != kBsrLast) {
    const int i = static_cast<int>(r / S);
    const int a = static_cast<int>(r - static_cast<long long>(i) * S);
    const V* vp = in + static_cast<long long>(p0) * n;
    const int k1 = rowptr[i + 1];
    for (int k = rowptr[i]; k < k1; ++k) {
      V arow[S];
      load_pair<V>(vals + (static_cast<long long>(k) * S + a) * S, arow);
      const V* seg = vp + static_cast<long long>(cols[k]) * S;
#pragma unroll
      for (int j = 0; j < kP; ++j) {
        if (j < np) {
          V v[S];
          load_pair<V>(seg + j * n, v);
#pragma unroll
          for (int c = 0; c < S; ++c) cfma(acc[j], arow[c], v[c]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    if (j >= np) break;
    const long long o = static_cast<long long>(p0 + j) * n + r;
    if (kMode == kBsrMatvec) {
      out[o] = acc[j];
    } else if (kMode == kBsrResidual) {
      V t = b[o];
      t.x -= acc[j].x;
      t.y -= acc[j].y;
      out[o] = t;
    } else {
      const V c = in[o];
      const V step = cmul(inv, c);
      V xv = step;
      if (!first) {
        xv = x[o];
        xv.x += step.x;
        xv.y += step.y;
      }
      x[o] = xv;
      if (kMode == kBsrRoot) {
        V t = c;
        cfms(t, inv, acc[j]);
        out[o] = t;
      }
    }
  }
}

template <typename V, int kP>
int launch_bsr_p(int mode, dim3 grid, cudaStream_t s, const int* rowptr, const int* cols,
                 const V* vals, const V* in, const V* b, V* x, V* out, V inv, int first,
                 int B, int nbr) {
  const dim3 threads(32, kBsrWarps);
  switch (mode) {
    case kBsrMatvec:
      coarse_bsr_kernel<V, kP, kBsrMatvec><<<grid, threads, 0, s>>>(
          rowptr, cols, vals, in, b, x, out, inv, first, B, nbr);
      break;
    case kBsrResidual:
      coarse_bsr_kernel<V, kP, kBsrResidual><<<grid, threads, 0, s>>>(
          rowptr, cols, vals, in, b, x, out, inv, first, B, nbr);
      break;
    case kBsrRoot:
      coarse_bsr_kernel<V, kP, kBsrRoot><<<grid, threads, 0, s>>>(
          rowptr, cols, vals, in, b, x, out, inv, first, B, nbr);
      break;
    default:
      coarse_bsr_kernel<V, kP, kBsrLast><<<grid, threads, 0, s>>>(
          rowptr, cols, vals, in, b, x, out, inv, first, B, nbr);
  }
  return static_cast<int>(cudaGetLastError());
}

// `cfg`: mode, first, B, nbr, probes per thread, device.
template <typename V>
int launch_bsr(const void* rowptr, const void* cols, const void* vals, const void* in,
               const void* b, void* x, void* out, double inv_re, double inv_im,
               const int* cfg, void* stream) {
  const int mode = cfg[0], first = cfg[1], B = cfg[2], nbr = cfg[3], probes = cfg[4],
            dev = cfg[5];
  if (B <= 0 || nbr <= 0) return 0;
  const long long n = static_cast<long long>(nbr) * kBsrS;
  const long long blocks = (n + 31) / 32;
  const int chunks = (B + probes * kBsrWarps - 1) / (probes * kBsrWarps);
  bool ok = mode >= kBsrMatvec && mode <= kBsrLast && (probes == 4 || probes == 8) &&
            chunks <= 65535 && blocks <= 0x7fffffffLL && dev >= 0;
  // 16-byte loads of two elements need 16-byte aligned values and inputs
  ok = ok && !misaligned16(vals) && !misaligned16(in);
  if (mode == kBsrResidual) ok = ok && b != nullptr && out != nullptr;
  if (mode >= kBsrRoot) ok = ok && x != nullptr && (mode == kBsrLast || out != nullptr);
  if (mode == kBsrMatvec) ok = ok && out != nullptr;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope;
  const cudaError_t err = scope.enter(dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  V v_inv;
  v_inv.x = static_cast<decltype(v_inv.x)>(inv_re);
  v_inv.y = static_cast<decltype(v_inv.y)>(inv_im);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(chunks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* rp = static_cast<const int*>(rowptr);
  const int* cp = static_cast<const int*>(cols);
  const V* vv = static_cast<const V*>(vals);
  const V* iv = static_cast<const V*>(in);
  const V* bv = static_cast<const V*>(b);
  V* xv = static_cast<V*>(x);
  V* ov = static_cast<V*>(out);
  return probes == 8
             ? launch_bsr_p<V, 8>(mode, grid, s, rp, cp, vv, iv, bv, xv, ov, v_inv, first, B, nbr)
             : launch_bsr_p<V, 4>(mode, grid, s, rp, cp, vv, iv, bv, xv, ov, v_inv, first, B, nbr);
}

}  // namespace

// Plain C interface, loaded with ctypes. Every entry returns
// cudaGetLastError() after its launch (0 = success).
extern "C" {

// K1 and K2 by the row kernel. `plan` is a host array of ten ints (see
// ops/stencil_kernels.py RowsPlan.c_array): B, X, T, rows, cols, probes
// per block, stages, bulk (0/1), dynamic shared-memory bytes, and the
// device of the operands.
int dmlmc_stencil_matvec_c64(const void* C, const void* v, void* y,
                             const int* plan, void* stream) {
  return launch_rows<float2, false>(C, nullptr, v, y, plan, stream);
}

int dmlmc_stencil_matvec_c128(const void* C, const void* v, void* y,
                              const int* plan, void* stream) {
  return launch_rows<double2, false>(C, nullptr, v, y, plan, stream);
}

int dmlmc_stencil_residual_c64(const void* C, const void* b, const void* x,
                               void* r, const int* plan, void* stream) {
  return launch_rows<float2, true>(C, b, x, r, plan, stream);
}

int dmlmc_stencil_residual_c128(const void* C, const void* b, const void* x,
                                void* r, const int* plan, void* stream) {
  return launch_rows<double2, true>(C, b, x, r, plan, stream);
}

// The per-site K1 and K2 (yardsticks, on no path).
int dmlmc_stencil_matvec_per_site_c64(const void* C, const void* v, void* y,
                                      int B, int X, int T, int dev,
                                      void* stream) {
  return launch_matvec_per_site_on<float2>(C, v, y, B, X, T, dev, stream);
}

int dmlmc_stencil_matvec_per_site_c128(const void* C, const void* v, void* y,
                                       int B, int X, int T, int dev,
                                       void* stream) {
  return launch_matvec_per_site_on<double2>(C, v, y, B, X, T, dev, stream);
}

int dmlmc_stencil_residual_per_site_c64(const void* C, const void* b,
                                        const void* x, void* r, int B, int X,
                                        int T, int dev, void* stream) {
  return launch_residual_per_site_on<float2>(C, b, x, r, B, X, T, dev, stream);
}

int dmlmc_stencil_residual_per_site_c128(const void* C, const void* b,
                                         const void* x, void* r, int B, int X,
                                         int T, int dev, void* stream) {
  return launch_residual_per_site_on<double2>(C, b, x, r, B, X, T, dev, stream);
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

// Tiled K3. `inv_re_im` is a host array of 2 * nroots doubles (re, im of
// 1 / theta_j), nroots <= kMaxFuse; `halo` (at least the launch's
// applications of D) sets the tile: the window less `halo` on each side.
// The plan of each dtype (window, strip, probes a pass) is
// ops/stencil_kernels.py WINDOW, STRIP and PROBES_PER_PASS.
int dmlmc_stencil_poly_tiled_c64(const void* C, const void* cur_in, void* x,
                                 void* cur_out, const double* inv_re_im,
                                 int nroots, int halo, int first, int apply_last,
                                 int B, int X, int T, void* stream) {
  return launch_poly_tiled<float2, 24, 40, 1, 1>(C, cur_in, x, cur_out, inv_re_im,
                                                 nroots, halo, first, apply_last,
                                                 B, X, T, stream);
}

int dmlmc_stencil_poly_tiled_c128(const void* C, const void* cur_in, void* x,
                                  void* cur_out, const double* inv_re_im,
                                  int nroots, int halo, int first, int apply_last,
                                  int B, int X, int T, void* stream) {
  return launch_poly_tiled<double2, 16, 32, 1, 1>(C, cur_in, x, cur_out, inv_re_im,
                                                  nroots, halo, first, apply_last,
                                                  B, X, T, stream);
}

// K4 (coarse_bsr_kernel): `cfg` is a host array of six ints, mode (0 y = A v,
// 1 r = b - A x, 2 a root, 3 the last root without the application), first
// root (0/1), B, rows of 2 x 2 sub-blocks, probes per thread (4 or 8) and the
// device of the operands; inv_re, inv_im: 1 / theta of a
// root. Unused pointers may be null.
int dmlmc_stencil_coarse_bsr_c64(const void* rowptr, const void* cols,
                                 const void* vals, const void* in, const void* b,
                                 void* x, void* out, double inv_re, double inv_im,
                                 const int* cfg, void* stream) {
  return launch_bsr<float2>(rowptr, cols, vals, in, b, x, out, inv_re, inv_im, cfg,
                            stream);
}

int dmlmc_stencil_coarse_bsr_c128(const void* rowptr, const void* cols,
                                  const void* vals, const void* in, const void* b,
                                  void* x, void* out, double inv_re, double inv_im,
                                  const int* cfg, void* stream) {
  return launch_bsr<double2>(rowptr, cols, vals, in, b, x, out, inv_re, inv_im, cfg,
                             stream);
}

}  // extern "C"
