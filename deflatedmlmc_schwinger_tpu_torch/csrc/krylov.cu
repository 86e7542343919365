// The tail of an Arnoldi step of batched FGMRES for Hopper (sm_90a):
// krylov_tail_reduce_kernel.
//
// Replaces no TPU kernel: the JAX package leaves the Arnoldi step of
// deflatedmlmc_schwinger_tpu/solvers/fgmres.py to XLA. The port ran it as
// plain PyTorch (ops/krylov_kernels.py step_tail_plain, its plain version),
// which writes every product to device memory and reads it back: about 9
// probe blocks moved per Gram-Schmidt term, and some 8j + 45 tiny launches
// for the rotations of step j.
//
// One launch does all of step j's tail for B probes: the active rows' step
// counts, modified Gram-Schmidt of w against V[0..j] into V[j+1], the j
// earlier Givens rotations and a new one on the Hessenberg column, the
// rotated right-hand side g and the residual estimates. Layout (all
// C-contiguous, complex interleaved as float2 / double2): V (m + 1, B, n),
// H (B, m + 1, m), g (B, m + 1), cs (m, B) real, sn (m, B), res, tol and
// iters (B,), w (B, n).
//
// Bound: device-memory bytes. Step j reads V[0..j] and w once and writes
// V[j+1] once, (j + 3) blocks of B * n elements, with 8 flops per element
// and term: far below the ridge. So the design reads each basis vector
// once and keeps w on chip:
//
//  * A probe is one thread-block cluster of C CTAs (C <= 8, picked from n by
//    ops/krylov_kernels.py launch_plan). Rank r owns the slice
//    [r * slice, (r + 1) * slice) of the probe's n elements, and thread t
//    the slice elements t + kTailThreads * k, k < K.
//  * On-chip form (K <= kTailMaxPerThread): a thread holds its K elements
//    of w in registers for the whole step. V[i]'s slice streams through a ring of S slots in
//    shared memory, one cp.async.bulk per slot completing on the slot's
//    mbarrier; the copy of V[i + S - 2] is issued as soon as term i - 2's
//    slot is free, so copies run during the reductions and passes before
//    their use.
//  * A term is one pass over the slice: w -= h_{i-1} V[i-1] from the slot
//    already on chip, and the partial <V[i], w> of the updated w. So V[i]
//    is read from device memory once, and the sequence of operations is
//    modified Gram-Schmidt's.
//  * The partials are summed by a fixed tree: warp shuffles, the block's
//    warps in order, then the C CTAs' sums, which each CTA sends to every
//    CTA of the cluster through distributed shared memory (st.async,
//    completing on the receiver's mbarrier: no cluster-wide barrier a
//    term), every thread adding them in rank order, so all threads of the
//    cluster hold the same h_i bit for bit.
//    The norm is reduced the same way, and V[j+1] = w / ||w|| is written
//    from the registers once. No float atomics: results repeat bit for
//    bit from run to run.
//  * One thread (rank 0, thread 0) then applies the rotations to the
//    column, computes the new one with the clamps and zero cases of the
//    plain version, and writes H's column, cs, sn, g, res and iters. The
//    earlier rotations are loaded into shared memory by the CTA's threads
//    at the start, so the serial part waits on no device-memory load.
//  * Device-memory form: where a probe's slice is too large for the
//    registers and the ring (n beyond 8 CTAs of 16 elements a thread, e.g.
//    512^2: 4 MB a probe) w stays in device memory, is updated there in place, and V is
//    read directly (V[i-1] again from L2 for the update). The loop and the
//    reduction order are those of the on-chip form.
//
// Sums are taken in the working precision (float for complex64, double for
// complex128), nothing lower.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "device_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTailThreads = 256;
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kTailMaxClusters = 8;  // the portable cluster size
constexpr int kTailMaxPerThread = 16;  // elements of w a thread holds on chip
constexpr int kTailMaxStages = 8;
constexpr int kTailBarBytes = (kTailMaxStages + 2) * 8;  // ring and exchange
constexpr int kTailMaxSmem = 232448;  // dynamic shared memory a block may use
constexpr int kTailMaxDevices = 64;

template <typename V>
struct RealOf;
template <>
struct RealOf<float2> {
  using type = float;
};
template <>
struct RealOf<double2> {
  using type = double;
};

template <typename V>
struct TailArgs {
  using R = typename RealOf<V>::type;
  V* basis;  // V
  V* H;
  V* g;
  R* cs;
  V* sn;
  R* res;
  const R* tol;
  int* iters;
  V* w;
  long long n;
  int B, m, j;
  int slice;       // elements of a probe per CTA
  int per_thread;  // elements of a slice per thread
  int stages;      // ring slots (on-chip form)
  R tiny;
};

template <typename V>
__device__ __forceinline__ V cpair(typename RealOf<V>::type x,
                                   typename RealOf<V>::type y) {
  V r;
  r.x = x;
  r.y = y;
  return r;
}

template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  return cpair<V>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// acc += conj(a) * b
template <typename V>
__device__ __forceinline__ void cdot_acc(V& acc, V a, V b) {
  acc.x += a.x * b.x + a.y * b.y;
  acc.y += a.x * b.y - a.y * b.x;
}

// w -= h * v
template <typename V>
__device__ __forceinline__ void csub_mul(V& w, V h, V v) {
  const V p = cmul(h, v);
  w.x -= p.x;
  w.y -= p.y;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// `p` (this CTA's shared memory) in the shared memory of cluster rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// v into another CTA's shared memory at `dst`, completing on its mbarrier
// `bar` (both shared::cluster addresses).
__device__ __forceinline__ void store_remote(uint32_t dst, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];"
      :: "r"(dst), "f"(v.x), "f"(v.y), "r"(bar) : "memory");
}
__device__ __forceinline__ void store_remote(uint32_t dst, double2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f64 [%0], {%1, %2}, [%3];"
      :: "r"(dst), "d"(v.x), "d"(v.y), "r"(bar) : "memory");
}

// Where a CTA receives the C CTAs' sums of a reduction: two sets of slots and
// mbarriers that alternate by reduction, so that a fast CTA's sum of
// reduction t + 2 cannot land on a slot that another still reads for t (it
// is sent only after every CTA's sum of t + 1 arrived, and each CTA sends
// that after reading its sums of t).
template <typename V>
struct Exchange {
  uint64_t* bar;  // [2]
  V* slot;        // [2][kTailMaxClusters]
};

// The sum of every thread's `part` over the cluster, reduction `t` of the
// launch, the same bits in every thread of every CTA: lane 0's warp sum, the
// warps in order (thread 0), then the CTAs in rank order. Thread 0 sends its
// CTA's sum to every CTA of the cluster (itself included) by st.async, which
// completes on the receiver's mbarrier; every thread waits on its own CTA's
// mbarrier and adds the C slots. No cluster-wide barrier.
template <typename V>
__device__ __forceinline__ V cluster_sum(V part, V* warp_parts, const Exchange<V>& ex,
                                         int t, int rank, int C) {
  part = warp_sum(part);
  if ((threadIdx.x & 31) == 0) warp_parts[threadIdx.x >> 5] = part;
  __syncthreads();
  uint64_t* bar = ex.bar + (t & 1);
  V* slot = ex.slot + (t & 1) * kTailMaxClusters;
  if (threadIdx.x == 0) {
    V s = warp_parts[0];
#pragma unroll
    for (int i = 1; i < kTailWarps; ++i) {
      s.x += warp_parts[i].x;
      s.y += warp_parts[i].y;
    }
    mbar_expect_tx(bar, static_cast<unsigned>(C * sizeof(V)));
    for (int r = 0; r < C; ++r)
      store_remote(cluster_addr(slot + rank, r), s, cluster_addr(bar, r));
  }
  mbar_wait(bar, (t >> 1) & 1);
  V tot = czero<V>();
#pragma unroll
  for (int r = 0; r < kTailMaxClusters; ++r) {
    if (r < C) {
      tot.x += slot[r].x;
      tot.y += slot[r].y;
    }
  }
  return tot;
}

__device__ __forceinline__ float cmag(float x, float y) { return hypotf(x, y); }
__device__ __forceinline__ double cmag(double x, double y) { return hypot(x, y); }
__device__ __forceinline__ float real_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double real_sqrt(double x) { return sqrt(x); }

// The Givens part of the step for probe b, by one thread: the step count,
// the earlier rotations (cs_s, sn_s: their values for this probe) and a new
// one on the column hs[0..j+1], with ops/krylov_kernels.py _givens' clamps
// and zero cases, then H's column, g and the residual estimate.
template <typename V>
__device__ void givens_tail(const TailArgs<V>& a, int b, V* hs,
                            const typename RealOf<V>::type* cs_s, const V* sn_s) {
  using R = typename RealOf<V>::type;
  const int j = a.j, m = a.m, B = a.B;
  const bool active = a.res[b] > a.tol[b];
  if (active) a.iters[b] += 1;
  for (int i = 0; i < j; ++i) {
    const R c = cs_s[i];
    const V s = sn_s[i];
    const V hi = hs[i], hp = hs[i + 1];
    const V shp = cmul(s, hp);
    const V cshi = cmul(cpair<V>(s.x, -s.y), hi);
    hs[i] = cpair<V>(c * hi.x + shp.x, c * hi.y + shp.y);
    hs[i + 1] = cpair<V>(c * hp.x - cshi.x, c * hp.y - cshi.y);
  }
  const V ga = hs[j], gb = hs[j + 1];
  const R na = cmag(ga.x, ga.y), nb = cmag(gb.x, gb.y);
  const R t = real_sqrt(na * na + nb * nb);
  const R t_safe = t < a.tiny ? a.tiny : t;
  const R na_safe = na < a.tiny ? a.tiny : na;
  const R nb_safe = nb < a.tiny ? a.tiny : nb;
  R c = na / t_safe;
  V s = cmul(cpair<V>(ga.x / na_safe, ga.y / na_safe), cpair<V>(gb.x, -gb.y));
  s = cpair<V>(s.x / t_safe, s.y / t_safe);
  if (!(na > 0)) {
    s = cpair<V>(gb.x / nb_safe, -gb.y / nb_safe);
    c = 0;
  }
  if (!(t > 0)) {
    c = 1;
    s = czero<V>();
  }
  const V sb = cmul(s, gb);
  hs[j] = cpair<V>(c * ga.x + sb.x, c * ga.y + sb.y);
  hs[j + 1] = czero<V>();
  a.cs[static_cast<long long>(j) * B + b] = c;
  a.sn[static_cast<long long>(j) * B + b] = s;
  V* gp = a.g + static_cast<long long>(b) * (m + 1);
  const V gj = gp[j];
  gp[j] = cpair<V>(c * gj.x, c * gj.y);
  const V sg = cmul(cpair<V>(-s.x, s.y), gj);
  gp[j + 1] = sg;
  V* Hc = a.H + static_cast<long long>(b) * (m + 1) * m + j;
  for (int r = 0; r <= m; ++r) Hc[static_cast<long long>(r) * m] = r <= j + 1 ? hs[r] : czero<V>();
  if (active) a.res[b] = cmag(sg.x, sg.y);
}

// kOnChip: w in registers, a.per_thread <= kTailMaxPerThread elements a
// thread (the loops run to kTailMaxPerThread, the elements past the slice
// masked); else the device-memory form, a.per_thread elements a thread.
template <typename V, bool kOnChip>
__global__ void __launch_bounds__(kTailThreads, 2)
krylov_tail_reduce_kernel(const TailArgs<V> a) {
  using R = typename RealOf<V>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int j = a.j, S = a.stages, slice = a.slice;
  const bool lead = rank == 0 && tid == 0;
  const long long lo = static_cast<long long>(rank) * slice;
  const int count = static_cast<int>(
      a.n - lo < slice ? (a.n - lo > 0 ? a.n - lo : 0) : slice);
  const long long pstride = static_cast<long long>(a.B) * a.n;  // V[i] to V[i+1]
  const V* vb = a.basis + static_cast<long long>(b) * a.n + lo;  // V[0]'s slice
  V* ws = a.w + static_cast<long long>(b) * a.n + lo;

  extern __shared__ __align__(16) unsigned char smem[];
  V* ring = reinterpret_cast<V*>(smem);
  size_t off = kOnChip ? static_cast<size_t>(S) * slice * sizeof(V) : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + off);
  const Exchange<V> ex{bars + kTailMaxStages,
                       reinterpret_cast<V*>(smem + off + kTailBarBytes)};
  off += kTailBarBytes + 2 * kTailMaxClusters * sizeof(V);
  V* warp_parts = reinterpret_cast<V*>(smem + off);
  off += kTailWarps * sizeof(V);
  V* hs = reinterpret_cast<V*>(smem + off);  // the column, m + 1 values
  off += (a.m + 1) * sizeof(V);
  V* sn_s = reinterpret_cast<V*>(smem + off);  // the earlier rotations, m each
  off += a.m * sizeof(V);
  R* cs_s = reinterpret_cast<R*>(smem + off);

  const unsigned bytes = static_cast<unsigned>(count) * sizeof(V);
  // term i's slice into slot i % S (one thread)
  auto issue = [&](int i) {
    uint64_t* bar = &bars[i % S];
    mbar_expect_tx(bar, bytes);
    bulk_copy(ring + static_cast<size_t>(i % S) * slice, vb + i * pstride, bytes, bar);
  };
  if (tid == 0) {
    if (kOnChip)
      for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    mbar_init(&ex.bar[0], 1);
    mbar_init(&ex.bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA's exchange barriers are set up before any CTA sends to them
  cluster.sync();
  if constexpr (kOnChip) {
    if (tid == 0 && count > 0)
      for (int i = 0; i <= j && i < S; ++i) issue(i);
  }
  if (rank == 0) {
    for (int i = tid; i < j; i += kTailThreads) {
      cs_s[i] = a.cs[static_cast<long long>(i) * a.B + b];
      sn_s[i] = a.sn[static_cast<long long>(i) * a.B + b];
    }
  }

  V wr[kOnChip ? kTailMaxPerThread : 1];
  if constexpr (kOnChip) {
#pragma unroll
    for (int k = 0; k < kTailMaxPerThread; ++k) {
      const int e = tid + k * kTailThreads;
      wr[k] = e < count ? ws[e] : czero<V>();
    }
  }

  V h = czero<V>();
  for (int i = 0; i <= j; ++i) {
    V part = czero<V>();
    if constexpr (kOnChip) {
      // term i - 2's slot is free: every thread passed the last barrier
      if (tid == 0 && count > 0 && i >= 2 && i - 2 + S <= j) {
        // the block's reads of the slot (generic proxy) come before the
        // copy into it (async proxy)
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue(i - 2 + S);
      }
      if (count > 0) mbar_wait(&bars[i % S], (i / S) & 1);
      const V* cur = ring + static_cast<size_t>(i % S) * slice;
      const V* prev = ring + static_cast<size_t>((i + S - 1) % S) * slice;
#pragma unroll
      for (int k = 0; k < kTailMaxPerThread; ++k) {
        const int e = tid + k * kTailThreads;
        if (e < count) {
          if (i > 0) csub_mul(wr[k], h, prev[e]);
          cdot_acc(part, cur[e], wr[k]);
        }
      }
    } else {
      const V* cur = vb + i * pstride;
      const V* prev = cur - pstride;
      for (int k = 0; k < a.per_thread; ++k) {
        const int e = tid + k * kTailThreads;
        if (e < count) {
          V wv = ws[e];
          if (i > 0) {
            csub_mul(wv, h, prev[e]);
            ws[e] = wv;
          }
          cdot_acc(part, cur[e], wv);
        }
      }
    }
    if (lead && i > 0) hs[i - 1] = h;
    h = cluster_sum(part, warp_parts, ex, i, rank, C);
  }
  if (lead) hs[j] = h;

  // the last update and ||w||^2 (in .x)
  V nrm = czero<V>();
  if constexpr (kOnChip) {
    const V* prev = ring + static_cast<size_t>(j % S) * slice;
#pragma unroll
    for (int k = 0; k < kTailMaxPerThread; ++k) {
      const int e = tid + k * kTailThreads;
      if (e < count) {
        csub_mul(wr[k], h, prev[e]);
        nrm.x += wr[k].x * wr[k].x + wr[k].y * wr[k].y;
      }
    }
  } else {
    const V* prev = vb + j * pstride;
    for (int k = 0; k < a.per_thread; ++k) {
      const int e = tid + k * kTailThreads;
      if (e < count) {
        V wv = ws[e];
        csub_mul(wv, h, prev[e]);
        ws[e] = wv;
        nrm.x += wv.x * wv.x + wv.y * wv.y;
      }
    }
  }
  const R hn = real_sqrt(cluster_sum(nrm, warp_parts, ex, j + 1, rank, C).x);
  const R d = hn < a.tiny ? a.tiny : hn;
  V* out = a.basis + (j + 1) * pstride + static_cast<long long>(b) * a.n + lo;
  if constexpr (kOnChip) {
#pragma unroll
    for (int k = 0; k < kTailMaxPerThread; ++k) {
      const int e = tid + k * kTailThreads;
      if (e < count) out[e] = cpair<V>(wr[k].x / d, wr[k].y / d);
    }
  } else {
    for (int k = 0; k < a.per_thread; ++k) {
      const int e = tid + k * kTailThreads;
      if (e < count) {
        const V wv = ws[e];
        out[e] = cpair<V>(wv.x / d, wv.y / d);
      }
    }
  }
  if (lead) {
    hs[j + 1] = cpair<V>(hn, 0);
    givens_tail(a, b, hs, cs_s, sn_s);
  }
  // no CTA leaves while a store it sent may still be in flight
  cluster.sync();
}

size_t tail_smem_bytes(bool on_chip, int stages, int slice, int m, size_t vsize) {
  const size_t ring = on_chip ? static_cast<size_t>(stages) * slice * vsize : 0;
  return ring + kTailBarBytes + (2 * kTailMaxClusters + kTailWarps + (m + 1) + m) * vsize +
         m * (vsize / 2);
}

template <typename V, bool kOnChip>
cudaError_t launch_tail_k(const TailArgs<V>& a, int clusters, size_t smem,
                          int dev, cudaStream_t stream) {
  auto kernel = krylov_tail_reduce_kernel<V, kOnChip>;
  {
    // the shared-memory limit, once per device
    static std::mutex mu;
    static bool set[kTailMaxDevices] = {};
    std::lock_guard<std::mutex> lock(mu);
    if (!set[dev]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTailMaxSmem);
      if (err != cudaSuccess) return err;
      set[dev] = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.B * clusters));
  cfg.blockDim = dim3(kTailThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(clusters);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// `cfg`: n, B, m, j, clusters, elements a thread, stages (0: the
// device-memory form), device. A plan this kernel cannot run is refused with
// cudaErrorInvalidValue.
template <typename V>
int launch_tail(void* basis, void* H, void* g, void* cs, void* sn, void* res,
                const void* tol, void* iters, void* w, const long long* cfg,
                double tiny, void* stream) {
  using R = typename RealOf<V>::type;
  const long long n = cfg[0], B = cfg[1], m = cfg[2], j = cfg[3], clusters = cfg[4],
                  per_thread = cfg[5], stages = cfg[6], dev = cfg[7];
  if (B <= 0 || n <= 0) return 0;
  const bool on_chip = stages > 0;
  const long long slice = per_thread * kTailThreads;
  bool ok = j >= 0 && j < m && m < (1 << 16) && dev >= 0 && dev < kTailMaxDevices &&
            (clusters == 1 || clusters == 2 || clusters == 4 || clusters == 8) &&
            clusters <= kTailMaxClusters && per_thread >= 1 &&
            slice * clusters >= n && slice <= (1LL << 30) &&
            B * clusters <= 0x7fffffffLL;
  if (on_chip) {
    // whole slices by bulk copies: 16-byte aligned ends
    ok = ok && per_thread <= kTailMaxPerThread && stages >= 2 && stages <= kTailMaxStages &&
         (n * static_cast<long long>(sizeof(V))) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(basis) % 16 == 0;
  }
  const size_t smem = tail_smem_bytes(on_chip, static_cast<int>(stages),
                                      static_cast<int>(slice), static_cast<int>(m),
                                      sizeof(V));
  ok = ok && smem <= static_cast<size_t>(kTailMaxSmem);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  DeviceScope scope;
  cudaError_t err = scope.enter(static_cast<int>(dev));
  if (err != cudaSuccess) return static_cast<int>(err);
  TailArgs<V> a;
  a.basis = static_cast<V*>(basis);
  a.H = static_cast<V*>(H);
  a.g = static_cast<V*>(g);
  a.cs = static_cast<R*>(cs);
  a.sn = static_cast<V*>(sn);
  a.res = static_cast<R*>(res);
  a.tol = static_cast<const R*>(tol);
  a.iters = static_cast<int*>(iters);
  a.w = static_cast<V*>(w);
  a.n = n;
  a.B = static_cast<int>(B);
  a.m = static_cast<int>(m);
  a.j = static_cast<int>(j);
  a.slice = static_cast<int>(slice);
  a.per_thread = static_cast<int>(per_thread);
  a.stages = static_cast<int>(stages);
  a.tiny = static_cast<R>(tiny);
  const int C = static_cast<int>(clusters), d = static_cast<int>(dev);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = on_chip ? launch_tail_k<V, true>(a, C, smem, d, s)
                : launch_tail_k<V, false>(a, C, smem, d, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// The Arnoldi step tail. Pointers: V, H, g, cs, sn, res, tol, iters, w (the
// layout above); `cfg` a host array of eight long longs (see launch_tail);
// `tiny` the real dtype's smallest normal number.
int dmlmc_krylov_tail_c64(void* basis, void* H, void* g, void* cs, void* sn, void* res,
                          const void* tol, void* iters, void* w, const long long* cfg,
                          double tiny, void* stream) {
  return launch_tail<float2>(basis, H, g, cs, sn, res, tol, iters, w, cfg, tiny, stream);
}

int dmlmc_krylov_tail_c128(void* basis, void* H, void* g, void* cs, void* sn, void* res,
                           const void* tol, void* iters, void* w, const long long* cfg,
                           double tiny, void* stream) {
  return launch_tail<double2>(basis, H, g, cs, sn, res, tol, iters, w, cfg, tiny, stream);
}

}  // extern "C"
