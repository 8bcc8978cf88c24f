// Kernel H1: the head fan-out's dense head pass, batch-invariant.
//
//   out[r, c] = bias[idx[r], c] + sum_d feats[r, d] * kernel[idx[r], d, c]
//
// feats (n, D) f32, idx (n,) int32, kernel (cap, D, C) and bias (cap, C) of
// one weight type (f32 or bf16), out (n, C) f32, all contiguous.  Each row r
// takes the head its tenant index names out of the stacked bank
// (ops/head.py::head_pass).
//
// Not a port of a TPU kernel: the JAX package runs this head through XLA
// (sparkdl_tpu/parallel/engine.py::dense_head_row, vmapped by
// build_head_fanout_jit).  It exists for the fan-out's contract: a tenant's
// row out of a mixed-tenant batch is bit-identical to the same row through
// the head alone.  A library reduction splits D by how many outputs there
// are, so a row's sum order moves with n; here it depends on D only:
//
//   * D is cut into P = the largest of 16, 8, 4, 2, 1 that divides D
//     partial ranges of L = D / P consecutive d.  Partial p sums its range
//     in order d = p*L, p*L+1, ... from +0.0;
//   * the partials are added in order p = 0, 1, ..., P-1, then the bias;
//   * every product and every addition is rounded on its own (__fmul_rn,
//     __fadd_rn: no FMA contraction); a bf16 weight is widened to f32
//     exactly (__bfloat162float) before its product.
//
// ops/head.py::head_pass_reference does the same operations in the same
// order in PyTorch (an f32 x bf16 product promotes the weight exactly, then
// rounds once), so the two agree bit for bit on the card and the plain
// version on the CPU gives the card's bits.
//
// What bounds it on an H100: bytes.  A pass must read the D x C kernel of
// every distinct head its rows name and does only 2 n D C f32 operations:
// 32 rows over 26 distinct heads of 2048 x 1000 read 213 MB in f32 (64 us
// at 3.35 TB/s), half that in bf16, for 131 MFLOP (2 us at 67 TFLOP/s).
// One row of a 100-class head is 0.8 MB (0.25 us): there the pass is bound
// by latency, the memory round trips in series before its chains end.
//
// Design.  A pass's slab of a row, D x C weights, is spread over 32-column
// tiles and, along the partials, over a thread-block cluster of S blocks
// (S = 1, 2, 4, 8 or 16 dividing P; 16 is a non-portable cluster size),
// chosen on the host by ops/head.py::_head_plan: the largest S whose grid
// stays within 320 blocks, so a short pass is spread for latency and a
// long one keeps a block's partials together and streams.  Block rank k
// owns the PG = P / S consecutive partials k*PG .. k*PG+PG-1, i.e. the
// contiguous d rows [k*PG*L, (k+1)*PG*L).  The grid is ceil(C / 32) x n
// clusters, rows inner, so rows that share a head read each tile of it
// while it sits in L2.  A one-row 100-class pass at D = 2048 is 64 blocks
// of 128 d rows (16 KB f32) on 64 SMs; a 32-row 1000-class pass is 1024
// blocks of all 16 partials, each streaming 256 KB.
//
//   1. A block walks its rows in chunks of 16 KB of weights (128 d rows
//      f32, 256 bf16; CJ = chunk / PG rows of each of its partials)
//      through a ring of four stages in shared memory: three chunks are in
//      flight while the chains run over a fourth.  A copy is a cp.async of
//      V bytes (V = 16 where the row stride and the bank's address allow,
//      else 8 or 4), or, for bf16 rows of odd C whose 2-byte stride no
//      cp.async takes, 2-byte loads 16 at a time into registers.  The
//      features' copies are issued before the tenant index is read; the
//      weights' right after.  Three blocks fit an SM (69,632 bytes of
//      shared memory f32, 71,680 bf16).
//   2. Thread (q, c) runs chain (partial k*PG+q, column c) out of shared
//      memory, two chains a thread at PG = 16, eight steps' operands read
//      before their adds: lanes read neighbouring columns, the feature is
//      a broadcast.
//   3. The partials meet in rank 0: each rank stores its PG partials into
//      rank 0's table of P (st.shared::cluster, after the barrier phase
//      every rank arrived at when it started), arrives at the barrier's
//      second phase with release and leaves; rank 0 waits with acquire,
//      adds the P partials in order, then the bias (loaded at the start).
//      No atomics: the order is the documented one.
//
// Tried on the card and left out (PERF.md, PR 24): one block per (row,
// 32 columns) with all of a partial's loads issued at once (slower than
// the first design at most shapes); 32 KB stages; three stages; tiles of
// 64 or 128 columns; a block serving every row of a head, or pairs of
// rows (bytes fall to the distinct heads', time does not).  Compiled with
// -DH1_PHASE_TRACE, lane 0 of the first 16 blocks stamps each phase
// (tools/head_compare.py --trace).
//
// A tenant index outside [0, cap) reads nothing and gives a NaN row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;              // columns a block: one warp's lanes
constexpr int THREADS = 256;        // eight warps
constexpr int STAGES = 4;           // the ring of chunks in shared memory
constexpr int STAGE_BYTES = 16384;  // weights a stage
constexpr int MAX_P = 16;
constexpr int MAX_S = 16;           // cluster size (16: non-portable)
constexpr int V2_BATCH = 16;        // 2-byte loads in flight a thread
constexpr int BATCH = 8;            // chain steps whose operands load at once
constexpr int MAX_CHAINS = MAX_P * TC / THREADS;  // a thread's

#ifdef H1_PHASE_TRACE
// tools/head_compare.py --trace: for the first 16 blocks, lane 0 of warp 0
// stamps %globaltimer (ns) at its start and clock64 at each phase mark
constexpr int TRACE_MARKS = 8;
__device__ unsigned long long h1_trace[16][TRACE_MARKS + 1];
#define H1_MARK(i)                                                        \
  do {                                                                    \
    if (threadIdx.x == 0 && blockIdx.x < 16) {                            \
      if ((i) == 0) {                                                     \
        unsigned long long g;                                             \
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));             \
        h1_trace[blockIdx.x][TRACE_MARKS] = g;                            \
      }                                                                   \
      h1_trace[blockIdx.x][i] = clock64();                                \
    }                                                                     \
  } while (0)
#else
#define H1_MARK(i) \
  do {             \
  } while (0)
#endif

template <typename T>
struct Geometry {
  // d rows a stage: 128 f32, 256 bf16
  static constexpr int CH = STAGE_BYTES / (TC * static_cast<int>(sizeof(T)));
  // ws, fs, part: 69,632 bytes f32, 71,680 bf16 (three blocks an SM)
  static constexpr int SMEM =
      STAGES * (STAGE_BYTES + CH * 4) + MAX_P * TC * 4;
};

struct Args {
  const float* feats;
  const int* idx;
  const void* kernel;
  const void* bias;
  float* out;
  int n, cap, D, C, P, S, tiles;
};

__device__ __forceinline__ float widen(float w) { return w; }
__device__ __forceinline__ float widen(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

// cp.async of V bytes (4, 8 or 16)
template <int V>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(V));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most STAGES - 2 of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Stores v at `smem` (an address of this block's shared memory) in block
// `rank` of the cluster.
__device__ __forceinline__ void st_rank_f32(float* smem, int rank, float v) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(s), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}

// The block's rows, chunk by chunk: chunk m holds offsets [m*CJ, m*CJ +
// cj) of each of its PG partials (shared row q*CJ + jj is d = d0 + q*L +
// m*CJ + jj) for columns [c0, c0 + TC).
struct Chunks {
  int d0, L, lg_cj, c0, valid_bytes;
  bool head_ok;
};

// The features of the chunk at offset j0: shared [q*CJ + jj].
template <typename T>
__device__ __forceinline__ void stage_features(const Chunks& g, float* fs,
                                               const float* frow, int j0) {
  constexpr int CH = Geometry<T>::CH;
  const int CJ = 1 << g.lg_cj;
  const int cj = min(CJ, g.L - j0);
  for (int i = threadIdx.x; i < CH; i += THREADS) {
    const int q = i >> g.lg_cj, jj = i & (CJ - 1);
    if (jj < cj) cp_async<4>(fs + i, frow + g.d0 + q * g.L + j0 + jj);
  }
}

// Rows past cj and columns past C are not copied (no chain of theirs is
// stored).
template <typename T, int V>
__device__ __forceinline__ void stage_weights(const Args& a, const Chunks& g,
                                              T* ws, const T* head, int j0) {
  constexpr int CH = Geometry<T>::CH;
  const int CJ = 1 << g.lg_cj;
  const int cj = min(CJ, g.L - j0);
  const int tid = threadIdx.x;
  if constexpr (V >= 4) {
    constexpr int CPR = TC * static_cast<int>(sizeof(T)) / V;  // copies a row
    constexpr int RSTEP = THREADS / CPR;
    const int seg = tid % CPR;
    if (!g.head_ok || seg * V >= g.valid_bytes) return;
#pragma unroll
    for (int s = tid / CPR; s < CH; s += RSTEP) {
      const int q = s >> g.lg_cj, jj = s & (CJ - 1);
      if (jj < cj)
        cp_async<V>(reinterpret_cast<char*>(ws + s * TC) + seg * V,
                    reinterpret_cast<const char*>(
                        head + static_cast<size_t>(g.d0 + q * g.L + j0 + jj) *
                                   a.C + g.c0) + seg * V);
    }
  } else {
    // bf16 rows of odd C: 2-byte loads, V2_BATCH in flight before stores
    constexpr int RSTEP = THREADS / TC;
    const int c = tid % TC;
    if (!g.head_ok || c * 2 >= g.valid_bytes) return;
    const unsigned short* h16 = reinterpret_cast<const unsigned short*>(head);
    unsigned short* w16 = reinterpret_cast<unsigned short*>(ws);
    for (int s0 = tid / TC; s0 < CH; s0 += RSTEP * V2_BATCH) {
      unsigned short v[V2_BATCH];
#pragma unroll
      for (int b = 0; b < V2_BATCH; ++b) {
        const int s = s0 + b * RSTEP;
        const int q = s >> g.lg_cj, jj = s & (CJ - 1);
        v[b] = jj < cj ? __ldg(h16 + static_cast<size_t>(g.d0 + q * g.L +
                                                         j0 + jj) *
                                         a.C + g.c0 + c)
                       : static_cast<unsigned short>(0);
      }
#pragma unroll
      for (int b = 0; b < V2_BATCH; ++b)
        w16[(s0 + b * RSTEP) * TC + c] = v[b];
    }
  }
}

// acc += f[jj] * w[jj * TC] for jj < cj, in order, one rounding each; the
// operands of BATCH steps are read before their adds.
template <typename T>
__device__ __forceinline__ float chain(float acc, const float* f, const T* w,
                                       int cj) {
  int jj = 0;
  for (; jj + BATCH <= cj; jj += BATCH) {
    float fv[BATCH], wv[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      fv[u] = f[jj + u];
      wv[u] = widen(w[(jj + u) * TC]);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      acc = __fadd_rn(acc, __fmul_rn(fv[u], wv[u]));
  }
  for (; jj < cj; ++jj)
    acc = __fadd_rn(acc, __fmul_rn(f[jj], widen(w[jj * TC])));
  return acc;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
head_fanout_kernel(const Args a) {
  constexpr int CH = Geometry<T>::CH;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);  // [STAGES][CH][TC]
  float* fs = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* part = fs + STAGES * CH;  // fs [STAGES][CH], part [P][TC]

  H1_MARK(0);
  const int S = a.S;
  if (S > 1) cluster_arrive_relaxed();  // this rank has started
  // rows inner to tiles: rows that share a head read its tile together
  const int k = blockIdx.x % S;  // = %cluster_ctarank: clusters are (S,1,1)
  const int r = (blockIdx.x / S) % a.n;
  const int t = blockIdx.x / (S * a.n);
  const int tid = threadIdx.x, lane = tid % TC;
  const int PG = a.P / S;
  const int L = a.D / a.P;
  Chunks g;
  g.lg_cj = __ffs(CH / PG) - 1;  // CJ = CH / PG, a power of two
  const int CJ = 1 << g.lg_cj;
  g.L = L;
  g.c0 = t * TC;
  g.d0 = k * PG * L;
  g.valid_bytes = min(TC, a.C - g.c0) * static_cast<int>(sizeof(T));
  const int chunks = L > 0 ? (L + CJ - 1) / CJ : 0;

  // the features do not wait for the tenant index
  const float* frow = a.feats + static_cast<size_t>(r) * a.D;
  for (int m = 0; m < STAGES - 1 && m < chunks; ++m)
    stage_features<T>(g, fs + m * CH, frow, m * CJ);
  const int h = __ldg(a.idx + r);
  g.head_ok = h >= 0 && h < a.cap;
  const T* head = static_cast<const T*>(a.kernel) +
                  (g.head_ok ? static_cast<size_t>(h) * a.D * a.C : 0);
  const int col = g.c0 + lane;
  const bool writer = k == 0 && tid < TC && col < a.C;
  float b = 0.f;  // rank 0's bias, in flight through the whole pass
  if (writer && g.head_ok)
    b = widen(static_cast<const T*>(a.bias)[static_cast<size_t>(h) * a.C +
                                            col]);
  H1_MARK(1);
  for (int m = 0; m < STAGES - 1; ++m) {
    if (m < chunks) stage_weights<T, V>(a, g, ws + m * CH * TC, head, m * CJ);
    cp_async_commit();  // one group a chunk, empty past the last
  }
  H1_MARK(2);

  // this thread's chains: (partial q, column lane) for q = tid / TC + i *
  // THREADS / TC below PG
  float acc[MAX_CHAINS];
#pragma unroll
  for (int i = 0; i < MAX_CHAINS; ++i) acc[i] = 0.f;
  for (int m = 0; m < chunks; ++m) {
    cp_async_wait_ring();  // chunk m has landed (this thread's copies)
    __syncthreads();  // ... every thread's copies; chunk m - 1 is consumed
    if (m == 0) H1_MARK(3);
    const int next = m + STAGES - 1;
    if (next < chunks) {
      const int nb = next % STAGES;
      stage_features<T>(g, fs + nb * CH, frow, next * CJ);
      stage_weights<T, V>(a, g, ws + nb * CH * TC, head, next * CJ);
    }
    cp_async_commit();
    const int cb = m % STAGES;
    const int cj = min(CJ, L - m * CJ);
    const T* w = ws + cb * CH * TC + lane;
    const float* f = fs + cb * CH;
#pragma unroll
    for (int i = 0; i < MAX_CHAINS; ++i) {
      const int q = tid / TC + i * (THREADS / TC);
      if (q < PG) acc[i] = chain(acc[i], f + q * CJ, w + q * CJ * TC, cj);
    }
  }
  H1_MARK(4);  // every chain of this thread has run
  // every rank's partials into rank 0's table, in partial order
  if (S > 1) cluster_wait();  // every rank has started: its memory is live
  H1_MARK(5);
#pragma unroll
  for (int i = 0; i < MAX_CHAINS; ++i) {
    const int q = tid / TC + i * (THREADS / TC);
    if (q < PG) {
      float* dst = part + (k * PG + q) * TC + lane;
      if (k == 0) *dst = acc[i]; else st_rank_f32(dst, 0, acc[i]);
    }
  }
  if (S > 1) {
    cluster_arrive_release();  // this rank's partials are stored
    if (k != 0) return;        // rank 0 reads nothing of the others
    cluster_wait_acquire();    // ... every rank's
  } else {
    __syncthreads();
  }
  H1_MARK(6);
  if (writer) {
    float y;
    if (!g.head_ok) {
      y = __int_as_float(0x7fc00000);  // a tenant index outside the bank
    } else {
      float p[MAX_P];
#pragma unroll
      for (int i = 0; i < MAX_P; ++i)
        p[i] = i < a.P ? part[i * TC + lane] : 0.f;
      y = p[0];
#pragma unroll
      for (int i = 1; i < MAX_P; ++i)
        if (i < a.P) y = __fadd_rn(y, p[i]);
      y = __fadd_rn(y, b);
    }
    a.out[static_cast<size_t>(r) * a.C + col] = y;
  }
  H1_MARK(7);
}

template <typename T, int V>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  auto* kernel = head_fanout_kernel<T, V>;
  static const cudaError_t configured = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Geometry<T>::SMEM);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  if (configured != cudaSuccess) return configured;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.n * a.tiles * a.S), 1, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Geometry<T>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.S;  // grid x = n * tiles * S: whole clusters
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The widest copy, of 16, 8 or 4 bytes, that every row segment of the bank
// is aligned to (row strides of C * esize bytes from `kernel`, tiles of 32
// columns); 2 for bf16 rows no cp.async takes.
int copy_bytes(const void* kernel, int C, int esize) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(kernel);
  for (int v = 16; v >= 4; v /= 2)
    if ((static_cast<long long>(C) * esize) % v == 0 && p % v == 0) return v;
  return 2;
}

}  // namespace

extern "C" {

// Launches H1 on `stream` with P partials (ops/head.py::head_partials(D))
// over clusters of S blocks (ops/head.py::_head_plan) and weights of type
// `wdtype` (0 = f32, 1 = bf16), and returns the launch's CUDA error (0 =
// launched).  P must divide D and be 1, 2, 4, 8 or 16, S divide P and be at
// most 16; n >= 1, C >= 1.
int head_fanout_launch(const void* feats, const void* idx, const void* kernel,
                       const void* bias, void* out, int n, int cap, int D,
                       int C, int P, int S, int wdtype, void* stream) {
  const int tiles = (C + TC - 1) / TC;
  const bool ok = n >= 1 && C >= 1 && D >= 0 && cap >= 1 &&
                  (P == 1 || P == 2 || P == 4 || P == 8 || P == 16) &&
                  D % P == 0 && S >= 1 && S <= MAX_S && P % S == 0 &&
                  (wdtype == 0 || wdtype == 1) &&
                  static_cast<long long>(n) * tiles * S <= INT_MAX;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(feats), static_cast<const int*>(idx),
               kernel, bias, static_cast<float*>(out), n, cap, D, C, P, S,
               tiles};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (wdtype == 0) {
    switch (copy_bytes(kernel, C, 4)) {
      case 16: return static_cast<int>(launch<float, 16>(a, s));
      case 8: return static_cast<int>(launch<float, 8>(a, s));
      case 4: return static_cast<int>(launch<float, 4>(a, s));
      default: return static_cast<int>(cudaErrorMisalignedAddress);
    }
  }
  switch (copy_bytes(kernel, C, 2)) {
    case 16: return static_cast<int>(launch<__nv_bfloat16, 16>(a, s));
    case 8: return static_cast<int>(launch<__nv_bfloat16, 8>(a, s));
    case 4: return static_cast<int>(launch<__nv_bfloat16, 4>(a, s));
    default: return static_cast<int>(launch<__nv_bfloat16, 2>(a, s));
  }
}

#ifdef H1_PHASE_TRACE
int head_fanout_trace(unsigned long long* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, h1_trace, sizeof(h1_trace)));
}
#endif

const char* head_fanout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
