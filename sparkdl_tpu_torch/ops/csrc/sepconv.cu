// Fused separable convolution + inference BatchNorm for Hopper (sm_90a).
//
// Replaces sparkdl_tpu/ops/sepconv.py::_fused_sepconv_tpu (Pallas kernel
// _sepconv_kernel).  Computes, for one NHWC bf16 image batch,
//
//     out = bf16( post_relu?( pointwise(bf16(depthwise3x3(pre_relu?(x))))
//                             * scale + shift ) )
//
// with the rounding points of the TPU kernel: x widened to f32 (ReLU
// exact), 9-tap depthwise accumulated in f32, the depthwise result rounded
// to bf16, bf16 x bf16 pointwise with f32 accumulation, the BatchNorm
// affine in f32, bf16 store.  Depthwise 3x3, stride 1, SAME zero padding
// (masked by coordinates, no padded layout), depth multiplier 1.
//
// What bounds it on an H100.  By its operations and bytes, 2*N*H*W*C*(9+F)
// against (N*H*W*(C+F) + 9*C + C*F) * 2: Xception's middle and exit flow
// (C >= 728) sit above the card's ~295 ops/byte bf16 ridge, so the tensor
// cores bound them, and block4's 256->728 layer sits below it.  In practice
// neither bound is near.  Every 64-pixel tile streams its pointwise
// weights from L2 again (64 operations per byte of L2 traffic) through
// 16-byte cp.async copies, the depthwise reads its input window from
// shared memory, and both go through the SM's load/store pipe.  A clock64
// trace of one block (tools/sepconv_compare.py --trace; numbers in
// PERF.md) shows where an iteration goes: warpgroup 0 issuing the copies
// and warpgroups 1-2 computing the depthwise take most of it, side by
// side, and issuing the products holds each warp for as long as the
// tensor cores take to accept them; waiting for the products, for the
// copies and at the barrier takes little.
//
// Design.  A block owns 64 output pixels (flattened over N*H*W, so 10x10
// images still fill tiles; the wgmma M) and one group of F tiles, each
// 3*NT wide: one NT-wide third per warpgroup, NT the wgmma N (64-128).
// The S blocks of a pixel tile ("F groups") split F between them, so a
// pixel's depthwise is computed S times; the kernel before computed it once
// per 256-wide F tile.  ops/sepconv.py::_sepconv_plan picks S, NT, the C
// chunk KC and the ring depth per shape from a model of waves over 132 SMs;
// at batch 32 it takes S=1 at 37x37 (685 blocks), S=2 at 19x19 (362) and
// S=2 at 10x10 (100).
//
// Two phases per block, in one loop over its (F tile, C chunk) pairs
// through an NS-stage cp.async ring with one barrier per iteration.
// Phase 1 is the first F tile: a slot holds the chunk's input window (the
// tile's pixels plus one image row and one pixel on each side: every 3x3
// neighbour; neighbours outside the image are masked by coordinates, not
// read), its 9 taps and its pointwise chunk [KC][3*NT]; warpgroups 1-2
// compute the next chunk's bf16 depthwise into a resident A tile
// [64][round_up(C, 64)] while warpgroup 0 issues the copies and the tensor
// cores run this chunk's products.  Phase 2 is every later F tile:
// pointwise chunks only, against the resident A, so each pixel's depthwise
// is computed once for all the F the block covers.  Windows are loaded
// three iterations ahead and pointwise chunks NS-1 ahead.  The epilogue
// (affine, ReLU, bf16, 16-byte stores) follows each F tile.
//
// Product: wgmma.mma_async m64nNTk16 (wgmma.cuh), both operands from
// shared memory through descriptors, in 8x8 core matrices of 128
// contiguous bytes, no swizzle: A K-major (the depthwise stores one core
// matrix row, 8 channels of a pixel, per 16-byte store), B MN-major (N
// contiguous, as pw is; one 16-byte cp.async moves one core-matrix row).
// Issuing a product holds the warp until the tensor cores take it, so
// warpgroup 0 issues its copies before its products and warpgroups 1-2
// their products before the depthwise.  cp.async and not TMA stages the
// ring: TMA needs a tensor map built on the host through the driver API,
// left for a later version.  A tail of C past a multiple of 16 (728 =
// 45*16 + 8) is zero in both A and B.  C and F must be multiples of 8
// (every Xception width is).
//
// Three warpgroups and not four: 384 threads leave 170 registers a thread
// (four spill at 128), and not two: 8 warps hide too little latency.
//
// Known waste, for later versions: the copies and the depthwise's shared
// loads share the load/store pipe, and a 16-byte cp.async stalls its warp
// while earlier ones are in flight (TMA would take the copies off it); one
// 384-thread block per SM (the resident tile is 32-192 KB), so the phases
// of an iteration wait on each other at its barrier rather than overlap
// across blocks; each 64-pixel tile re-reads its pointwise weights from L2
// (TMA multicast across a cluster would share them); F tiles after the
// first do not overlap a depthwise, and an epilogue overlaps nothing; 728 =
// 2*384 - 40 wastes 5% of the product in the last tile; at C=1536 the
// resident tile leaves room only for 16-channel chunks, so that class runs
// 576 short iterations a block and, at 8 channels a depthwise thread,
// leaves warpgroup 2 without depthwise work.

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int P = 64;          // output pixels per block: the wgmma M
constexpr int WGS = 3;         // warpgroups: a third of an F tile each
constexpr int THREADS = 128 * WGS;
constexpr int COPIERS = 128;   // warpgroup 0 issues the copies,
constexpr int DWT = THREADS - COPIERS;  // warpgroups 1-2 compute the depthwise
constexpr int PIX = 64 * 8 / DWT;  // most pixels a depthwise thread takes

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// 8-channel groups of a pixel row of the resident A tile (C rounded up to
// a whole 64-wide chunk).
__host__ __device__ constexpr int a_groups(int C) { return round_up(C, 64) / 8; }

// bf16 elements of one ring stage: the window [P+2W+2][KC], the taps
// [9][KC] and the pointwise chunk [TN/8][KC][8].
__host__ __device__ constexpr int stage_elems(int W, int TN, int KC) {
  return (P + 2 * W + 2 + 9) * KC + KC * TN;
}

// Shared memory of a launch: the resident A tile, then the ring.
__host__ __device__ constexpr int smem_bytes_for(int W, int C, int TN, int KC,
                                                 int NS) {
  return 2 * P * 8 * a_groups(C) + 2 * NS * stage_elems(W, TN, KC);
}

#ifdef SEPCONV_PHASE_TRACE
// Built only by tools/sepconv_compare.py --trace: clock64 at seven points
// of each of the first 128 iterations of one block, and after the epilogue
// at the last iteration of an F tile, read by thread 0 of each warpgroup,
// [warpgroup][iteration][point].
__device__ long long sepconv_trace[WGS][128][8];
__device__ int sepconv_trace_block;
#define SEPCONV_TRACE(point) \
  if (traced) sepconv_trace[wg][it][point] = clock64()
#else
#define SEPCONV_TRACE(point)
#endif

template <int NT, bool PRE_RELU, bool POST_RELU>
__global__ void __launch_bounds__(THREADS, 1)
sepconv_kernel(const __nv_bfloat16* __restrict__ x,      // [N, H, W, C]
               const __nv_bfloat16* __restrict__ dwk,    // [3, 3, C]
               const __nv_bfloat16* __restrict__ pw,     // [C, F]
               const float* __restrict__ scale,          // [F]
               const float* __restrict__ shift,          // [F]
               __nv_bfloat16* __restrict__ out,          // [N, H, W, F]
               int N, int H, int W, int C, int F, int groups,
               int tiles_per_group, int KC, int NS) {
  constexpr int TN = WGS * NT;  // F tile: one NT-wide third per warpgroup
  extern __shared__ __align__(128) unsigned char smem[];
  // The resident A tile in K-major 8x8 core matrices: pixel m, channel k
  // at ((m/8) * KG + k/8) * 64 + (m%8) * 8 + k%8.
  const int KG = a_groups(C);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = As + P * 8 * KG;  // NS stages
  const int WIN = P + 2 * W + 2;
  const int SE = stage_elems(W, TN, KC);

  const int HW = H * W;
  const int NHW = N * HW;
  const int grp = blockIdx.x % groups;
  const int p0 = (blockIdx.x / groups) * P;
  const int q0 = p0 - W - 1;  // flattened pixel of the window's first row
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates
  const int wg = warp >> 2;                // warpgroup: its third of a tile
  const int wr = (warp & 3) * 16;          // the warp's 16 rows of the tile

  const int K2 = round_up(C, 16);
  const int nk = (K2 + KC - 1) / KC;  // C chunks per F tile
  const int f_first = grp * tiles_per_group * TN;
  const int tiles = min(tiles_per_group, (F - f_first + TN - 1) / TN);
  const int T = tiles * nk;  // ring iterations: (tile, chunk) in order
  const int L = NS - 1;      // prefetch distance: iteration it loads it+L

  // Warpgroup 0 issues every copy and warpgroups 1-2 compute the
  // depthwise, so the copies and the depthwise arithmetic run side by side;
  // all three run the products.
  const bool copier = tid < COPIERS;
  const int ht = copier ? tid : tid - COPIERS;  // index within its role
  // A depthwise thread's work in every chunk: channels cs..cs+7 (one
  // 16-byte shared load per tap) of up to two pixels, with the 3x3 taps
  // inside the image as a 9-bit mask.
  const int sh = KC == 64 ? 3 : KC == 32 ? 2 : 1;  // log2(KC / 8)
  const int cs = (ht & ((KC >> 3) - 1)) * 8;
  int pix[PIX];
  unsigned taps_in[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int pl = (ht >> sh) + k * (DWT >> sh);
    const int p = p0 + pl;
    pix[k] = pl < P ? pl : -1;
    taps_in[k] = 0;
    if (pl < P && p < NHW) {
      const int rem = p % HW;
      const int h = rem / W, w = rem - h * W;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hh = h + tap / 3 - 1, ww = w + tap % 3 - 1;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) taps_in[k] |= 1u << tap;
      }
    }
  }

  // One cp.async group's copies: the input window and taps of chunk
  // `itw` (first F tile only: itw < nk) into the window part of its ring
  // slot, and the pointwise chunk of iteration `it` (it < T) into the
  // pointwise part of its slot, where core matrix (k/8, n/8) sits at
  // ((n/8) * KC + k) * 8: eight neighbouring threads fill one core matrix
  // (128 contiguous bytes).
  auto load = [&](int itw, int it) {
    const int t = it / nk, c0 = (it - t * nk) * KC;
    __nv_bfloat16* st = ring + (it % NS) * SE;
    if (itw < nk) {
      const int cw = itw * KC;
      __nv_bfloat16* sw = ring + (itw % NS) * SE;
      __nv_bfloat16* ks = sw + WIN * KC;
      for (int i = ht; i < 9 * (KC >> 3); i += COPIERS) {
        const int tap = i >> sh, c = cw + (i & ((KC >> 3) - 1)) * 8;
        const bool ok = c < C;
        cp_async16(ks + i * 8, ok ? dwk + tap * C + c : dwk, ok);
      }
      for (int i = ht; i < WIN * (KC >> 3); i += COPIERS) {
        const int q = q0 + (i >> sh), c = cw + (i & ((KC >> 3) - 1)) * 8;
        const bool ok = q >= 0 && q < NHW && c < C;
        cp_async16(sw + i * 8, ok ? x + (size_t)q * C + c : x, ok);
      }
    }
    __nv_bfloat16* bs = st + (WIN + 9) * KC;
    const int f0 = f_first + t * TN;
    if (it < T) {
      for (int i = ht; i < KC * (TN / 8); i += COPIERS) {
        const int ng = (i >> 3) % (TN / 8);
        const int k = ((i >> 3) / (TN / 8)) * 8 + (i & 7);
        const int c = c0 + k, f = f0 + ng * 8;
        const bool ok = c < C && f < F;
        cp_async16(bs + (ng * KC + k) * 8, ok ? pw + (size_t)c * F + f : pw,
                   ok);
      }
    }
  };

  // Depthwise of chunk c0 from the stage into the resident A.  Every load
  // is issued before the arithmetic, so their latencies overlap; a window
  // position is always inside the stage, and taps outside the image are
  // dropped by the mask afterwards.
  auto depthwise = [&](const __nv_bfloat16* st, int c0) {
    const __nv_bfloat16* ks = st + WIN * KC;
    uint4 kv[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      kv[tap] = *reinterpret_cast<const uint4*>(ks + tap * KC + cs);
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      if (pix[k] < 0) continue;
      uint4 xv[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        xv[tap] = *reinterpret_cast<const uint4*>(
            st + (pix[k] + (tap / 3) * W + tap % 3) * KC + cs);
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        if (!((taps_in[k] >> tap) & 1)) continue;
        uint32_t xw[4] = {xv[tap].x, xv[tap].y, xv[tap].z, xv[tap].w};
        const uint32_t kw[4] = {kv[tap].x, kv[tap].y, kv[tap].z, kv[tap].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (PRE_RELU) xw[j] = relu_bf16x2(xw[j]);
          const float2 v = unpack_bf16x2(xw[j]);
          const float2 kk = unpack_bf16x2(kw[j]);
          a[2 * j] = fmaf(v.x, kk.x, a[2 * j]);
          a[2 * j + 1] = fmaf(v.y, kk.y, a[2 * j + 1]);
        }
      }
      // the TPU kernel's rounding point: depthwise accumulator -> bf16
      uint4 packed;
      packed.x = pack_bf16x2(a[0], a[1]);
      packed.y = pack_bf16x2(a[2], a[3]);
      packed.z = pack_bf16x2(a[4], a[5]);
      packed.w = pack_bf16x2(a[6], a[7]);
      *reinterpret_cast<uint4*>(
          &As[((pix[k] >> 3) * KG + ((c0 + cs) >> 3)) * 64 +
              (pix[k] & 7) * 8]) = packed;
    }
  };

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

  // Epilogue of F tile t: BatchNorm affine in f32, optional ReLU, bf16
  // pairs, then the quad transpose (common.cuh) gives lane t4 all eight
  // columns of block 4q+t4 of rows g and g+8, stored as one 16-byte write,
  // so a warp writes 64 contiguous bytes per row rather than 16.
  auto epilogue = [&](int t) {
    const int fw = f_first + t * TN + wg * NT;
#pragma unroll
    for (int q = 0; q < NT / 32; ++q) {
      uint32_t v[2][4];  // [half][j]: row g + 8*half, block 4q+j
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nb = q * 4 + j;
        // clamped so that a block past F loads in bounds; it is not stored
        const int fc = min(fw + nb * 8 + t4 * 2, F - 2);
        const float2 sc = *reinterpret_cast<const float2*>(scale + fc);
        const float2 sf = *reinterpret_cast<const float2*>(shift + fc);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float y0 = acc[nb * 4 + half * 2] * sc.x + sf.x;
          float y1 = acc[nb * 4 + half * 2 + 1] * sc.y + sf.y;
          if (POST_RELU) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          v[half][j] = pack_bf16x2(y0, y1);
        }
      }
      const int f = fw + (q * 4 + t4) * 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 piece = quad_transpose(v[half], t4);  // block 4q+t4
        const int p = p0 + wr + g + half * 8;
        if (p < NHW && f < F)
          *reinterpret_cast<uint4*>(out + (size_t)p * F + f) = piece;
      }
    }
  };

  // Pointwise chunks are loaded L = NS-1 iterations ahead and windows three
  // ahead at either ring depth (a window is read one iteration before its
  // chunk's products): group g holds pointwise chunk g and window g+3-L,
  // the prologue's last group windows L-1..2.  So at the end of iteration
  // it, pointwise chunk it+1 and window it+2 have landed once every group
  // but the newest has.  Prologue: groups 0..L-1 in flight; windows 0 and
  // 1 and pointwise chunk 0 landed, the depthwise of chunk 0 in A.
  for (int s = 0; s < L; ++s) {
    if (copier) {
      load(s, s);
      if (s == L - 1 && L == 2) load(2, T);
    }
    cp_async_commit();
  }
  if (L == 3)
    cp_async_wait_group<1>();
  else
    cp_async_wait_group<0>();
  fence_proxy_async_shared();  // cp.async writes -> the tensor cores
  __syncthreads();
  if (!copier) depthwise(ring, 0);
  fence_proxy_async_shared();  // depthwise stores -> the tensor cores
  __syncthreads();

  // Iteration `it` starts with the A columns of its chunk complete, its
  // pointwise chunk and window it+1 landed; one barrier per iteration keeps
  // that so.
  for (int t = 0; t < tiles; ++t) {
    for (int j = 0; j < nk; ++j) {
      const int it = t * nk + j;
#ifdef SEPCONV_PHASE_TRACE
      const bool traced = blockIdx.x == sepconv_trace_block &&
                          (tid & 127) == 0 && it < 128;
#endif
      SEPCONV_TRACE(0);
      const int c0 = j * KC;
      const int steps = min(KC, K2 - c0) >> 4;
      const __nv_bfloat16* bs =
          ring + (it % NS) * SE + (WIN + 9) * KC + wg * NT * KC;
      const __nv_bfloat16* as = As + (c0 >> 3) * 64;
      // Warpgroup 0 first refills the pointwise part of slot it-1 with
      // chunk it+L and sends window it+3 to its slot (whose window the
      // depthwise read one iteration ago at NS=3, two at NS=4).  Issuing a
      // product holds a warp until the tensor cores take it, so warpgroup
      // 0 issues its products after its copies, while warpgroups 1-2 issue
      // theirs first and then compute the next chunk's depthwise (first F
      // tile only) on the CUDA cores.
      if (copier) load(it + 3, it + L);
      cp_async_commit();
      SEPCONV_TRACE(1);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (s < steps)
          wgmma_ss<NT>(acc, wgmma_desc(as + s * 2 * 64, 128, KG * 128),
                       wgmma_desc(bs + s * 16 * 8, 128, KC * 16),
                       j > 0 || s > 0);
      wgmma_commit();
      SEPCONV_TRACE(2);
      if (!copier && it + 1 < nk)
        depthwise(ring + ((it + 1) % NS) * SE, c0 + KC);
      SEPCONV_TRACE(3);

      wgmma_wait<0>();
      wgmma_fence_operand(acc);
      SEPCONV_TRACE(4);
      if (it + 1 < T) {
        // pointwise chunk it+1 and window it+2 landed
        cp_async_wait_group<1>();
        SEPCONV_TRACE(5);
        fence_proxy_async_shared();
        __syncthreads();
      }
      SEPCONV_TRACE(6);
    }
    epilogue(t);
#ifdef SEPCONV_PHASE_TRACE
    const int it = t * nk + nk - 1;
    const bool traced = blockIdx.x == sepconv_trace_block &&
                        (tid & 127) == 0 && it < 128;
#endif
    SEPCONV_TRACE(7);
  }
}

struct Args {
  const __nv_bfloat16 *x, *dwk, *pw;
  const float *scale, *shift;
  __nv_bfloat16* out;
  int N, H, W, C, F, groups, tiles_per_group, KC, NS;
};

template <int NT, bool PRE_RELU, bool POST_RELU>
cudaError_t launch(int blocks, int smem, cudaStream_t s, const Args& a) {
  static cudaError_t configured = cudaFuncSetAttribute(
      sepconv_kernel<NT, PRE_RELU, POST_RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  sepconv_kernel<NT, PRE_RELU, POST_RELU><<<blocks, THREADS, smem, s>>>(
      a.x, a.dwk, a.pw, a.scale, a.shift, a.out, a.N, a.H, a.W, a.C, a.F,
      a.groups, a.tiles_per_group, a.KC, a.NS);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_relu(bool pre, bool post, int blocks, int smem,
                        cudaStream_t s, const Args& a) {
  if (pre && post) return launch<NT, true, true>(blocks, smem, s, a);
  if (pre) return launch<NT, true, false>(blocks, smem, s, a);
  if (post) return launch<NT, false, true>(blocks, smem, s, a);
  return launch<NT, false, false>(blocks, smem, s, a);
}

}  // namespace

extern "C" {

// Launches on `stream` with the plan of ops/sepconv.py::_sepconv_plan
// (F groups per pixel tile, F tiles per group, wgmma width n_tile, C chunk
// kc, ring stages, shared-memory bytes) and returns the launch's CUDA error
// (0 = launched); cudaErrorInvalidValue for a plan this library does not
// instantiate or that does not cover F.
int sepconv_launch(const void* x, const void* dwk, const void* pw,
                   const void* scale, const void* shift, void* out, int N,
                   int H, int W, int C, int F, int pre_relu, int post_relu,
                   int groups, int tiles_per_group, int n_tile, int kc,
                   int stages, int smem, void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % 8 || F % 8)
    return invalid;
  if ((n_tile != 64 && n_tile != 96 && n_tile != 128) ||
      (kc != 16 && kc != 32 && kc != 64) || (stages != 3 && stages != 4))
    return invalid;
  const long long tn = (long long)WGS * n_tile;
  if (groups < 1 || tiles_per_group < 1 ||
      (long long)groups * tiles_per_group * tn < F ||
      (long long)(groups - 1) * tiles_per_group * tn >= F)
    return invalid;
  if (smem != smem_bytes_for(W, C, WGS * n_tile, kc, stages) || smem > MAX_SMEM)
    return invalid;
  const long long blocks =
      ((long long)N * H * W + P - 1) / P * (long long)groups;
  if (blocks > 0x7fffffffLL) return invalid;
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(dwk),
               static_cast<const __nv_bfloat16*>(pw),
               static_cast<const float*>(scale),
               static_cast<const float*>(shift),
               static_cast<__nv_bfloat16*>(out),
               N, H, W, C, F, groups, tiles_per_group, kc, stages};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool pre = pre_relu != 0, post = post_relu != 0;
  const int nb = static_cast<int>(blocks);
  cudaError_t err;
  if (n_tile == 64)
    err = launch_relu<64>(pre, post, nb, smem, s, a);
  else if (n_tile == 96)
    err = launch_relu<96>(pre, post, nb, smem, s, a);
  else
    err = launch_relu<128>(pre, post, nb, smem, s, a);
  return static_cast<int>(err);
}

#ifdef SEPCONV_PHASE_TRACE
// Clears the trace and sets the traced block (host == nullptr), or copies
// the trace to host.
int sepconv_trace_read(void* host, int block) {
  if (host != nullptr)
    return static_cast<int>(
        cudaMemcpyFromSymbol(host, sepconv_trace, sizeof(sepconv_trace)));
  static const long long zeros[WGS * 128 * 8] = {};
  cudaError_t err = cudaMemcpyToSymbol(sepconv_trace, zeros, sizeof(zeros));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(sepconv_trace_block, &block, sizeof(int));
  return static_cast<int>(err);
}
#endif

const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
