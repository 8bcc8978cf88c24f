// Fused separable convolution + inference BatchNorm over 2-D spatial tiles,
// for Hopper (sm_90a): the large entry-flow shapes of Xception.
//
// Replaces sparkdl_tpu/ops/sepconv.py::_fused_sepconv_tpu_tiled (Pallas
// kernel _sepconv_tiled_kernel), which computes B1's function
//
//     out = bf16( post_relu?( pointwise(bf16(depthwise3x3(pre_relu?(x))))
//                             * scale + shift ) )
//
// in tiles of TH image rows for images too large for VMEM.  The rounding
// points are B1's exactly: x widened to f32 (ReLU there), 9-tap depthwise
// accumulated in f32 and rounded to bf16, bf16 x bf16 product with f32
// accumulation, affine in f32, optional ReLU, bf16 store.  Depthwise 3x3,
// stride 1, SAME zero padding, multiplier 1.  C and F must be multiples
// of 8; W may be any width (shared memory does not depend on it).
//
// What bounds it on an H100: Xception's entry blocks 2-3 (147x147 64->128
// and 128->128, 74x74 128->256 and 256->256) sit at 46 to 133 operations
// per byte, below the ~295 bf16 ridge: the bytes bound them (x read once,
// out written once).  The work is to keep the HBM stream busy while the
// CUDA cores compute the depthwise (the largest cost per pixel) and the
// tensor cores the 1x1 product.
//
// Design.  An item is one 2-D tile of TH x TW = 64 pixels of one image (8x8
// or 4x16; the wgmma M) and one F tile of TF = 128 or 256 channels.
//   * Persistent blocks.  The grid is one block per SM; the blocks of F
//     tile ft walk the spatial tiles s, s + S, s + 2S, ... (S blocks per F
//     tile), so at any time the card works on neighbouring tiles and a
//     window's halo comes from L2.
//   * Resident weights.  A block copies its F tile's pointwise slice
//     pw[:, f0:f0+TF] once, in wgmma's B layout (MN-major 8x8 core
//     matrices, no swizzle), with the 9 taps and the F tile's scale and
//     shift; nothing is re-read per tile.  At 256->256 the slice (128 KB)
//     leaves room for a two-stage ring only; the host's plan
//     (ops/sepconv.py::_sepconv_tiled_plan) weighs TF = 256 against TF =
//     128 (two F tiles, the depthwise computed twice) and takes TF = 256:
//     the depthwise and the stores, not the ring, are what a block spends
//     its time on (a sweep of every plan found two stages as fast as six
//     at every class, and took TF = 128 1.3x slower at 256->256).
//   * Input windows by TMA.  One producer thread walks the block's items
//     and 64-channel chunks, and for each issues one 4-D tensor copy of the
//     window [TH+2][TW+2][64] at (c0, w0-1, h0-1, n) into a ring slot; the
//     copy's out-of-bounds zero fill is the SAME padding, so the depthwise
//     masks nothing.  The box lands with the 128-byte swizzle: a pixel's
//     64 channels are one 128-byte row whose 16-byte pieces are permuted by
//     the row's index mod 8, so eight lanes reading one channel group of
//     eight neighbouring pixels hit eight different banks.  Each slot has a
//     "full" mbarrier (expect-tx bytes) and an "empty" one the 128 threads
//     of the warpgroup that owns the item arrive on; the ring runs on
//     across items, so the next items' windows are in flight during this
//     item's work.
//   * Two consumer warpgroups in turn.  Warpgroup w takes the block's
//     items w, w+2, ...: it computes the item's depthwise (a thread: 8
//     channels of 4 vertically adjacent pixels, each loaded window row
//     unpacked once for the pixels it feeds) into its own A tile
//     [64][round_up(C, 64)] in K-major core matrices, then, per 128 columns
//     of the F tile, runs m64n128k16 products from A and the resident B
//     and stores them.  The two warpgroups drift half an item apart, so
//     one's stores and products run under the other's depthwise.  (When
//     both computed every item's depthwise together, their stores and
//     their depthwise alternated for the whole SM, and across SMs as well:
//     HBM idled through the one and the stores queued through the other.)
//   * Epilogue: affine, ReLU, bf16, a quad transpose to 16-byte stores
//     (as sepconv.cu), masked at the image's right and bottom edges.
//
// What sets the pace, and the waste that is left (tools/
// sepconv_tiled_compare.py --trace --grids; PERF.md).  A block moves 6-8
// bytes of x and out per SM cycle, whether 132, 66 or 33 blocks run,
// while the card writes 3 TB/s: the limit is inside the SM.  A warpgroup
// spends 60% as long storing an item's 16 KB (its epilogue) as computing
// its depthwise, and two warpgroups do not hide all of it.  Measured
// before the epilogue's quad transpose stopped indexing a register array
// by lane (local memory): staging the output in shared memory for TMA
// tensor stores was no faster, nor was issuing both 128-column product
// passes of TF = 256 before their stores, and a third warpgroup (152
// registers a thread) was slower.  Also: a tile at the
// right or bottom edge runs partly empty (147 = 18x8 + 3: 7% of the area
// computed at 8x8 tiles; 74 = 9x8 + 2: 17% at 8x8, 11% at 4x16); a window
// stages 1.56x (8x8) or 1.69x (4x16) its tile's pixels, the halo read
// again from L2; the blocks' last items fill part of a wave.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda link

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int KC = 64;            // channels per chunk: one 128-byte row a pixel
constexpr int P = 64;             // pixels per item: the wgmma M
constexpr int CONSUMERS = 256;    // two warpgroups, each its own items
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp (TMA)

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// One ring slot: the window [(TH+2)(TW+2)][KC] bf16, in whole 1024-byte
// swizzle atoms so every slot starts on one.
__host__ __device__ constexpr int slot_bytes(int TH, int TW) {
  return round_up((TH + 2) * (TW + 2) * KC * 2, 1024);
}

// Shared memory of a launch, from a 1024-aligned base (the last 1024 bytes
// are the slack that alignment may take): the ring (NS slots), A (2 x
// [64][KP]), B ([KP][TF]), the taps ([9][KP]), scale and shift ([TF] f32
// each), the mbarriers (two "full" and one "empty" a slot).  KP = C rounded up to a chunk.
// ops/sepconv.py::_sepconv_tiled_smem mirrors it.
__host__ __device__ constexpr int smem_bytes_for(int TH, int TW, int C, int TF,
                                                 int NS) {
  const int KP = round_up(C, KC);
  return NS * slot_bytes(TH, TW) + 2 * P * KP * 2 + KP * TF * 2 + 9 * KP * 2 +
         8 * TF + 24 * NS + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One 4-D tensor copy (TMA) of the box at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory; completes `bar`'s expected bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Barrier 1 + wg over the 128 threads of consumer warpgroup wg (barrier 0
// is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

#ifdef SEPCONV_TILED_PHASE_TRACE
// Built only by tools/sepconv_tiled_compare.py --trace: for thread 0 of
// each consumer warpgroup of one block and each of its first 64 items,
// [warpgroup][item / 2][point]: clock64 at the item's start (0), its
// depthwise done (1) and its end (3); cycles summed over the item's chunks
// or passes spent waiting for windows (2), issuing products (4), waiting
// for them (5) and storing (6).
__device__ long long sepconv_tiled_trace[2][64][8];
__device__ int sepconv_tiled_trace_block;
#define TILED_TRACE(point)          \
  if (traced && i / 2 < 64)         \
  sepconv_tiled_trace[wg][i / 2][point] = clock64()
#define TILED_TRACE_SUM(point)                                        \
  if (traced && i / 2 < 64) {                                         \
    const long long now = clock64();                                  \
    sepconv_tiled_trace[wg][i / 2][point] += now - mark;              \
    mark = now;                                                       \
  }
#else
#define TILED_TRACE(point)
#define TILED_TRACE_SUM(point)
#endif

struct Params {
  const __nv_bfloat16* dwk;  // [3, 3, C]
  const __nv_bfloat16* pw;   // [C, F]
  const float* scale;        // [F]
  const float* shift;        // [F]
  __nv_bfloat16* out;        // [N, H, W, F]
  int H, W, C, F;
  int tiles_w, tiles_hw, tiles;  // spatial tiles: per image row, image, all
  int f_tiles, stages;
};

template <int TH, int TW, int TF, bool PRE_RELU, bool POST_RELU>
__global__ void __launch_bounds__(THREADS, 1)
sepconv_tiled_kernel(const __grid_constant__ CUtensorMap xmap,
                     const Params p) {
  static_assert(TH * TW == P && TW % 8 == 0 && TH % 4 == 0, "64-pixel tiles");
  constexpr int NT = 128;     // columns per product pass: wgmma N
  constexpr int WW = TW + 2;  // window columns
  constexpr int SLOT = slot_bytes(TH, TW);
  constexpr uint32_t WINDOW_BYTES = (TH + 2) * WW * KC * 2;
  const int NS = p.stages;
  const int KP = round_up(p.C, KC);
  const int nk = KP / KC;                 // chunks per item
  const int KG = KP / 8;                  // 8-channel groups of an A row
  const int steps = round_up(p.C, 16) / 16;  // wgmma k16 steps

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(ring + NS * SLOT);
  __nv_bfloat16* Bs = As + 2 * P * KP;  // B (k, n) at ((n/8) * KP + k) * 8 + n%8
  __nv_bfloat16* Ks = Bs + KP * TF;     // taps [9][KP]
  float* sc = reinterpret_cast<float*>(Ks + 9 * KP);
  float* sf = sc + TF;
  // full[w * NS + s]: slot s holds a window of warpgroup w's item (one
  // set per warpgroup, so each waits only for its own uses of a slot, in
  // order: a wait on a parity is unambiguous only one phase ahead);
  // empty[s]: the slot's last use is released (the producer waits in order)
  uint64_t* full = reinterpret_cast<uint64_t*>(sf + TF);
  uint64_t* empty = full + 2 * NS;

  const int tid = threadIdx.x;
  const int ft = blockIdx.x % p.f_tiles;
  const int walker = blockIdx.x / p.f_tiles;
  const int walkers = gridDim.x / p.f_tiles;
  const int f0 = ft * TF;
  const int items =
      walker < p.tiles ? (p.tiles - walker + walkers - 1) / walkers : 0;

  // Once per block: the F tile's pointwise slice, the taps (both zero past
  // C, so the zero-filled channels of the last chunk add nothing), the
  // affine; then the barriers.
  const int C = p.C, F = p.F;
  for (int i = tid; i < KP * (TF / 8); i += THREADS) {
    const int ng = (i >> 3) % (TF / 8);
    const int k = ((i >> 3) / (TF / 8)) * 8 + (i & 7);
    const int f = f0 + ng * 8;
    const bool ok = k < C && f < F;
    cp_async16(Bs + (ng * KP + k) * 8, ok ? p.pw + (size_t)k * F + f : p.pw,
               ok);
  }
  for (int i = tid; i < 9 * (KP / 8); i += THREADS) {
    const int tap = i / (KP / 8), c = (i % (KP / 8)) * 8;
    const bool ok = c < C;
    cp_async16(Ks + tap * KP + c, ok ? p.dwk + tap * C + c : p.dwk, ok);
  }
  cp_async_commit();
  for (int i = tid; i < TF; i += THREADS) {
    sc[i] = f0 + i < F ? p.scale[f0 + i] : 0.f;
    sf[i] = f0 + i < F ? p.shift[f0 + i] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(full + NS + s, 1);
      mbar_init(empty + s, 128);  // the warpgroup that owns the item
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait_all();
  fence_proxy_async_shared();  // cp.async writes -> the tensor cores
  __syncthreads();

  // warp-uniform role (a shuffle, so the compiler knows it): warpgroups 0-1
  // consume, warp 8 produces
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  auto origin = [&](int i, int& n, int& h0, int& w0) {
    const int t = walker + i * walkers;
    n = t / p.tiles_hw;
    const int r = t - n * p.tiles_hw;
    h0 = (r / p.tiles_w) * TH;
    w0 = (r % p.tiles_w) * TW;
  };

  if (wg == 2) {
    // Producer: one thread walks the block's (item, chunk) pairs in order.
    if (tid == CONSUMERS) {
      int slot = 0;
      uint32_t phase = 0;
      for (int i = 0; i < items; ++i) {
        int n, h0, w0;
        origin(i, n, h0, w0);
        for (int k = 0; k < nk; ++k) {
          uint64_t* landed = full + (i & 1) * NS + slot;  // the item's owner
          mbar_wait(empty + slot, phase ^ 1);  // the slot's last use released
          mbar_arrive_expect_tx(landed, WINDOW_BYTES);
          tma_load_4d(ring + slot * SLOT, &xmap, landed, k * KC, w0 - 1,
                      h0 - 1, n);
          if (++slot == NS) slot = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  const int wt = tid & 127;                // thread of the warpgroup
  const int warp = wt >> 5;                // warp of the warpgroup
  const int g = lane >> 2, t4 = lane & 3;  // accumulator fragment coordinates
  const int wr = warp * 16;                // the warp's 16 rows (pixels)
  // Depthwise unit of this thread in every chunk: channels j*8..j*8+7 of
  // the 4 pixels (ty..ty+3, tx).  Lanes 0-7 take eight neighbouring pixels
  // of one channel group: their window reads (swizzled) and their A stores
  // (one core-matrix row each) fall on eight different banks.
  const int unit = wt >> 3;
  const int j = unit & 7;
  const int tx = (lane & 7) + 8 * ((unit >> 3) % (TW / 8));
  const int ty = 4 * ((unit >> 3) / (TW / 8));
  __nv_bfloat16* A = As + wg * P * KP;  // this warpgroup's A tile
#ifdef SEPCONV_TILED_PHASE_TRACE
  const bool traced = blockIdx.x == sepconv_tiled_trace_block && wt == 0;
  long long mark = 0;
#endif

  // Depthwise of chunk c0 of the window in `win` into A.  Taps column by
  // column: a column's 3 taps and the 6 window rows the 4 pixels need are
  // loaded first, each row unpacked once for the (up to 3) pixels it
  // feeds, each tap for all 4.
  auto depthwise = [&](const unsigned char* win, int c0) {
    float acc4[4][8];
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc4[o][e] = 0.f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint4 kv[3], xv[6];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
        kv[dy] = *reinterpret_cast<const uint4*>(Ks + (dy * 3 + dx) * KP + c0 +
                                                 j * 8);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        const int px = (ty + r) * WW + tx + dx;
        xv[r] = *reinterpret_cast<const uint4*>(win + px * 128 +
                                                ((j ^ (px & 7)) << 4));
      }
      float kf[3][8];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t kw[4] = {kv[dy].x, kv[dy].y, kv[dy].z, kv[dy].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 k2 = unpack_bf16x2(kw[e]);
          kf[dy][2 * e] = k2.x;
          kf[dy][2 * e + 1] = k2.y;
        }
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        uint32_t xw[4] = {xv[r].x, xv[r].y, xv[r].z, xv[r].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (PRE_RELU) xw[e] = relu_bf16x2(xw[e]);
          const float2 v = unpack_bf16x2(xw[e]);
#pragma unroll
          for (int o = 0; o < 4; ++o) {
            const int dy = r - o;  // window row r is tap row dy of pixel o
            if (dy >= 0 && dy < 3) {
              acc4[o][2 * e] = fmaf(v.x, kf[dy][2 * e], acc4[o][2 * e]);
              acc4[o][2 * e + 1] =
                  fmaf(v.y, kf[dy][2 * e + 1], acc4[o][2 * e + 1]);
            }
          }
        }
      }
    }
    // the TPU kernel's rounding point: depthwise accumulator -> bf16; A
    // holds pixel m, channel k at ((m/8) * KG + k/8) * 64 + (m%8) * 8 + k%8
    const int kg = (c0 >> 3) + j;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int m = (ty + o) * TW + tx;
      *reinterpret_cast<uint4*>(A + ((m >> 3) * KG + kg) * 64 + (m & 7) * 8) =
          make_uint4(pack_bf16x2(acc4[o][0], acc4[o][1]),
                     pack_bf16x2(acc4[o][2], acc4[o][3]),
                     pack_bf16x2(acc4[o][4], acc4[o][5]),
                     pack_bf16x2(acc4[o][6], acc4[o][7]));
    }
  };

  float acc[NT / 2];

  // Epilogue of pass h (columns h*NT.. of the F tile) of the item at (n,
  // h0, w0): BatchNorm affine in f32, optional ReLU, bf16, then the quad
  // transpose (common.cuh) gives lane t4 all eight columns of block 4q+t4
  // of rows g and g+8, stored as one 16-byte write.
  auto epilogue = [&](int h, int n, int h0, int w0) {
    size_t row_at[2];
    bool row_ok[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wr + g + half * 8;
      const int hh = h0 + m / TW, ww = w0 + m % TW;
      row_ok[half] = hh < p.H && ww < p.W;
      row_at[half] = (((size_t)n * p.H + hh) * p.W + ww) * F;
    }
    const int fl = h * NT;  // the pass's first column in the F tile
#pragma unroll
    for (int q = 0; q < NT / 32; ++q) {
      uint32_t v[2][4];  // [half][jb]: row g + 8*half, block 4q+jb
#pragma unroll
      for (int jb = 0; jb < 4; ++jb) {
        const int nb = q * 4 + jb;
        const float2 s2 =
            *reinterpret_cast<const float2*>(sc + fl + nb * 8 + t4 * 2);
        const float2 b2 =
            *reinterpret_cast<const float2*>(sf + fl + nb * 8 + t4 * 2);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float y0 = acc[nb * 4 + half * 2] * s2.x + b2.x;
          float y1 = acc[nb * 4 + half * 2 + 1] * s2.y + b2.y;
          if (POST_RELU) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          v[half][jb] = pack_bf16x2(y0, y1);
        }
      }
      const int f = f0 + fl + (q * 4 + t4) * 8;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint4 piece = quad_transpose(v[half], t4);  // block 4q+t4
        if (row_ok[half] && f < F)
          *reinterpret_cast<uint4*>(p.out + row_at[half] + f) = piece;
      }
    }
  };

  // Warpgroup wg takes the block's items wg, wg + 2, ...: for each, its
  // windows' depthwise into its own A, then per pass of NT columns the
  // products and the epilogue.  The other warpgroup works on the next item
  // meanwhile, so one's stores and products run under the other's
  // depthwise.  Ring position of chunk k of item i: i * nk + k (the
  // producer's order).
  uint32_t phases = 0;  // bit s: parity of this warpgroup's next use of slot s
  for (int i = wg; i < items; i += 2) {
    TILED_TRACE(0);
    for (int k = 0; k < nk; ++k) {
      const int slot = (i * nk + k) % NS;
#ifdef SEPCONV_TILED_PHASE_TRACE
      mark = clock64();
#endif
      mbar_wait(full + wg * NS + slot, (phases >> slot) & 1);  // landed
      phases ^= 1u << slot;
      TILED_TRACE_SUM(2);
      depthwise(ring + slot * SLOT, k * KC);
      mbar_arrive(empty + slot);  // this thread is done with the slot
    }
    fence_proxy_async_shared();  // depthwise stores -> the tensor cores
    warpgroup_sync(wg);          // A is complete
    TILED_TRACE(1);
    int n, h0, w0;
    origin(i, n, h0, w0);
#pragma unroll
    for (int h = 0; h < TF / NT; ++h) {
#ifdef SEPCONV_TILED_PHASE_TRACE
      mark = clock64();
#endif
      const __nv_bfloat16* b = Bs + h * (NT / 8) * KP * 8;
      wgmma_fence();
      for (int s = 0; s < steps; ++s)
        wgmma_ss<NT>(acc, wgmma_desc(A + s * 2 * 64, 128, KG * 128),
                     wgmma_desc(b + s * 16 * 8, 128, KP * 16), s > 0);
      wgmma_commit();
      TILED_TRACE_SUM(4);
      wgmma_wait<0>();
      wgmma_fence_operand(acc);
      TILED_TRACE_SUM(5);
      epilogue(h, n, h0, w0);
      TILED_TRACE_SUM(6);
    }
    // every warp's products are done before the next depthwise rewrites A
    warpgroup_sync(wg);
    TILED_TRACE(3);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so the library links against the CUDA runtime only.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

template <int TH, int TW, int TF, bool PRE_RELU, bool POST_RELU>
cudaError_t launch(const CUtensorMap& map, const Params& a, int grid,
                   int smem, cudaStream_t s) {
  auto* kernel = sepconv_tiled_kernel<TH, TW, TF, PRE_RELU, POST_RELU>;
  static const cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  kernel<<<grid, THREADS, smem, s>>>(map, a);
  return cudaGetLastError();
}

template <int TH, int TW, int TF>
cudaError_t launch_relu(bool pre, bool post, const CUtensorMap& map,
                        const Params& a, int grid, int smem, cudaStream_t s) {
  if (pre && post) return launch<TH, TW, TF, true, true>(map, a, grid, smem, s);
  if (pre) return launch<TH, TW, TF, true, false>(map, a, grid, smem, s);
  if (post) return launch<TH, TW, TF, false, true>(map, a, grid, smem, s);
  return launch<TH, TW, TF, false, false>(map, a, grid, smem, s);
}

}  // namespace

extern "C" {

// Launches on `stream` with the plan of ops/sepconv.py::_sepconv_tiled_plan
// (tile th x tw, F tile tf, ring stages, blocks, shared-memory bytes) and
// returns the launch's CUDA error (0 = launched): cudaErrorInvalidValue for
// a plan this library does not instantiate or a tensor the copy engine
// cannot describe.  Encodes x's tensor map on every call (x moves between
// calls).
int sepconv_tiled_launch(const void* x, const void* dwk, const void* pw,
                         const void* scale, const void* shift, void* out,
                         int N, int H, int W, int C, int F, int pre_relu,
                         int post_relu, int th, int tw, int tf, int stages,
                         int grid, int smem, void* stream) {
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || C % 8 || F % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return invalid;
  if (!((th == 8 && tw == 8) || (th == 4 && tw == 16)) ||
      (tf != 128 && tf != 256) || stages < 2 || stages > 6)
    return invalid;
  const int f_tiles = (F + tf - 1) / tf;
  if (grid < f_tiles || grid % f_tiles) return invalid;
  if (smem != smem_bytes_for(th, tw, C, tf, stages) || smem > MAX_SMEM)
    return invalid;
  const long long tiles_w = (W + tw - 1) / tw;
  const long long tiles_hw = (H + th - 1) / th * tiles_w;
  const long long tiles = N * tiles_hw;
  if (tiles > 0x7fffffffLL) return invalid;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)(tw + 2),
                             (cuuint32_t)(th + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return invalid;

  const Params a{static_cast<const __nv_bfloat16*>(dwk),
                 static_cast<const __nv_bfloat16*>(pw),
                 static_cast<const float*>(scale),
                 static_cast<const float*>(shift),
                 static_cast<__nv_bfloat16*>(out),
                 H, W, C, F,
                 static_cast<int>(tiles_w), static_cast<int>(tiles_hw),
                 static_cast<int>(tiles), f_tiles, stages};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool pre = pre_relu != 0, post = post_relu != 0;
  cudaError_t err;
  if (th == 8 && tf == 128)
    err = launch_relu<8, 8, 128>(pre, post, map, a, grid, smem, s);
  else if (th == 8)
    err = launch_relu<8, 8, 256>(pre, post, map, a, grid, smem, s);
  else if (tf == 128)
    err = launch_relu<4, 16, 128>(pre, post, map, a, grid, smem, s);
  else
    err = launch_relu<4, 16, 256>(pre, post, map, a, grid, smem, s);
  return static_cast<int>(err);
}

#ifdef SEPCONV_TILED_PHASE_TRACE
// Clears the trace and sets the traced block (host == nullptr), or copies
// the trace to host.
int sepconv_tiled_trace_read(void* host, int block) {
  if (host != nullptr)
    return static_cast<int>(cudaMemcpyFromSymbol(host, sepconv_tiled_trace,
                                                 sizeof(sepconv_tiled_trace)));
  static const long long zeros[2 * 64 * 8] = {};
  cudaError_t err =
      cudaMemcpyToSymbol(sepconv_tiled_trace, zeros, sizeof(zeros));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(sepconv_tiled_trace_block, &block, sizeof(int));
  return static_cast<int>(err);
}
#endif

const char* sepconv_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
