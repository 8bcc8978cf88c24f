// Fused MobileNetV2 inverted-residual tail for Hopper (sm_90a).
//
// Replaces sparkdl_tpu/ops/sepconv.py::_fused_mbconv_tpu (Pallas kernel
// _mbconv_kernel).  Computes, for one NHWC bf16 batch, with both BatchNorm
// scales already folded into the weights by the caller,
//
//     out = bf16( pointwise(bf16(clip(depthwise3x3(x) + mid_shift, 0, 6)))
//                 + shift )
//
// with the TPU kernel's rounding points: x and the folded weights in bf16,
// the 9-tap depthwise accumulated in f32, +mid_shift and the relu6 clamp
// in f32, the result rounded to bf16 before the product (B1 rounds the raw
// depthwise sum instead; this is the one difference), bf16 x bf16 product
// with f32 accumulation, +shift in f32, bf16 store.  Depthwise 3x3,
// stride 1, SAME zero padding, multiplier 1.  Only the order of the f32
// sum over C differs from a sequential walk (see the cluster split below).
//
// What bounds it on an H100.  Every MobileNetV2 class sits at 17 to 213
// operations per byte, below the card's ~295 bf16 ridge, so the bound is
// bytes: x [N*H*W, C] read once, out [N*H*W, F] written once.
//   * 112x112 to 28x28 (thousands to hundreds of 64-pixel tiles, 1 to 6
//     chunks of C each): bytes, and what a tile stages beyond its own
//     pixels is the waste.  A flattened tile of 64 pixels needs a window of
//     64 + 2W + 2 pixels (4.5x its outputs at W = 112, 2.8x at 56), re-read
//     from L2 by its neighbours.  There a block takes 2-D tiles of 8x8
//     pixels of one image and stages their 10x10 frame (1.56x; the frame
//     outside the image is zero-filled by cp.async, which is the SAME
//     padding itself).  The host's plan (ops/sepconv.py::_mbconv_plan)
//     takes whichever tile kind stages fewer pixels, so 28x28 and below
//     keep the flattened tile, which fills tiles across images.
//   * 14x14 and 7x7 (98 and 25 tiles for 132 SMs, 12 to 30 chunks each):
//     latency.  A lone block walking C = 960 in 30 serial chunks leaves the
//     card idle.  There the C walk is split across a thread-block cluster
//     of S = 2, 4 or 8 blocks that share one pixel tile and one F tile:
//     each walks its own contiguous slice of the C chunks (the ragged end
//     zero-filled) and keeps its partial f32 [64][TF] product in its own
//     shared memory (over the dead ring); after a cluster barrier block r
//     sums rows r*64/S .. (r+1)*64/S of all S partials through distributed
//     shared memory, in rank order (no atomics: the same result every
//     run), adds shift and stores bf16 rows; a second barrier keeps every
//     partial alive until its readers are done.
//
// Block: 4 warps, 16 of a tile's 64 pixels each, x TF = 8*NT output
// channels (NT from {2,3,4,8,12,20}, the narrowest tile that holds F;
// F = 320 takes two).  Each warp computes relu6(depthwise + mid_shift) of
// its own 16 pixels for a KC-channel chunk (KC = 32 or 64) into its rows of
// the A tile, so a __syncwarp, not a block barrier, separates it from the
// warp's mma.sync m16n8k16 products.  One __syncthreads per item guards a
// 2-4 stage cp.async ring of items (the chunk's mid_shift [KC], pointwise
// rows [KC][TF], taps [9][KC] and window [WIN][KC]); an item is one chunk
// of one tile, and without a split a block walks several tiles, the ring
// running on across them, and stores each tile straight from the
// fragments.  The depthwise is the block's largest cost: its taps are
// unpacked once per chunk for all of a lane's pixels, and the flattened
// tile's edge masks are applied without branches.  The product stays on
// mma.sync (at these intensities the tensor cores never set the pace) and
// the copies on cp.async.  C and F must be multiples of 8.

#include "common.cuh"

namespace {

constexpr int P = 64;          // output pixels per tile
constexpr int THREADS = 128;   // 4 warps, 16 pixels each
constexpr int TILE = 8;        // 2-D tile: TILE x TILE pixels of one image
constexpr int FRAME = TILE + 2;

// Row strides (elements) that keep ldmatrix rows and fragment stores on
// distinct banks: A and B rows an odd number of 16-byte units apart, the
// f32 partial rows 8 words past a multiple of 32.
__host__ __device__ constexpr int lda_for(int KC) { return KC + 8; }
__host__ __device__ constexpr int ldb_for(int TF) {
  return (TF / 8) % 2 ? TF + 16 : TF + 8;
}
__host__ __device__ constexpr int ldp_for(int TF) {
  return (TF - 8 + 31) / 32 * 32 + 8;
}

__host__ __device__ constexpr int window_for(bool tile2d, int W) {
  return tile2d ? FRAME * FRAME : P + 2 * W + 2;
}

// bf16 elements of one ring stage: the chunk's mid_shift [KC] (f32), the
// pointwise rows [KC][LDB], the taps [9][KC] and the input window [WIN][KC].
__host__ __device__ constexpr int stage_elems_for(bool tile2d, int TF, int KC,
                                                  int W) {
  return 2 * KC + KC * ldb_for(TF) + 9 * KC + window_for(tile2d, W) * KC;
}

// Bytes of shared memory of a launch: the A tile [P][LDA] and the ring, or
// (cluster split only) the f32 partial tile [P][LDP] that overwrites them
// after the walk, whichever is larger; then the F tile's shift [TF] (f32).
// ops/sepconv.py::_mbconv_smem mirrors it.
__host__ __device__ constexpr int smem_bytes_for(bool tile2d, int TF, int KC,
                                                 int W, int stages, int S) {
  const int main =
      2 * P * lda_for(KC) + stages * 2 * stage_elems_for(tile2d, TF, KC, W);
  const int part = S > 1 ? 4 * P * ldp_for(TF) : 0;
  return (main > part ? main : part) + 4 * TF;
}

// Four 8x8 b16 matrices (the m16k16 A fragment of a row-major [m][k] tile);
// lane l gives the address of row (l & 15), column 8 * (l >> 4).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Thread-block clusters: this block's rank, the barrier over the cluster
// (release / acquire: shared-memory writes before it are seen after it),
// and 16-byte reads of another block's shared memory.
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned map_rank(const void* smem, int rank) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(s), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster_f4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

template <int N>
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  // cp.async.wait_group takes an immediate: at most N - 1 groups pending
  if (N > 2 && pending >= 2) cp_async_wait_group<2>();
  else if (pending >= 1) cp_async_wait_group<1>();
  else cp_async_wait_group<0>();
}

#ifdef MBCONV_PHASE_TRACE
// Built only by tools/mbconv_compare.py --trace.  clock64 of lane 0 of
// each warp of one block, at point 0 (start), 1 (first copies issued), then
// five per ring item (a chunk of one tile) of the first 16 (item landed,
// barrier passed, next copies issued, depthwise done, products and the
// tile's stores done) and four at the end (partial tile may be written,
// partial tile written and the cluster synchronised, rows stored, end);
// and %globaltimer at the start and end of every block (by linear block
// index, the first 16384).
constexpr int TRACE_POINTS = 2 + 5 * 16 + 4;
__device__ long long mbconv_trace[4][TRACE_POINTS];
__device__ unsigned long long mbconv_spans[16384][2];
__device__ int mbconv_trace_block;
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#define MBCONV_TRACE(point) \
  if (traced) mbconv_trace[warp][point] = clock64()
#define MBCONV_TRACE_ITEM(i, point) \
  if (traced && (i) < 16) mbconv_trace[warp][2 + 5 * (i) + (point)] = clock64()
#else
#define MBCONV_TRACE(point)
#define MBCONV_TRACE_ITEM(i, point)
#endif

struct Args {
  const __nv_bfloat16* x;     // [N, H, W, C]
  const __nv_bfloat16* dwk;   // [3, 3, C], folded
  const __nv_bfloat16* pw;    // [C, F], folded
  const float* mid_shift;     // [C]
  const float* shift;         // [F]
  __nv_bfloat16* out;         // [N, H, W, F]
  int N, H, W, C, F;
};

// Where pixel tile t starts: p0 (flattened) or image n, row h0, column w0.
struct Origin {
  int p0, n, h0, w0;
};

template <bool TILE2D>
__device__ __forceinline__ Origin origin_of(int t, int tiles_w,
                                            int tiles_hw) {
  Origin o{0, 0, 0, 0};
  if (TILE2D) {
    o.n = t / tiles_hw;
    const int r = t - o.n * tiles_hw;
    o.h0 = (r / tiles_w) * TILE;
    o.w0 = (r % tiles_w) * TILE;
  } else {
    o.p0 = t * P;
  }
  return o;
}

// The grid is (S x F tiles, G).  Block (x, y) is rank x % S of its cluster
// and walks pixel tiles y, y + G, y + 2G, ... < tiles (one tile when S > 1),
// each over its rank's slice of the C chunks; the ring runs on across
// tiles, so a block's next tile loads while this one computes.
template <int NT, int KC, bool TILE2D>
__global__ void __launch_bounds__(THREADS, 4)
mbconv_kernel(const Args a, int S, int stages, int tiles_w, int tiles_hw,
              int tiles) {
  constexpr int TF = 8 * NT;
  constexpr int LDA = lda_for(KC), LDB = ldb_for(TF), LDP = ldp_for(TF);
  constexpr int SEGS = KC / 8;              // 16-byte segments of a chunk row
  constexpr int ITEMS = 16 * SEGS / 32;     // depthwise segments per lane
  static_assert(32 % SEGS == 0, "a lane keeps one segment column");
  const int H = a.H, W = a.W, C = a.C, F = a.F;
  const int HW = H * W, NHW = a.N * HW;
  const int WIN = window_for(TILE2D, W);
  const int ROW = TILE2D ? FRAME : W;       // window offset of one image row

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [P][LDA]
  __nv_bfloat16* ring = As + P * LDA;  // stages x stage_elems
  float* part = reinterpret_cast<float*>(smem);  // [P][LDP], S > 1, at the end
  const int stage_elems = stage_elems_for(TILE2D, TF, KC, W);
  float* shift_s = reinterpret_cast<float*>(
      smem + smem_bytes_for(TILE2D, TF, KC, W, stages, S) - 4 * TF);

  const int rank = S > 1 ? cluster_rank() : 0;  // blockIdx.x % S
  const int f0 = (blockIdx.x / S) * TF;
  const int G = gridDim.y;
  // this rank's slice of the C chunks: [k0, k0 + chunks)
  const int nk = (C + KC - 1) / KC;
  const int k0 = rank * nk / S;
  const int chunks = (rank + 1) * nk / S - k0;
  const int items = (tiles - blockIdx.y + G - 1) / G * chunks;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int wm = warp * 16;                // warp's pixel offset in the tile
  const int seg = (lane % SEGS) * 8;       // this lane's channel offset
#ifdef MBCONV_PHASE_TRACE
  const long long block_id = blockIdx.x + (long long)gridDim.x * blockIdx.y;
  const bool traced = block_id == mbconv_trace_block && lane == 0;
  if (tid == 0 && block_id < 16384) mbconv_spans[block_id][0] = global_ns();
#endif
  MBCONV_TRACE(0);

  for (int i = tid; i < TF; i += THREADS)
    shift_s[i] = f0 + i < F ? a.shift[f0 + i] : 0.f;  // read after a barrier

  // Copies of chunk k of pixel tile t into ring stage st (one group).
  auto load = [&](int t, int k, int st) {
    const Origin o = origin_of<TILE2D>(t, tiles_w, tiles_hw);
    const int c0 = k * KC;
    float* ms = reinterpret_cast<float*>(ring + st * stage_elems);
    __nv_bfloat16* bs = ring + st * stage_elems + 2 * KC;
    __nv_bfloat16* ks = bs + KC * LDB;
    __nv_bfloat16* xs = ks + 9 * KC;
    for (int i = tid; i < KC / 4; i += THREADS) {
      const bool ok = c0 + 4 * i < C;
      cp_async16(ms + 4 * i, ok ? a.mid_shift + c0 + 4 * i : a.mid_shift, ok);
    }
    for (int i = tid; i < KC * NT; i += THREADS) {
      const int kk = i / NT, fs = (i % NT) * 8;
      const int c = c0 + kk, f = f0 + fs;
      const bool ok = c < C && f < F;
      cp_async16(bs + kk * LDB + fs, ok ? a.pw + (size_t)c * F + f : a.pw, ok);
    }
    for (int i = tid; i < 9 * SEGS; i += THREADS) {
      const int tap = i / SEGS, cs = (i % SEGS) * 8;
      const bool ok = c0 + cs < C;
      cp_async16(ks + tap * KC + cs, ok ? a.dwk + tap * C + c0 + cs : a.dwk,
                 ok);
    }
    for (int i = tid; i < WIN * SEGS; i += THREADS) {
      const int r = i / SEGS, cs = (i % SEGS) * 8;
      const int c = c0 + cs;
      const __nv_bfloat16* src = a.x;
      bool ok;
      if (TILE2D) {
        const int hh = o.h0 - 1 + r / FRAME, ww = o.w0 - 1 + r % FRAME;
        ok = hh >= 0 && hh < H && ww >= 0 && ww < W && c < C;
        if (ok) src = a.x + (((size_t)o.n * H + hh) * W + ww) * C + c;
      } else {
        const int q = o.p0 - W - 1 + r;
        ok = q >= 0 && q < NHW && c < C;
        if (ok) src = a.x + (size_t)q * C + c;
      }
      cp_async16(xs + r * KC + cs, src, ok);
    }
    cp_async_commit();
  };

  // The ring's producer cursor: the next item to load.
  int ld_t = blockIdx.y, ld_k = 0, ld_st = 0, loaded = 0;
  auto load_next = [&]() {
    if (loaded < items) {
      load(ld_t, k0 + ld_k, ld_st);
      ++loaded;
      if (++ld_k == chunks) ld_k = 0, ld_t += G;
      if (++ld_st == stages) ld_st = 0;
    } else {
      cp_async_commit();  // an empty group keeps the wait counts uniform
    }
  };
  for (int s = 0; s + 1 < stages; ++s) load_next();
  MBCONV_TRACE(1);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  // This lane's depthwise pixels in the current tile: window index of the
  // centre tap and the taps inside the image (the flattened window holds
  // other rows and other images at the edges, so those are masked by
  // coordinates, without branches; the 2-D frame is zero-filled instead).
  int centre[ITEMS];
  unsigned taps[ITEMS];
  Origin o{0, 0, 0, 0};
  int t = blockIdx.y, k = 0, st = 0;  // the consumer cursor
  for (int it = 0; it < items; ++it) {
    cp_async_wait_upto<4>(stages - 2);
    MBCONV_TRACE_ITEM(it, 0);
    __syncthreads();  // item it landed; every warp is done with item it - 1
    MBCONV_TRACE_ITEM(it, 1);
    load_next();      // into the stage item it - 1 used
    MBCONV_TRACE_ITEM(it, 2);
    if (k == 0) {
      o = origin_of<TILE2D>(t, tiles_w, tiles_hw);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int pl = wm + lane / SEGS + j * (32 / SEGS);
        if (TILE2D) {
          centre[j] = (pl / TILE + 1) * FRAME + pl % TILE + 1;
          taps[j] = 0x1ff;
        } else {
          const int p = o.p0 + pl;
          centre[j] = pl + W + 1;
          taps[j] = 0;
          if (p < NHW) {
            const int rem = p % HW;
            const int h = rem / W, w = rem - h * W;
#pragma unroll
            for (int tap = 0; tap < 9; ++tap) {
              const int hh = h + tap / 3 - 1, ww = w + tap % 3 - 1;
              if (hh >= 0 && hh < H && ww >= 0 && ww < W) taps[j] |= 1u << tap;
            }
          }
        }
      }
    }
    const float* ms = reinterpret_cast<const float*>(ring + st * stage_elems);
    const __nv_bfloat16* bs = ring + st * stage_elems + 2 * KC;
    const __nv_bfloat16* ks = bs + KC * LDB;
    const __nv_bfloat16* xs = ks + 9 * KC;

    // A rows of this warp: relu6(depthwise + mid_shift), rounded to bf16
    // (the TPU kernel's rounding point).  Taps outside: a tap's 8 weights
    // are unpacked once for the lane's ITEMS pixels.  Channels past C are
    // zero in x, the taps and mid_shift alike, so they give 0.
    float v[ITEMS][8];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint4 kv = *reinterpret_cast<const uint4*>(ks + tap * KC + seg);
      const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
      float kf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 k2 = unpack_bf16x2(kw[e]);
        kf[2 * e] = k2.x;
        kf[2 * e + 1] = k2.y;
      }
      const int off = (tap / 3 - 1) * ROW + tap % 3 - 1;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        // the window always holds the tap's row; one outside the image
        // reads as zero
        const uint4 xv = *reinterpret_cast<const uint4*>(
            xs + (centre[j] + off) * KC + seg);
        const uint32_t keep = TILE2D || ((taps[j] >> tap) & 1) ? ~0u : 0u;
        const uint32_t xw[4] = {xv.x & keep, xv.y & keep, xv.z & keep,
                                xv.w & keep};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x2 = unpack_bf16x2(xw[e]);
          v[j][2 * e] = fmaf(x2.x, kf[2 * e], v[j][2 * e]);
          v[j][2 * e + 1] = fmaf(x2.y, kf[2 * e + 1], v[j][2 * e + 1]);
        }
      }
    }
    const float4 m0 = *reinterpret_cast<const float4*>(ms + seg);
    const float4 m1 = *reinterpret_cast<const float4*>(ms + seg + 4);
    const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      float r[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] = fminf(fmaxf(v[j][e] + m[e], 0.f), 6.f);
      uint4 packed;
      packed.x = pack_bf16x2(r[0], r[1]);
      packed.y = pack_bf16x2(r[2], r[3]);
      packed.z = pack_bf16x2(r[4], r[5]);
      packed.w = pack_bf16x2(r[6], r[7]);
      const int pl = wm + lane / SEGS + j * (32 / SEGS);
      *reinterpret_cast<uint4*>(&As[pl * LDA + seg]) = packed;
    }
    __syncwarp();  // the warp's A rows are written
    MBCONV_TRACE_ITEM(it, 3);

#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, As + (wm + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, bs + (kk + (lane & 15)) * LDB + nt * 8);
        mma_16816(acc[nt], af, b);
      }
    }

    if (++k == chunks && S == 1) {
      // The tile's rows of this warp, + shift in f32, straight from the
      // fragments as bf16 pairs (no barrier: the ring runs on).
      size_t row_at[2];
      bool row_ok[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm + g + half * 8;
        if (TILE2D) {
          const int hh = o.h0 + r / TILE, ww = o.w0 + r % TILE;
          row_ok[half] = hh < H && ww < W;
          row_at[half] = (((size_t)o.n * H + hh) * W + ww) * F;
        } else {
          row_ok[half] = o.p0 + r < NHW;
          row_at[half] = (size_t)(o.p0 + r) * F;
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int fl = nt * 8 + t4 * 2;
        if (f0 + fl < F) {
          const float s0 = shift_s[fl], s1 = shift_s[fl + 1];
#pragma unroll
          for (int half = 0; half < 2; ++half)
            if (row_ok[half])
              *reinterpret_cast<uint32_t*>(a.out + row_at[half] + f0 + fl) =
                  pack_bf16x2(acc[nt][2 * half] + s0,
                              acc[nt][2 * half + 1] + s1);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
      }
    }
    if (k == chunks) k = 0, t += G;
    if (++st == stages) st = 0;
    MBCONV_TRACE_ITEM(it, 4);
  }

  if (S > 1) {
    // One tile.  Partial [P][TF] f32 tile over the dead ring and A tile.
    cp_async_wait_all();
    __syncthreads();
    MBCONV_TRACE(TRACE_POINTS - 4);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* row = part + (wm + g) * LDP + nt * 8 + t4 * 2;
      *reinterpret_cast<float2*>(row) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(row + 8 * LDP) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
    cluster_sync();  // every rank's partial tile is written
    MBCONV_TRACE(TRACE_POINTS - 3);

    // Rows [rank * P/S, (rank+1) * P/S): the sum of all S partials in
    // rank order, + shift, 16-byte bf16 stores of 8 channels.
    const int rows = P / S;
    for (int i = tid; i < rows * NT; i += THREADS) {
      const int r = rank * rows + i / NT, fs = (i % NT) * 8;
      const int f = f0 + fs;
      if (f >= F) continue;
      size_t at;
      if (TILE2D) {
        const int hh = o.h0 + r / TILE, ww = o.w0 + r % TILE;
        if (hh >= H || ww >= W) continue;
        at = (((size_t)o.n * H + hh) * W + ww) * F + f;
      } else {
        const int p = o.p0 + r;
        if (p >= NHW) continue;
        at = (size_t)p * F + f;
      }
      // every rank's 8 values first (one round trip), then the sum in
      // rank order
      const float* mine = part + r * LDP + fs;
      float4 lo[8], hi[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q < S) {
          const unsigned src = map_rank(mine, q);
          lo[q] = ld_cluster_f4(src);
          hi[q] = ld_cluster_f4(src + 16);
        }
      }
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q < S) {
          v[0] += lo[q].x; v[1] += lo[q].y; v[2] += lo[q].z; v[3] += lo[q].w;
          v[4] += hi[q].x; v[5] += hi[q].y; v[6] += hi[q].z; v[7] += hi[q].w;
        }
      }
      const float4 s0 = *reinterpret_cast<const float4*>(shift_s + fs);
      const float4 s1 = *reinterpret_cast<const float4*>(shift_s + fs + 4);
      uint4 packed;
      packed.x = pack_bf16x2(v[0] + s0.x, v[1] + s0.y);
      packed.y = pack_bf16x2(v[2] + s0.z, v[3] + s0.w);
      packed.z = pack_bf16x2(v[4] + s1.x, v[5] + s1.y);
      packed.w = pack_bf16x2(v[6] + s1.z, v[7] + s1.w);
      *reinterpret_cast<uint4*>(a.out + at) = packed;
    }
    MBCONV_TRACE(TRACE_POINTS - 2);
    cluster_sync();  // no rank leaves while its partials are read
    MBCONV_TRACE(TRACE_POINTS - 1);
  }
#ifdef MBCONV_PHASE_TRACE
  if (tid == 0 && block_id < 16384) mbconv_spans[block_id][1] = global_ns();
#endif
}

template <int NT, int KC, bool TILE2D>
cudaError_t launch(const Args& a, int S, int stages, int grid_y, int smem,
                   cudaStream_t stream) {
  auto* kernel = mbconv_kernel<NT, KC, TILE2D>;
  static cudaError_t configured = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  constexpr int TF = 8 * NT;
  const int f_tiles = (a.F + TF - 1) / TF;
  const int tiles_w = TILE2D ? (a.W + TILE - 1) / TILE : 1;
  const int tiles_hw = TILE2D ? (a.H + TILE - 1) / TILE * tiles_w : 1;
  const long long tiles = TILE2D ? (long long)a.N * tiles_hw
                                 : ((long long)a.N * a.H * a.W + P - 1) / P;
  // every block has a tile; a split block exactly one
  if (grid_y < 1 || grid_y > 65535 || grid_y > tiles ||
      (S > 1 && grid_y != tiles))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S * f_tiles, grid_y, 1);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;  // grid x = S * F tiles: whole clusters
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, a, S, stages, tiles_w, tiles_hw, static_cast<int>(tiles));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_nt(const Args& a, bool tile2d, int S, int kc, int stages,
                      int grid_y, int smem, cudaStream_t s) {
  if (kc == 32)
    return tile2d ? launch<NT, 32, true>(a, S, stages, grid_y, smem, s)
                  : launch<NT, 32, false>(a, S, stages, grid_y, smem, s);
  return tile2d ? launch<NT, 64, true>(a, S, stages, grid_y, smem, s)
                : launch<NT, 64, false>(a, S, stages, grid_y, smem, s);
}

}  // namespace

extern "C" {

// Launches the plan (tile kind, cluster size S, F tile, C chunk, ring
// stages, blocks per F tile and rank, shared-memory bytes) chosen by
// ops/sepconv.py::_mbconv_plan on `stream`, and returns the launch's CUDA
// error (0 = launched).  A plan this library does not instantiate is
// refused (cudaErrorInvalidValue).
int mbconv_launch(const void* x, const void* dwk, const void* pw,
                  const void* mid_shift, const void* shift, void* out, int N,
                  int H, int W, int C, int F, int tile2d, int S, int f_tile,
                  int kc, int stages, int grid_y, int smem, void* stream) {
  const bool plan_ok =
      (tile2d == 0 || tile2d == 1) && (S == 1 || S == 2 || S == 4 || S == 8) &&
      (kc == 32 || kc == 64) && stages >= 2 && stages <= 4 &&
      (C + kc - 1) / kc >= S && C % 8 == 0 && F % 8 == 0 &&
      smem >= smem_bytes_for(tile2d, f_tile, kc, W, stages, S) &&
      smem <= MAX_SMEM;
  if (!plan_ok) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(dwk),
               static_cast<const __nv_bfloat16*>(pw),
               static_cast<const float*>(mid_shift),
               static_cast<const float*>(shift),
               static_cast<__nv_bfloat16*>(out), N, H, W, C, F};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool t2 = tile2d == 1;
  cudaError_t err;
  switch (f_tile) {
    case 16: err = launch_nt<2>(a, t2, S, kc, stages, grid_y, smem, s); break;
    case 24: err = launch_nt<3>(a, t2, S, kc, stages, grid_y, smem, s); break;
    case 32: err = launch_nt<4>(a, t2, S, kc, stages, grid_y, smem, s); break;
    case 64: err = launch_nt<8>(a, t2, S, kc, stages, grid_y, smem, s); break;
    case 96: err = launch_nt<12>(a, t2, S, kc, stages, grid_y, smem, s); break;
    case 160: err = launch_nt<20>(a, t2, S, kc, stages, grid_y, smem, s); break;
    default: err = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(err);
}

#ifdef MBCONV_PHASE_TRACE
// Clears the traces and sets the traced block (phases == nullptr), or
// copies the phase trace and then the block spans to host.
int mbconv_trace_read(void* phases, void* spans, int block) {
  if (phases != nullptr) {
    cudaError_t err = cudaMemcpyFromSymbol(phases, mbconv_trace,
                                           sizeof(mbconv_trace));
    if (err == cudaSuccess)
      err = cudaMemcpyFromSymbol(spans, mbconv_spans, sizeof(mbconv_spans));
    return static_cast<int>(err);
  }
  static long long zeros[sizeof(mbconv_spans) / sizeof(long long)] = {};
  cudaError_t err = cudaMemcpyToSymbol(mbconv_trace, zeros,
                                       sizeof(mbconv_trace));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(mbconv_spans, zeros, sizeof(mbconv_spans));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(mbconv_trace_block, &block, sizeof(int));
  return static_cast<int>(err);
}
#endif

const char* mbconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
