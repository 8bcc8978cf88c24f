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
// stride 1, SAME zero padding, multiplier 1.
//
// What bounds it on an H100: Xception's entry blocks 2-3 (147x147 64->128
// and 128->128, 74x74 128->256 and 256->256) sit at 68 to 136 operations
// per byte, below the ~295 bf16 ridge: the bytes bound them.  B1 stages a
// window of P + 2W + 2 flattened pixels for P outputs, which at W = 147 is
// 5.6x the tile and grows with W.  This kernel's Hopper form of "row-tiled"
// is a 2-D tile: TH rows x TW columns of one image, staged with a one-pixel
// frame, so the window is (TH+2) x (TW+2) pixels whatever W is (1.4x the
// tile at 8x16) and shared memory does not depend on W.  The frame outside
// the image is zero-filled by cp.async, which is the SAME padding itself:
// the depthwise reads no coordinates and masks nothing.
//
// Block tile and F tile, chosen per launch by F:
//   F <= 128: 8x16 = 128 pixels x TF = 128 (block2's F = 128 fills it);
//   F >  128: 8x8 = 64 pixels x TF = 256 (block3's F = 256, one tile).
// 8 warps of 32 pixels x 64 channels (mma.sync m16n8k16, f32 accumulators
// in registers).  C is walked in chunks of KC = 64 through a two-stage
// cp.async pipeline staging the pointwise tile [KC][TF], the 9 taps [9][KC]
// and the window [(TH+2)(TW+2)][KC]; the depthwise tile is computed from
// shared memory into the product's A tile, never written to device memory.
// C and F must be multiples of 8.  Grid (F tiles, spatial tiles, N): the
// F tiles of one spatial tile run side by side, so a second F tile reads
// its window from L2.
//
// Known waste, for a later version: the product runs on mma.sync, not
// wgmma; the right and bottom edge tiles (147 = 9x16 + 3) run partly empty.

#include "common.cuh"

namespace {

constexpr int KC = 64;        // input channels per chunk
constexpr int THREADS = 256;  // 8 warps of 32 pixels x 64 channels
constexpr int LDA = KC + 8;   // As row stride (bf16): 144 B

__host__ __device__ constexpr int smem_bytes_for(int TH, int TW, int TF) {
  return 2 * (TH * TW * LDA + 2 * KC * (TF + 8) + 2 * 9 * KC +
              2 * (TH + 2) * (TW + 2) * KC);
}

template <int TH, int TW, int TF, bool PRE_RELU, bool POST_RELU>
__global__ void __launch_bounds__(THREADS, 2)
sepconv_tiled_kernel(const __nv_bfloat16* __restrict__ x,    // [N, H, W, C]
                     const __nv_bfloat16* __restrict__ dwk,  // [3, 3, C]
                     const __nv_bfloat16* __restrict__ pw,   // [C, F]
                     const float* __restrict__ scale,        // [F]
                     const float* __restrict__ shift,        // [F]
                     __nv_bfloat16* __restrict__ out,        // [N, H, W, F]
                     int H, int W, int C, int F, int tiles_w) {
  constexpr int P = TH * TW;
  constexpr int WW = TW + 2;            // window columns
  constexpr int WIN = (TH + 2) * WW;    // window pixels
  constexpr int LDB = TF + 8;           // Bs row stride (bf16)
  constexpr int WM = P / 32;            // warps along pixels
  static_assert(WM * (TF / 64) == THREADS / 32, "8 warps of 32x64");
  static_assert((P * KC / 8) % THREADS == 0, "whole depthwise rounds");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [P][LDA]
  __nv_bfloat16* Bs = As + P * LDA;                             // 2 x [KC][LDB]
  __nv_bfloat16* Ks = Bs + 2 * KC * LDB;                        // 2 x [9][KC]
  __nv_bfloat16* Xs = Ks + 2 * 9 * KC;                          // 2 x [WIN][KC]

  const int f0 = blockIdx.x * TF;
  const int h0 = (blockIdx.y / tiles_w) * TH;
  const int w0 = (blockIdx.y % tiles_w) * TW;
  const int n = blockIdx.z;
  const __nv_bfloat16* xn = x + (size_t)n * H * W * C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int wm = (warp % WM) * 32;         // warp's pixel offset in the tile
  const int wn = (warp / WM) * 64;         // warp's channel offset in the tile

  // Copies of chunk c0 into stage `buf` (one cp.async group).
  auto load_chunk = [&](int c0, int buf) {
    __nv_bfloat16* bs = Bs + buf * KC * LDB;
    for (int i = tid; i < KC * (TF / 8); i += THREADS) {
      const int k = i / (TF / 8), fs = (i % (TF / 8)) * 8;
      const int c = c0 + k, f = f0 + fs;
      const bool ok = c < C && f < F;
      cp_async16(bs + k * LDB + fs, ok ? pw + (size_t)c * F + f : pw, ok);
    }
    __nv_bfloat16* ks = Ks + buf * 9 * KC;
    for (int i = tid; i < 9 * (KC / 8); i += THREADS) {
      const int tap = i / (KC / 8), cs = (i % (KC / 8)) * 8;
      const bool ok = c0 + cs < C;
      cp_async16(ks + tap * KC + cs, ok ? dwk + tap * C + c0 + cs : dwk, ok);
    }
    __nv_bfloat16* xs = Xs + buf * WIN * KC;
    for (int i = tid; i < WIN * (KC / 8); i += THREADS) {
      const int r = i / (KC / 8), cs = (i % (KC / 8)) * 8;
      const int hh = h0 - 1 + r / WW, ww = w0 - 1 + r % WW;
      const int c = c0 + cs;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && c < C;
      cp_async16(xs + r * KC + cs,
                 ok ? xn + ((size_t)hh * W + ww) * C + c : x, ok);
    }
    cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  load_chunk(0, 0);
  for (int c0 = 0, buf = 0; c0 < C; c0 += KC, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk c0 landed; every warp is done with the last chunk
    if (c0 + KC < C) load_chunk(c0 + KC, buf ^ 1);

    // A: depthwise of the tile's P pixels x KC channels from the window.
    const __nv_bfloat16* xs = Xs + buf * WIN * KC;
    const __nv_bfloat16* ks = Ks + buf * 9 * KC;
#pragma unroll
    for (int r = 0; r < (P * KC / 8) / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int pl = i / (KC / 8);
      const int cs = (i % (KC / 8)) * 8;
      const int ty = pl / TW, tx = pl % TW;
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const uint4 xv = *reinterpret_cast<const uint4*>(
              xs + ((ty + dy) * WW + tx + dx) * KC + cs);
          const uint4 kv =
              *reinterpret_cast<const uint4*>(ks + (dy * 3 + dx) * KC + cs);
          const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
          const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float2 v = unpack_bf16x2(xw[j]);
            const float2 k = unpack_bf16x2(kw[j]);
            if (PRE_RELU) {
              v.x = fmaxf(v.x, 0.f);
              v.y = fmaxf(v.y, 0.f);
            }
            a[2 * j] = fmaf(v.x, k.x, a[2 * j]);
            a[2 * j + 1] = fmaf(v.y, k.y, a[2 * j + 1]);
          }
        }
      }
      // the TPU kernel's rounding point: depthwise accumulator -> bf16
      uint4 packed;
      packed.x = pack_bf16x2(a[0], a[1]);
      packed.y = pack_bf16x2(a[2], a[3]);
      packed.z = pack_bf16x2(a[4], a[5]);
      packed.w = pack_bf16x2(a[6], a[7]);
      *reinterpret_cast<uint4*>(&As[pl * LDA + cs]) = packed;
    }
    __syncthreads();

    const __nv_bfloat16* bs = Bs + buf * KC * LDB;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      uint32_t af[2][4], bfr[8][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* a = As + (wm + mt * 16) * LDA + kk + t4 * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(a + g * LDA);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * LDA);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(a + g * LDA + 8);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * LDA + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, bs + (kk + (lane & 15)) * LDB + wn + nt * 8 + (lane >> 4) * 8);
        bfr[nt][0] = r[0];
        bfr[nt][1] = r[1];
        bfr[nt + 1][0] = r[2];
        bfr[nt + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma_16816(acc[mt][nt], af[mt], bfr[nt]);
    }
  }

  // Epilogue: BatchNorm affine in f32, optional ReLU, bf16 pairs; pixels of
  // the tile past the image's edge are not stored.
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int f = f0 + wn + nt * 8 + t4 * 2;
    if (f >= F) continue;
    const float s0 = scale[f], s1 = scale[f + 1];
    const float b0 = shift[f], b1 = shift[f + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int pl = wm + mt * 16 + g + half * 8;
        const int h = h0 + pl / TW, w = w0 + pl % TW;
        if (h >= H || w >= W) continue;
        float y0 = acc[mt][nt][half * 2] * s0 + b0;
        float y1 = acc[mt][nt][half * 2 + 1] * s1 + b1;
        if (POST_RELU) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(
            out + (((size_t)n * H + h) * W + w) * F + f) = pack_bf16x2(y0, y1);
      }
    }
  }
}

template <int TH, int TW, int TF, bool PRE_RELU, bool POST_RELU>
cudaError_t launch(cudaStream_t s, const __nv_bfloat16* x,
                   const __nv_bfloat16* dwk, const __nv_bfloat16* pw,
                   const float* scale, const float* shift,
                   __nv_bfloat16* out, int N, int H, int W, int C, int F) {
  constexpr int smem = smem_bytes_for(TH, TW, TF);
  static_assert(smem <= MAX_SMEM, "tile exceeds shared memory");
  static cudaError_t configured = cudaFuncSetAttribute(
      sepconv_tiled_kernel<TH, TW, TF, PRE_RELU, POST_RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (configured != cudaSuccess) return configured;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid((F + TF - 1) / TF, tiles_h * tiles_w, N);
  sepconv_tiled_kernel<TH, TW, TF, PRE_RELU, POST_RELU>
      <<<grid, THREADS, smem, s>>>(x, dwk, pw, scale, shift, out, H, W, C, F,
                                   tiles_w);
  return cudaGetLastError();
}

template <bool PRE_RELU, bool POST_RELU>
cudaError_t launch_for_f(cudaStream_t s, const __nv_bfloat16* x,
                         const __nv_bfloat16* dwk, const __nv_bfloat16* pw,
                         const float* scale, const float* shift,
                         __nv_bfloat16* out, int N, int H, int W, int C,
                         int F) {
  if (F <= 128)
    return launch<8, 16, 128, PRE_RELU, POST_RELU>(s, x, dwk, pw, scale, shift,
                                                   out, N, H, W, C, F);
  return launch<8, 8, 256, PRE_RELU, POST_RELU>(s, x, dwk, pw, scale, shift,
                                                out, N, H, W, C, F);
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's CUDA error (0 = launched).
int sepconv_tiled_launch(const void* x, const void* dwk, const void* pw,
                         const void* scale, const void* shift, void* out,
                         int N, int H, int W, int C, int F, int pre_relu,
                         int post_relu, void* stream) {
  if (N > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* kb = static_cast<const __nv_bfloat16*>(dwk);
  const auto* pb = static_cast<const __nv_bfloat16*>(pw);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (pre_relu && post_relu)
    err = launch_for_f<true, true>(s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  else if (pre_relu)
    err = launch_for_f<true, false>(s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  else if (post_relu)
    err = launch_for_f<false, true>(s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  else
    err = launch_for_f<false, false>(s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  return static_cast<int>(err);
}

const char* sepconv_tiled_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
