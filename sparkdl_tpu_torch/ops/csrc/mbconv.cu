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
// stride 1, SAME zero padding (masked by coordinates), multiplier 1.
//
// What bounds it on an H100: every MobileNetV2 shape class sits at 17 to
// 247 operations per byte, below the card's ~295 bf16 ridge, so the bytes
// do: x [N*H*W, C] read and out [N*H*W, F] written.  The design reads x
// once and never writes the depthwise intermediate: each block computes
// its depthwise tile straight into shared memory as the product's A
// operand, and the F tile covers all of F (up to 160 channels; F = 320
// takes two tiles), so each pixel's depthwise is computed once.
//
// Block tile: P = 64 output pixels, flattened over N*H*W (so the 7x7 and
// 14x14 stages fill tiles), x TF = 8*NT output channels, NT chosen per
// launch from {2,3,4,8,12,20} as the narrowest tile that holds F: F = 16
// and 24 get 16- and 24-wide tiles, not a 256-wide one.  4 warps, each
// 16 pixels x TF (mma.sync m16n8k16, f32 accumulators in registers).  C
// (up to 960) is walked in chunks of KC = 32 through a two-stage cp.async
// pipeline staging the pointwise tile [KC][TF], the 9 taps [9][KC] and the
// input window [P + 2W + 2][KC]: the tile's flattened pixels plus one
// image row and one pixel on each side.  Everything past C, F or the last
// pixel is zero-filled.  C and F must be multiples of 8.
//
// Known waste, for a later version: the input window is P + 2W + 2 rows
// for P outputs (4.5x at W = 112), re-read from L2 by the neighbouring
// blocks; 64-pixel blocks leave the 7x7 stages with 25 blocks.

#include "common.cuh"

namespace {

constexpr int P = 64;          // output pixels per block
constexpr int KC = 32;         // input channels per chunk
constexpr int THREADS = 128;   // 4 warps, 16 pixels each
constexpr int LDA = KC + 8;    // As row stride (bf16): 80 B

__host__ __device__ constexpr int smem_bytes_for(int TF, int W) {
  return 2 * (P * LDA + 2 * KC * (TF + 8) + 2 * 9 * KC +
              2 * (P + 2 * W + 2) * KC);
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
mbconv_kernel(const __nv_bfloat16* __restrict__ x,       // [N, H, W, C]
              const __nv_bfloat16* __restrict__ dwk,     // [3, 3, C], folded
              const __nv_bfloat16* __restrict__ pw,      // [C, F], folded
              const float* __restrict__ mid_shift,       // [C]
              const float* __restrict__ shift,           // [F]
              __nv_bfloat16* __restrict__ out,           // [N, H, W, F]
              int N, int H, int W, int C, int F) {
  constexpr int TF = 8 * NT;
  constexpr int LDB = TF + 8;  // Bs row stride (bf16), a multiple of 16 B
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [P][LDA]
  __nv_bfloat16* Bs = As + P * LDA;                             // 2 x [KC][LDB]
  __nv_bfloat16* Ks = Bs + 2 * KC * LDB;                        // 2 x [9][KC]
  __nv_bfloat16* Xs = Ks + 2 * 9 * KC;                          // 2 x [WIN][KC]

  const int HW = H * W;
  const int NHW = N * HW;
  const int WIN = P + 2 * W + 2;
  const int f0 = blockIdx.x * TF;
  const int p0 = blockIdx.y * P;
  const int q0 = p0 - W - 1;  // flattened pixel of the window's first row
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment coordinates
  const int wm = warp * 16;                // warp's pixel offset in the tile

  // Copies of chunk c0 into stage `buf` (one cp.async group).
  auto load_chunk = [&](int c0, int buf) {
    __nv_bfloat16* bs = Bs + buf * KC * LDB;
    for (int i = tid; i < KC * NT; i += THREADS) {
      const int k = i / NT, fs = (i % NT) * 8;
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
      const int q = q0 + r, c = c0 + cs;
      const bool ok = q >= 0 && q < NHW && c < C;
      cp_async16(xs + r * KC + cs, ok ? x + (size_t)q * C + c : x, ok);
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;

  load_chunk(0, 0);
  for (int c0 = 0, buf = 0; c0 < C; c0 += KC, buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // chunk c0 landed; every warp is done with the last chunk
    if (c0 + KC < C) load_chunk(c0 + KC, buf ^ 1);

    // A: relu6(depthwise + mid_shift) of P pixels x KC channels.
    const __nv_bfloat16* xs = Xs + buf * WIN * KC;
    const __nv_bfloat16* ks = Ks + buf * 9 * KC;
#pragma unroll
    for (int r = 0; r < (P * KC / 8) / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int pl = i / (KC / 8);
      const int cs = (i % (KC / 8)) * 8;
      const int p = p0 + pl;
      const int c = c0 + cs;
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = 0.f;
      if (p < NHW && c < C) {
        const int rem = p % HW;
        const int h = rem / W, w = rem - h * W;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          const int hh = h + dy;
#pragma unroll
          for (int dx = -1; dx <= 1; ++dx) {
            const int ww = w + dx;
            if (hh < 0 || hh >= H || ww < 0 || ww >= W) continue;
            const uint4 xv = *reinterpret_cast<const uint4*>(
                xs + (pl + W + 1 + dy * W + dx) * KC + cs);
            const uint4 kv = *reinterpret_cast<const uint4*>(
                ks + ((dy + 1) * 3 + (dx + 1)) * KC + cs);
            const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
            const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 v = unpack_bf16x2(xw[j]);
              const float2 k = unpack_bf16x2(kw[j]);
              a[2 * j] = fmaf(v.x, k.x, a[2 * j]);
              a[2 * j + 1] = fmaf(v.y, k.y, a[2 * j + 1]);
            }
          }
        }
        const float4 m0 = __ldg(reinterpret_cast<const float4*>(mid_shift + c));
        const float4 m1 =
            __ldg(reinterpret_cast<const float4*>(mid_shift + c + 4));
        const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = fminf(fmaxf(a[j] + m[j], 0.f), 6.f);
      }
      // the TPU kernel's rounding point: clip(dw + mid_shift) -> bf16
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
      uint32_t af[4];
      const __nv_bfloat16* a = As + wm * LDA + kk + t4 * 2;
      af[0] = *reinterpret_cast<const uint32_t*>(a + g * LDA);
      af[1] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * LDA);
      af[2] = *reinterpret_cast<const uint32_t*>(a + g * LDA + 8);
      af[3] = *reinterpret_cast<const uint32_t*>(a + (g + 8) * LDA + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, bs + (kk + (lane & 15)) * LDB + nt * 8);
        mma_16816(acc[nt], af, b);
      }
    }
  }

  // Epilogue: + project shift in f32, bf16 pairs.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int f = f0 + nt * 8 + t4 * 2;
    if (f >= F) continue;
    const float b0 = shift[f], b1 = shift[f + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm + g + half * 8;
      if (p >= NHW) continue;
      *reinterpret_cast<uint32_t*>(out + (size_t)p * F + f) =
          pack_bf16x2(acc[nt][half * 2] + b0, acc[nt][half * 2 + 1] + b1);
    }
  }
}

template <int NT>
cudaError_t launch(int smem, cudaStream_t s, const __nv_bfloat16* x,
                   const __nv_bfloat16* dwk, const __nv_bfloat16* pw,
                   const float* mid_shift, const float* shift,
                   __nv_bfloat16* out, int N, int H, int W, int C, int F) {
  static cudaError_t configured = cudaFuncSetAttribute(
      mbconv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  constexpr int TF = 8 * NT;
  const dim3 grid((F + TF - 1) / TF, (N * H * W + P - 1) / P);
  mbconv_kernel<NT><<<grid, THREADS, smem, s>>>(x, dwk, pw, mid_shift, shift,
                                                out, N, H, W, C, F);
  return cudaGetLastError();
}

// The F tile (8 * NT channels) a launch with F output channels uses.
int tile_f(int F) {
  if (F <= 16) return 16;
  if (F <= 24) return 24;
  if (F <= 32) return 32;
  if (F <= 64) return 64;
  if (F <= 96) return 96;
  return 160;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's CUDA error (0 = launched).
int mbconv_launch(const void* x, const void* dwk, const void* pw,
                  const void* mid_shift, const void* shift, void* out, int N,
                  int H, int W, int C, int F, void* stream) {
  const int tf = tile_f(F);
  const int smem = smem_bytes_for(tf, W);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* kb = static_cast<const __nv_bfloat16*>(dwk);
  const auto* pb = static_cast<const __nv_bfloat16*>(pw);
  const auto* ms = static_cast<const float*>(mid_shift);
  const auto* sh = static_cast<const float*>(shift);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  switch (tf) {
    case 16: err = launch<2>(smem, s, xb, kb, pb, ms, sh, ob, N, H, W, C, F); break;
    case 24: err = launch<3>(smem, s, xb, kb, pb, ms, sh, ob, N, H, W, C, F); break;
    case 32: err = launch<4>(smem, s, xb, kb, pb, ms, sh, ob, N, H, W, C, F); break;
    case 64: err = launch<8>(smem, s, xb, kb, pb, ms, sh, ob, N, H, W, C, F); break;
    case 96: err = launch<12>(smem, s, xb, kb, pb, ms, sh, ob, N, H, W, C, F); break;
    default: err = launch<20>(smem, s, xb, kb, pb, ms, sh, ob, N, H, W, C, F); break;
  }
  return static_cast<int>(err);
}

const char* mbconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
