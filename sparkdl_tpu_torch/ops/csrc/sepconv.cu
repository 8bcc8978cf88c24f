// Fused separable convolution + inference BatchNorm for Hopper (sm_90a).
//
// Replaces sparkdl_tpu/ops/sepconv.py::_fused_sepconv_tpu (Pallas kernel
// _sepconv_kernel).  Computes, for one NHWC bf16 image batch,
//
//     out = bf16( post_relu?( pointwise(bf16(depthwise3x3(pre_relu?(x))))
//                             * scale + shift ) )
//
// with the rounding points of the TPU kernel: x widened to f32 (ReLU in
// f32), 9-tap depthwise accumulated in f32, the depthwise result rounded to
// bf16, bf16 x bf16 pointwise with f32 accumulation, the BatchNorm affine
// in f32, bf16 store.  Depthwise 3x3, stride 1, SAME zero padding (masked
// here, no padded layout), depth multiplier 1.
//
// What bounds it on an H100: 2*N*H*W*C*(9+F) operations against
// (N*H*W*(C+F) + 9*C + C*F) * 2 bytes.  Xception's exit and middle flow
// (C >= 728) sit above the card's ~295 ops/byte bf16 ridge, so the tensor
// cores bound them; block4's 256->728 layer sits below it, bound by bytes.
// The design therefore runs the product on the tensor cores (mma.sync
// m16n8k16 bf16, f32 accumulators in registers) and never writes the
// depthwise intermediate to device memory: each block computes its
// depthwise tile straight into shared memory as the A operand, so device
// memory sees x read and out written once (plus re-reads served by L2).
//
// Block tile: P=64 output pixels (flattened over N*H*W, so small images
// do not leave tiles half empty) x TF=256 output channels, 8 warps of
// 32x64 each (a wide F tile, because recomputing the depthwise per F-tile
// is what the CUDA cores spend most on).  The input channels are walked in
// chunks of KC=64 through a two-stage cp.async pipeline: while the block
// computes chunk k, the copies of chunk k+1 are in flight — the pointwise
// tile [KC][TF], the 9 depthwise taps [9][KC] and the input window
// [P + 2W + 2][KC], i.e. the tile's flattened pixels plus one image row and
// one pixel on each side, which holds every 3x3 neighbour of every pixel of
// the tile (neighbours outside the image are masked by coordinates, not
// read).  The depthwise tile is then computed from shared memory (f32 sums,
// bf16 rounding) into the A tile, and the tensor cores take A x B (B
// fragments via ldmatrix.trans).  Everything past C, F or the last pixel is
// zero-filled.  C and F must be multiples of 8 (every Xception width is);
// shared memory grows with W (106 KB at W=19, 115 KB at W=37).
//
// Known waste, the first thing a faster version removes: the depthwise tile
// is recomputed by every F-tile of the same pixels (F/TF = 1..8 times),
// about 1% of the operations times that factor, and the input window is
// re-read from L2 by each of them; the product runs on mma.sync, not wgmma.

#include "common.cuh"

namespace {

constexpr int P = 64;         // output pixels per block
constexpr int TF = 256;       // output channels per block
constexpr int KC = 64;        // input channels per chunk
constexpr int THREADS = 256;  // 8 warps: 2 along pixels x 4 along channels
constexpr int LDA = KC + 8;   // As row stride (bf16): 144 B, conflict-free fragment loads
constexpr int LDB = TF + 8;   // Bs row stride (bf16): 528 B, conflict-free ldmatrix

__host__ __device__ constexpr int smem_bytes_for(int W) {
  return 2 * (P * LDA + 2 * KC * LDB + 2 * 9 * KC + 2 * (P + 2 * W + 2) * KC);
}

template <bool PRE_RELU, bool POST_RELU>
__global__ void __launch_bounds__(THREADS, 2)
sepconv_kernel(const __nv_bfloat16* __restrict__ x,      // [N, H, W, C]
               const __nv_bfloat16* __restrict__ dwk,    // [3, 3, C]
               const __nv_bfloat16* __restrict__ pw,     // [C, F]
               const float* __restrict__ scale,          // [F]
               const float* __restrict__ shift,          // [F]
               __nv_bfloat16* __restrict__ out,          // [N, H, W, F]
               int N, int H, int W, int C, int F) {
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
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment coordinates
  const int wm = (warp & 1) * 32;           // warp's pixel offset in the tile
  const int wn = (warp >> 1) * 64;          // warp's channel offset in the tile

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
      const int q = q0 + r, c = c0 + cs;
      const bool ok = q >= 0 && q < NHW && c < C;
      cp_async16(xs + r * KC + cs, ok ? x + (size_t)q * C + c : x, ok);
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

    // A: depthwise of P pixels x KC channels from the staged window.
    const __nv_bfloat16* xs = Xs + buf * WIN * KC;
    const __nv_bfloat16* ks = Ks + buf * 9 * KC;
#pragma unroll
    for (int r = 0; r < (P * KC / 8) / THREADS; ++r) {
      const int i = tid + r * THREADS;
      const int pl = i / (KC / 8);
      const int cs = (i % (KC / 8)) * 8;
      const int p = p0 + pl;
      float a[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = 0.f;
      if (p < NHW) {
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

  // Epilogue: BatchNorm affine in f32, optional ReLU, bf16 pairs.
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
        const int p = p0 + wm + mt * 16 + g + half * 8;
        if (p >= NHW) continue;
        float y0 = acc[mt][nt][half * 2] * s0 + b0;
        float y1 = acc[mt][nt][half * 2 + 1] * s1 + b1;
        if (POST_RELU) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)p * F + f) =
            pack_bf16x2(y0, y1);
      }
    }
  }
}

template <bool PRE_RELU, bool POST_RELU>
cudaError_t launch(const dim3& grid, int smem, cudaStream_t s,
                   const __nv_bfloat16* x, const __nv_bfloat16* dwk,
                   const __nv_bfloat16* pw, const float* scale,
                   const float* shift, __nv_bfloat16* out, int N, int H,
                   int W, int C, int F) {
  static cudaError_t configured = cudaFuncSetAttribute(
      sepconv_kernel<PRE_RELU, POST_RELU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (configured != cudaSuccess) return configured;
  sepconv_kernel<PRE_RELU, POST_RELU><<<grid, THREADS, smem, s>>>(
      x, dwk, pw, scale, shift, out, N, H, W, C, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's CUDA error (0 = launched).
int sepconv_launch(const void* x, const void* dwk, const void* pw,
                   const void* scale, const void* shift, void* out, int N,
                   int H, int W, int C, int F, int pre_relu, int post_relu,
                   void* stream) {
  const int smem = smem_bytes_for(W);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((F + TF - 1) / TF, (N * H * W + P - 1) / P);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* kb = static_cast<const __nv_bfloat16*>(dwk);
  const auto* pb = static_cast<const __nv_bfloat16*>(pw);
  const auto* sc = static_cast<const float*>(scale);
  const auto* sh = static_cast<const float*>(shift);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (pre_relu && post_relu)
    err = launch<true, true>(grid, smem, s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  else if (pre_relu)
    err = launch<true, false>(grid, smem, s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  else if (post_relu)
    err = launch<false, true>(grid, smem, s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  else
    err = launch<false, false>(grid, smem, s, xb, kb, pb, sc, sh, ob, N, H, W, C, F);
  return static_cast<int>(err);
}

const char* sepconv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
