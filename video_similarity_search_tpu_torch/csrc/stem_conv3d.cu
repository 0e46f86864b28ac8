// The 3-channel stem convolution of the 3-D ResNet family (conv1: a
// kT x 7 x 7 kernel over 3 channels, stride (1, 2, 2), zero padding
// (kT/2, 3, 3), no bias) as an implicit GEMM on Hopper's (sm_90a) tensor
// cores: bf16 operands, fp32 sums, bf16 output.
//
// Replaces no TPU kernel: the JAX package leaves this convolution to XLA
// (video_similarity_search_tpu/models/resnet3d.py, conv1). It exists
// because cuDNN has no tensor-core engine for 3 input channels: under bf16
// autocast it converts the clip and the weight to fp32 NCHW, runs an fp32
// implicit GEMM on the CUDA cores and converts the result back to bf16
// channels-last. The product of two bf16 values is exact in fp32, so this
// kernel computes the same products and sums them in fp32 too; only the
// order of the sum differs.
//
// Operands. x: bf16 (B, T, H, W, 3), contiguous, W a multiple of 8 (the
// wrapper, ops/stem_conv.py, zero-pads W up to one; that padding only adds
// zeros the convolution's own padding would read). w: bf16 (Cout, kT, 7, 7,
// 3), contiguous (a channels_last_3d weight's memory order). out: bf16
// (B, T, Ho, Wo, Cout), the memory of a channels_last_3d (B, Cout, T, Ho,
// Wo) tensor, Ho = ceil(H / 2), Wo = the wrapper's ceil(W / 2).
//
// GEMM. M = output positions, N = 64 output channels a pass (Cout / 64
// passes, one per blockIdx.y), K = kT x (7 x 22 + 6): for each input frame
// the 7 kernel rows ky, each as one zero tap and then the 21 values (kx, c),
// which lie contiguous in a channels-last input row; 154 padded to 160,
// ten k16 steps. The zero tap puts every k-pair (2i, 2i+1) on an even
// element of the input, so the A fragment is gathered with 32-bit loads.
//
// Bound: per 16x128x128 clip, 65,536 outputs x 64 channels x 1,029 MACs =
// 8.63 GFLOP, 8.7 ms at 989 TFLOP/s bf16 for 1,000 clips (2.23 ms for a
// 256-clip batch); it reads 1.57 MB and writes 8.39 MB a clip, 0.76 ms at
// 3.35 TB/s for 256 clips: compute-bound.
//
// Design. One persistent CTA per SM (2 warpgroups, 256 threads) keeps its
// 64 channels' weights resident in shared memory (kT x 20 KB, in wgmma's
// K-major no-swizzle layout, built from w at the start) and walks columns:
// a column is one clip's 4 output rows x 64 output columns, taken through
// every output frame t in turn. Each input frame's slab (the 13 input rows
// and 133 columns under the column) is copied once per column with
// cp.async into a ring of kT + 1 slabs (zero-filled outside the clip), one
// frame ahead of the compute, so consecutive t reuse kT - 1 of their
// frames. Warpgroup g computes output rows 2g and 2g + 1 as two m64n64k16
// products a k-step, A gathered from the slab into registers (im2col never
// exists in memory; double-buffered so the next k-step's loads overlap the
// running wgmma), B from the resident weights. Frames outside the clip
// contribute zeros and are skipped (11% of the work at T = 16, kT = 7).
// The epilogue rounds to bf16 and stores each thread's channel pairs.
// Shared memory at kT = 7: 140 KB of weights + 8 x 10.4 KB of slabs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C_IN = 3;
constexpr int KS = 7;                     // spatial kernel size
constexpr int PAD = 3;                    // spatial zero padding
constexpr int TILE_N = 64;                // output channels a pass
constexpr int TX = 64;                    // output columns a column (wgmma M)
constexpr int TY = 4;                     // output rows a column: 2 a warpgroup
constexpr int ROWS = 2 * (TY - 1) + KS;   // 13 input rows under them
constexpr int ROW_K = KS * C_IN + 1;      // 22: a zero tap, then (kx, c)
constexpr int K_REAL = KS * ROW_K;        // 154 a frame
constexpr int K_STEPS = 10;               // k16 steps a frame (K 160)
// a slab row holds input elements [6 ox0 - 16, 6 ox0 + 392) of its row:
// 16-byte aligned chunks covering columns 2 ox0 - 3 .. 2 ox0 + 129 and the
// element before them, which the zero tap reads
constexpr int CHUNKS = 51;
constexpr int PITCH = CHUNKS * 8;                  // bf16 a slab row
constexpr int SLAB_BYTES = ROWS * PITCH * 2;       // 10,608
constexpr int STEP_BYTES = TILE_N * 16 * 2;        // one k-step of weights
constexpr int CORE_BYTES = 128;                    // 8 rows x 16 bytes
constexpr int THREADS = 256;

__host__ __device__ constexpr int weight_bytes(int kt) {
  return kt * K_STEPS * STEP_BYTES;
}

__host__ __device__ constexpr int smem_bytes(int kt) {
  return weight_bytes(kt) + (kt + 1) * SLAB_BYTES;
}

template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
    stem_conv3d_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint16_t* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, int B, int T, int H,
                       int W, int Ho, int Wo, int cout) {
  constexpr int PT = KT / 2;
  constexpr int RING = KT + 1;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* w_s = smem;
  uint8_t* slabs = smem + weight_bytes(KT);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int g = (tid % 32) / 4;
  const int q = tid % 4;
  const int n0 = blockIdx.y * TILE_N;

  // ---- this pass's weights, once: B[n][k] at k-step s = k / 16 is core
  // matrix (n / 8, (k / 8) % 2) of step (kt, s), each 128 contiguous bytes:
  // LBO (along K) 128 bytes, SBO (along N) 256
  for (int p = tid; p < TILE_N * KT * K_STEPS * 2; p += THREADS) {
    const int n = p / (KT * K_STEPS * 2);
    const int kt = (p / (K_STEPS * 2)) % KT;
    const int kc = p % (K_STEPS * 2);  // which 8 of the frame's 160 k
    uint32_t packed[4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = kc * 8 + e + h;
        const int ky = k / ROW_K;
        const int tap = k - ky * ROW_K;  // 0: the zero tap; else kx * 3 + c + 1
        uint32_t v = 0;
        if (k < K_REAL && tap > 0)
          v = w[((static_cast<long long>(n0 + n) * KT + kt) * KS + ky) *
                    (KS * C_IN) +
                tap - 1];
        pair |= v << (16 * h);
      }
      packed[e / 2] = pair;
    }
    uint8_t* dst = w_s + (kt * K_STEPS + kc / 2) * STEP_BYTES +
                   (n / 8) * 2 * CORE_BYTES + (kc % 2) * CORE_BYTES +
                   (n % 8) * 16;
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
  fence_proxy_async_shared();  // wgmma reads them through the async proxy
  const uint64_t desc_w = interleave_desc(w_s, CORE_BYTES, 2 * CORE_BYTES);

  // ---- this thread's A pairs: k = 16 s + 2 q + 8 i lies at byte off[s][i]
  // of its position's base in the slab (the zero tap at ky's row start - 1;
  // the pad k >= 154 at 0, times a zero weight)
  uint32_t off[K_STEPS][2];
#pragma unroll
  for (int s = 0; s < K_STEPS; ++s) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = 16 * s + 2 * q + 8 * i;
      const int ky = k / ROW_K;
      off[s][i] = k < K_REAL ? 2 * (ky * PITCH + k - ky * ROW_K) : 0;
    }
  }
  // output (row 2 wg, column 16 warp + g) reads slab row 2 * row + ky,
  // element 6 * column + 6 + tap: its base, in bytes
  const int thread_base = 2 * (2 * (2 * wg) * PITCH + 6 * (16 * warp + g) + 6);
  constexpr int NEXT_ROW = 2 * 8 * 6;           // the fragment's row + 8
  constexpr int NEXT_SUBTILE = 2 * 2 * PITCH;   // the next output row

  const int oy_tiles = (Ho + TY - 1) / TY;
  const int ox_tiles = (Wo + TX - 1) / TX;
  const int columns = B * oy_tiles * ox_tiles;
  const long long row_elems = 3LL * W;

  for (int col = blockIdx.x; col < columns; col += gridDim.x) {
    const int ox0 = (col % ox_tiles) * TX;
    const int oy0 = ((col / ox_tiles) % oy_tiles) * TY;
    const int b = col / (ox_tiles * oy_tiles);

    auto load_frame = [&](int f) {
      uint8_t* dst = slabs + (f % RING) * SLAB_BYTES;
      const long long frame_row = (static_cast<long long>(b) * T + f) * H;
      for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
        const int r = i / CHUNKS;
        const int y = 2 * oy0 - PAD + r;
        const long long e = 6LL * ox0 - 16 + 8 * (i % CHUNKS);
        const bool inside = y >= 0 && y < H && e >= 0 && e < row_elems;
        const __nv_bfloat16* src =
            inside ? x + (frame_row + y) * row_elems + e : x;
        cp_async_16(dst + r * PITCH * 2 + (i % CHUNKS) * 16, src,
                    inside ? 16 : 0);
      }
    };

    __syncthreads();  // the previous column's reads of the ring are done
    for (int f = 0; f <= PT && f < T; ++f) load_frame(f);
    cp_async_commit();

    for (int t = 0; t < T; ++t) {
      cp_async_wait_all();
      __syncthreads();  // frames t - PT .. t + PT landed; frame t - PT - 1's
                        // slot is free
      if (t + PT + 1 < T) load_frame(t + PT + 1);
      cp_async_commit();

      const int kt_lo = max(0, PT - t);
      const int kt_hi = min(KT - 1, T - 1 - t + PT);
      float acc[2][32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[0][i] = acc[1][i] = 0.f;
      uint32_t a[2][2][4];  // [buffer][output row][fragment register]

      auto load_a = [&](int kt, int s, uint32_t(&buf)[2][4]) {
        const uint8_t* base =
            slabs + ((t - PT + kt) % RING) * SLAB_BYTES + thread_base;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint8_t* p = base + i * NEXT_SUBTILE;
          buf[i][0] = *reinterpret_cast<const uint32_t*>(p + off[s][0]);
          buf[i][1] =
              *reinterpret_cast<const uint32_t*>(p + off[s][0] + NEXT_ROW);
          buf[i][2] = *reinterpret_cast<const uint32_t*>(p + off[s][1]);
          buf[i][3] =
              *reinterpret_cast<const uint32_t*>(p + off[s][1] + NEXT_ROW);
        }
      };

      load_a(kt_lo, 0, a[0]);
#pragma unroll 1
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        const uint64_t desc_kt =
            desc_w + static_cast<uint64_t>(kt * K_STEPS * (STEP_BYTES >> 4));
#pragma unroll
        for (int s = 0; s < K_STEPS; ++s) {
          const int scale = kt != kt_lo || s != 0;
          const uint64_t desc = desc_kt + s * (STEP_BYTES >> 4);
          wgmma_fence();
          wgmma_m64n64k16_bf16_rs(acc[0], a[s & 1][0], desc, scale);
          wgmma_m64n64k16_bf16_rs(acc[1], a[s & 1][1], desc, scale);
          wgmma_commit();
          wgmma_wait<1>();  // step s - 1 is done with the other buffer
          if (s + 1 < K_STEPS)
            load_a(kt, s + 1, a[(s + 1) & 1]);
          else if (kt < kt_hi)
            load_a(kt + 1, 0, a[0]);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);

      // ---- epilogue: bf16 pairs of channels, rows past Ho / Wo left out
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int oy = oy0 + 2 * wg + i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ox = ox0 + 16 * warp + g + 8 * h;
          if (oy >= Ho || ox >= Wo) continue;
          __nv_bfloat16* dst =
              out +
              (((static_cast<long long>(b) * T + t) * Ho + oy) * Wo + ox) *
                  cout +
              n0 + 2 * q;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                __floats2bfloat162_rn(acc[i][4 * j + 2 * h],
                                      acc[i][4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

template <int KT>
int launch(const void* x, const void* w, void* out, int B, int T, int H,
           int W, int Ho, int Wo, int cout, cudaStream_t stream) {
  auto kernel = stem_conv3d_kernel<KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(KT));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int passes = cout / TILE_N;
  const long long columns = static_cast<long long>(B) * ((Ho + TY - 1) / TY) *
                            ((Wo + TX - 1) / TX);
  const int per_pass = sms / passes > 0 ? sms / passes : 1;
  dim3 grid(static_cast<unsigned>(columns < per_pass ? columns : per_pass),
            passes);
  kernel<<<grid, THREADS, smem_bytes(KT), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint16_t*>(w),
      static_cast<__nv_bfloat16*>(out), B, T, H, W, Ho, Wo, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dynamic shared memory of one CTA at temporal kernel size kt
int stem_conv3d_smem_bytes(int kt) { return smem_bytes(kt); }

// 0 on success; -1: shapes the kernel does not take; else a cudaError_t
int stem_conv3d(const void* x, const void* w, void* out, int B, int T, int H,
                int W, int Ho, int Wo, int cout, int kt, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 1 || W < 8 || W % 8 != 0 || cout < TILE_N ||
      cout % TILE_N != 0 || Ho != (H + 1) / 2 || Wo < 1 || Wo > (W + 1) / 2)
    return -1;
  switch (kt) {
    case 1: return launch<1>(x, w, out, B, T, H, W, Ho, Wo, cout, stream);
    case 3: return launch<3>(x, w, out, B, T, H, W, Ho, Wo, cout, stream);
    case 5: return launch<5>(x, w, out, B, T, H, W, Ho, Wo, cout, stream);
    case 7: return launch<7>(x, w, out, B, T, H, W, Ho, Wo, cout, stream);
    default: return -1;
  }
}

}  // extern "C"
