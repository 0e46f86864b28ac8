// The float32 weight gradient of S3D's 3-channel stem convolution
// (Conv_1a.conv1: a 1 x 7 x 7 kernel over 3 channels, stride (1, 2, 2),
// zero padding (0, 3, 3), no bias) in IEEE float32 FMAs on Hopper's
// (sm_90a) CUDA cores.
//
// Replaces no TPU kernel: the JAX package leaves this gradient to XLA
// (video_similarity_search_tpu/models/s3d.py, STConv3d.conv1). It exists
// because cuDNN runs it as a direct kernel (wgrad2d_grouped_direct_kernel)
// about 200 times slower than the FMA bound.
//
//   dW[co, c, 0, kh, kw] = sum over (b, t, oh, ow) of
//       dy[b, t, oh, ow, co] * x[b, t, 2 oh - 3 + kh, 2 ow - 3 + kw, c]
//
// with zeros outside the frame.
//
// Operands. x: float32 (B, T, H, W, 3), contiguous, W a multiple of 4 and
// 16-byte aligned (the wrapper, ops/stem_wgrad.py, zero-pads W up to one;
// the padded columns lie where the convolution's own padding reads zeros).
// dy: float32 (B, T, Ho, Wo, Cout), the memory of a channels_last_3d
// (B, Cout, T, Ho, Wo) gradient, Ho = ceil(H / 2), Wo = ceil(W_clip / 2),
// Cout a multiple of 64, 16-byte aligned. dw: float32 (Cout, 7, 7, 3), the
// memory of a channels_last_3d (Cout, 3, 1, 7, 7) weight gradient.
//
// GEMM. M = 64 output channels a pass (Cout / 64 passes, blockIdx.y),
// N = 147 taps (kh, kw, c), K = B x T x Ho x Wo output positions: 2 x 64 x
// 147 x 4,194,304 = 78.9 GFLOP at 32 clips of 32x128x128, 1.18 ms at 67
// TFLOP/s; it reads dy (1.07 GB) and x (201 MB) once, 0.38 ms at 3.35 TB/s.
//
// Design. Split K over a persistent grid of a few CTAs per SM. A CTA walks
// bands: 4 output rows x 32 output columns of one frame. For each band it
// stages, with cp.async into one of two buffers (the next band lands while
// this one is computed), the band's dy tile (4 x 32 positions x 64
// channels, zero past Ho / Wo) and the 13 input rows under it (the
// 6 x 32 + 15 elements of each row that the 32 columns read, zero outside
// the frame). A CTA holds two teams of 112 threads; team i takes the
// band's rows i and i + 2. A thread of a team owns 4 output channels x
// one kh x the 21 (kw, c) taps: 84 fp32 accumulators. Because the 21 taps
// of one kh lie contiguous in a channels-last input row, a thread reads
// them as one window per two output columns (27 floats: a 4-byte, six
// 16-byte and an 8-byte load) beside two 16-byte loads of dy, and feeds
// them into 168 FMAs. Each CTA then sums its two teams in shared memory
// and writes its 64 x 147 partial to a workspace; a second kernel sums
// the partials in a fixed order. No atomics: the gradient is bitwise the
// same from run to run.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int C_IN = 3;
constexpr int KS = 7;                             // spatial kernel size
constexpr int PAD = 3;                            // spatial zero padding
constexpr int TILE_N = 64;                        // output channels a pass
constexpr int TW = 32;                            // output columns a band
constexpr int TR = 4;                             // output rows a band
constexpr int TEAMS = 2;                          // teams a CTA
constexpr int CO = 4;                             // output channels a thread
constexpr int TEAM = (TILE_N / CO) * KS;          // 112 threads
constexpr int THREADS = TEAMS * TEAM;             // 224
constexpr int ROW_TAPS = KS * C_IN;               // 21 (kw, c) of one kh
constexpr int TAPS = KS * ROW_TAPS;               // 147
constexpr int ACC = TILE_N * TAPS;                // 9,408 sums a pass
constexpr int ROWS = 2 * (TR - 1) + KS;           // 13 input rows a band
// a slab row holds elements [6 ow0 - 12, 6 ow0 + 200) of its input row, 53
// 16-byte chunks from a 16-byte aligned start: column 2 ow0 - 3 begins at
// element 6 ow0 - 9, slot 3; the last column read, 2 ow0 + 65, ends at
// slot 209. 212 % 32 = 20 puts 7 consecutive rows on distinct banks.
constexpr int CHUNKS = 53;
constexpr int PITCH = 4 * CHUNKS;                 // 212 floats
constexpr int DY_FLOATS = TR * TW * TILE_N;       // 8,192
constexpr int STAGE_FLOATS = DY_FLOATS + ROWS * PITCH;
constexpr int SMEM_BYTES = 2 * STAGE_FLOATS * 4;  // 87,584
constexpr int MIN_CTAS = 2;                       // per SM, registers allowing
constexpr int REDUCE_LANES = 32;                  // sums a reduce CTA writes
constexpr int REDUCE_GROUPS = 8;                  // partial groups it adds

static_assert(ACC * 4 <= SMEM_BYTES, "the team sum reuses the stages");
static_assert(ACC % REDUCE_LANES == 0, "reduce CTAs tile the sums");

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

struct Shape {
  int B, T, H, W, Ho, Wo, cout;
  int row_bands, col_bands;
  long long bands;
};

// stages band q's dy tile and input rows into `stage` (all threads)
__device__ __forceinline__ void load_band(float* stage, const float* x,
                                          const float* dy, const Shape& s,
                                          long long q, int n0, int tid) {
  const int col = static_cast<int>(q % s.col_bands);
  const int rb = static_cast<int>((q / s.col_bands) % s.row_bands);
  const long long frame = q / (static_cast<long long>(s.col_bands) *
                               s.row_bands);
  const int ow0 = col * TW, oh0 = rb * TR;
  // dy: TR x TW positions x 16 chunks of 4 channels
  for (int i = tid; i < TR * TW * (TILE_N / 4); i += THREADS) {
    const int k = i % (TILE_N / 4);
    const int p = i / (TILE_N / 4);
    const int oh = oh0 + p / TW, ow = ow0 + p % TW;
    const bool inside = oh < s.Ho && ow < s.Wo;
    const float* src =
        inside ? dy + ((frame * s.Ho + oh) * s.Wo + ow) * s.cout + n0 + 4 * k
               : dy;
    cp_async_16(stage + p * TILE_N + 4 * k, src, inside ? 16 : 0);
  }
  // x: ROWS rows x CHUNKS chunks of 4 elements
  const long long row_elems = 3LL * s.W;
  float* slab = stage + DY_FLOATS;
  for (int i = tid; i < ROWS * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, k = i % CHUNKS;
    const int y = 2 * oh0 - PAD + r;
    const long long e = 6LL * ow0 - 12 + 4 * k;
    const bool inside = y >= 0 && y < s.H && e >= 0 && e < row_elems;
    const float* src = inside ? x + (frame * s.H + y) * row_elems + e : x;
    cp_async_16(slab + r * PITCH + 4 * k, src, inside ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    stem_wgrad_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy,
                      float* __restrict__ partial, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int team = tid / TEAM;
  const int kh = (tid % TEAM) / (TILE_N / CO);
  const int cog = tid % (TILE_N / CO);
  const int n0 = blockIdx.y * TILE_N;

  float acc[CO][ROW_TAPS];
#pragma unroll
  for (int a = 0; a < CO; ++a)
#pragma unroll
    for (int j = 0; j < ROW_TAPS; ++j) acc[a][j] = 0.f;

  int buf = 0;
  load_band(smem, x, dy, s, blockIdx.x, n0, tid);
  cp_async_commit();
  for (long long q = blockIdx.x; q < s.bands; q += gridDim.x, buf ^= 1) {
    if (q + gridDim.x < s.bands)
      load_band(smem + (buf ^ 1) * STAGE_FLOATS, x, dy, s, q + gridDim.x, n0,
                tid);
    cp_async_commit();
    cp_async_wait_one();  // this band's copies have landed
    __syncthreads();
    const float* stage = smem + buf * STAGE_FLOATS;
#pragma unroll 1
    for (int i = 0; i < TR / TEAMS; ++i) {
      const int r = team + TEAMS * i;
      const float* xr = stage + DY_FLOATS + (2 * r + kh) * PITCH;
      const float* dr = stage + r * TW * TILE_N + CO * cog;
#pragma unroll 1
      for (int u = 0; u < TW / 2; ++u) {
        // w[6 v + 3 kw + c] = x at (column 2 (ow0 + 2 u + v) - 3 + kw, c)
        float w[27];
        const float* xp = xr + 12 * u;
        w[0] = xp[3];
#pragma unroll
        for (int i4 = 0; i4 < 6; ++i4) {
          const float4 v4 = *reinterpret_cast<const float4*>(xp + 4 + 4 * i4);
          w[1 + 4 * i4] = v4.x;
          w[2 + 4 * i4] = v4.y;
          w[3 + 4 * i4] = v4.z;
          w[4 + 4 * i4] = v4.w;
        }
        const float2 v2 = *reinterpret_cast<const float2*>(xp + 28);
        w[25] = v2.x;
        w[26] = v2.y;
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(dr + (2 * u + v) * TILE_N);
          const float d[CO] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int a = 0; a < CO; ++a)
#pragma unroll
            for (int j = 0; j < ROW_TAPS; ++j)
              acc[a][j] = fmaf(d[a], w[6 * v + j], acc[a][j]);
        }
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this stage
  }

  // team 1's sums through shared memory into team 0's, then the CTA's
  // partial: sum index (co - n0) * 147 + kh * 21 + kw * 3 + c
  float* sums = smem;
  if (team == 1) {
#pragma unroll
    for (int a = 0; a < CO; ++a)
#pragma unroll
      for (int j = 0; j < ROW_TAPS; ++j)
        sums[(CO * cog + a) * TAPS + kh * ROW_TAPS + j] = acc[a][j];
  }
  __syncthreads();
  if (team == 0) {
    float* out = partial + (static_cast<long long>(blockIdx.y) * gridDim.x +
                            blockIdx.x) * ACC;
#pragma unroll
    for (int a = 0; a < CO; ++a)
#pragma unroll
      for (int j = 0; j < ROW_TAPS; ++j) {
        const int idx = (CO * cog + a) * TAPS + kh * ROW_TAPS + j;
        out[idx] = acc[a][j] + sums[idx];
      }
  }
}

// dw[e] = the sum over the pass's `parts` partials of sum e, in a fixed
// order: group g adds partials g, g + 8, ... in turn, then the 8 groups
// are added in order
__global__ void __launch_bounds__(REDUCE_LANES * REDUCE_GROUPS)
    stem_wgrad_reduce(const float* __restrict__ partial,
                      float* __restrict__ dw, int parts) {
  __shared__ float sh[REDUCE_GROUPS][REDUCE_LANES];
  const int lane = threadIdx.x % REDUCE_LANES;
  const int g = threadIdx.x / REDUCE_LANES;
  const long long e = static_cast<long long>(blockIdx.x) * REDUCE_LANES + lane;
  const long long pass = e / ACC;
  const float* src = partial + pass * parts * ACC + e % ACC;
  float sum = 0.f;
  for (int p = g; p < parts; p += REDUCE_GROUPS)
    sum += src[static_cast<long long>(p) * ACC];
  sh[g][lane] = sum;
  __syncthreads();
  if (g == 0) {
    float total = sh[0][lane];
#pragma unroll
    for (int i = 1; i < REDUCE_GROUPS; ++i) total += sh[i][lane];
    dw[e] = total;
  }
}

Shape make_shape(int B, int T, int H, int W, int Ho, int Wo, int cout) {
  Shape s{B, T, H, W, Ho, Wo, cout, (Ho + TR - 1) / TR, (Wo + TW - 1) / TW,
          0};
  s.bands = static_cast<long long>(B) * T * s.row_bands * s.col_bands;
  return s;
}

// CTAs a pass: as many as fit on the card at once, shared among the
// passes, and no more than there are bands; 0 on an error
int grid_ctas(const Shape& s) {
  if (cudaFuncSetAttribute(stem_wgrad_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES) != cudaSuccess)
    return 0;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, stem_wgrad_kernel, THREADS, SMEM_BYTES) != cudaSuccess)
    return 0;
  const int passes = s.cout / TILE_N;
  long long ctas = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1) /
                   passes;
  if (ctas < 1) ctas = 1;
  return static_cast<int>(ctas < s.bands ? ctas : s.bands);
}

bool takes(int B, int T, int H, int W, int Ho, int Wo, int cout) {
  return B >= 1 && T >= 1 && H >= 1 && W >= 4 && W % 4 == 0 &&
         cout >= TILE_N && cout % TILE_N == 0 && Ho == (H + 1) / 2 &&
         Wo >= 1 && Wo <= (W + 1) / 2;
}

}  // namespace

extern "C" {

// dynamic shared memory of one CTA of the main kernel
int stem_wgrad_f32_smem_bytes() { return SMEM_BYTES; }

// floats of workspace the launch needs; -1: shapes the kernel does not
// take; -2: a CUDA error while sizing the grid
long long stem_wgrad_f32_workspace(int B, int T, int H, int W, int Ho,
                                   int Wo, int cout) {
  if (!takes(B, T, H, W, Ho, Wo, cout)) return -1;
  const Shape s = make_shape(B, T, H, W, Ho, Wo, cout);
  const int ctas = grid_ctas(s);
  if (ctas == 0) return -2;
  return static_cast<long long>(cout / TILE_N) * ctas * ACC;
}

// 0 on success; -1: shapes the kernel does not take; -2: a CUDA error
// while sizing the grid; else a cudaError_t. `workspace` holds
// stem_wgrad_f32_workspace(...) floats.
int stem_wgrad_f32(const void* x, const void* dy, void* dw, void* workspace,
                   int B, int T, int H, int W, int Ho, int Wo, int cout,
                   cudaStream_t stream) {
  if (!takes(B, T, H, W, Ho, Wo, cout)) return -1;
  const Shape s = make_shape(B, T, H, W, Ho, Wo, cout);
  const int ctas = grid_ctas(s);
  if (ctas == 0) return -2;
  const int passes = cout / TILE_N;
  stem_wgrad_kernel<<<dim3(ctas, passes), THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<float*>(workspace), s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stem_wgrad_reduce<<<passes * ACC / REDUCE_LANES,
                      REDUCE_LANES * REDUCE_GROUPS, 0, stream>>>(
      static_cast<const float*>(workspace), static_cast<float*>(dw), ctas);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
