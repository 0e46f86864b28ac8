// Exact cosine 1-nearest-neighbor for FINCH's first level, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel video_similarity_search_tpu/ops/pallas_knn.py::
// _nn_kernel (:37-75, launched through pl.pallas_call at :93): for every row
// of x (M, D) it finds argmin_j (1 - x_i . y_j) over the rows of y (N, D)
// without forming the M x N matrix. Rows arrive L2-normalized and
// unpadded; the kernel masks the ragged edges (col >= N) itself, and for a
// self-query (exclude_self) the diagonal. Ties go to the lowest column, as
// in the TPU kernel's strict-< merge. A row with no candidate returns
// (0, 3.4e38), the TPU kernel's _BIG.
//
// Design: each 256-thread block owns 128 query rows and streams the bank in
// 128-row tiles, D in chunks of 8 through shared memory (k-major, padded so
// the transposing stores are bank-conflict free). Each thread accumulates
// an 8x8 register tile in IEEE fp32 FMA -- no TF32, so near-tie argmins do
// not flip against the fp32 reference (ROADMAP hazard H3) -- and folds
// it into a running (dist, idx) per row with a strict <, visiting its
// columns in increasing order. The 16 threads that share a row merge with
// warp shuffles, lexicographically on (dist, idx).
//
// Bound: the work is 2*M*N*D flops and reads (M+N)*D*4 bytes, so at FINCH's
// Kinetics scale (M = N = 240,000, D = 128: 1.47e16 flops) it is
// compute-bound: about 220 ms at the fp32 CUDA-core peak of an H100 SXM
// (67 TFLOP/s; about 51 TFLOP/s, 290 ms, on the PCIe card). Later work: a
// wgmma/TMA pipeline in error-compensated TF32 (3xTF32) or bf16 with an
// fp32 re-rank of near ties, whose tensor-core peaks are about 495 / 989
// TFLOP/s dense.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // query rows per block
constexpr int BN = 128;       // bank rows per tile
constexpr int BK = 8;         // D chunk through shared memory
constexpr int PAD = 4;        // keeps float4 alignment, spreads stores
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr float BIG = 3.4e38f;

__device__ __forceinline__ int sub_of(int t, int i) {
  // the 8 rows (or columns) a thread owns: t*4 + 0..3 and 64 + t*4 + 0..3,
  // in increasing order
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

__global__ void __launch_bounds__(THREADS, 2)
nn1_cosine_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  long long* __restrict__ out_idx,
                  float* __restrict__ out_dist, int M, int N, int D,
                  int exclude_self) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;

  float best_d[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_d[i] = BIG;
    best_i[i] = 0;
  }

  for (long long n0 = 0; n0 < N; n0 += BN) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
#pragma unroll
      for (int l = 0; l < (BM * BK) / THREADS; ++l) {
        const int e = tid + l * THREADS;
        const int r = e / BK;
        const int c = e % BK;
        const int gc = k0 + c;
        const long long gm = m0 + r;
        const long long gn = n0 + r;
        As[c][r] = (gm < M && gc < D) ? x[gm * D + gc] : 0.f;
        Bs[c][r] = (gn < N && gc < D) ? y[gn * D + gc] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long row = m0 + sub_of(ty, i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long col = n0 + sub_of(tx, j);
        if (col < N && !(exclude_self && col == row)) {
          const float d = 1.0f - acc[i][j];
          if (d < best_d[i]) {
            best_d[i] = d;
            best_i[i] = static_cast<int>(col);
          }
        }
      }
    }
  }

  // merge the 16 threads (one half-warp) that share each row
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float bd = best_d[i];
    int bi = best_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    const long long row = m0 + sub_of(ty, i);
    if (tx == 0 && row < M) {
      out_idx[row] = bi;
      out_dist[row] = bd;
    }
  }
}

}  // namespace

// x (M, D) and y (N, D) contiguous float32, L2-normalized; out_idx (M,)
// int64 and out_dist (M,) float32, allocated by the caller. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nn1_cosine(const void* x, const void* y, void* out_idx,
                          void* out_dist, int M, int N, int D,
                          int exclude_self, void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((M + BM - 1) / BM);
  nn1_cosine_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<long long*>(out_idx), static_cast<float*>(out_dist), M, N,
      D, exclude_self);
  return static_cast<int>(cudaGetLastError());
}
