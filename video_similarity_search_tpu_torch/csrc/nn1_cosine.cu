// Exact cosine 1-nearest-neighbor for FINCH's first level, hand-written for
// Hopper (sm_90a): error-compensated TF32 ("3xTF32") on the tensor cores
// (wgmma), fed by TMA through a ring of shared-memory stages.
//
// Replaces the TPU kernel video_similarity_search_tpu/ops/pallas_knn.py::
// _nn_kernel (:37-75, launched through pl.pallas_call at :93): for every row
// of x (M, D) it finds argmin_j (1 - x_i . y_j) over the rows of y (N, D)
// without forming the M x N matrix. Columns >= N are masked, and for a
// self-query (exclude_self) the diagonal. Ties go to the lowest column: a
// strict < over columns in increasing order, then a lexicographic (dist,
// idx) merge, as the TPU kernel's strict-< merge. A row with no candidate
// returns (0, 3.4e38), the TPU kernel's _BIG. dist = 1.0f - dot, in fp32.
//
// Operands. The wrapper (ops/fused_knn.py) zero-pads D to a multiple of 32
// (one 128-byte swizzle row of fp32; exact for dot products) and splits each
// fp32 value into two exact TF32 values, hi = tf32(v) and lo = tf32(v - hi),
// with the low 13 bits of both zero, so the tensor core sees exactly these
// numbers whether it truncates or rounds its inputs. For each 32-wide D
// chunk the kernel issues lo.hi and hi.lo (the small terms, while the
// chunk's sum is still small), then hi.hi, into a chunk sum that starts at
// zero, and adds that chunk sum to an fp32 running sum on the CUDA cores
// (rounded to nearest). The lo.lo term is dropped.
//
// Error budget, for unit rows: the split leaves |v - hi - lo| <= 2^-22 |v|,
// and the dropped lo.lo term is at most 2^-22 sum|x_k y_k| <= 2^-22, so the
// representation costs at most about 3 * 2^-22 = 7.2e-7 of the dot product;
// each hi.lo product is exact in fp32 (11 x 11 significand bits). The
// tensor core sums a k-step's products and its accumulator with truncation,
// so each wgmma can lose about an ulp of the sum it adds to: summing a whole
// D = 128 in one accumulator lost up to 1.4e-6 against an fp64 reference
// at 240k (twice the IEEE-fp32 plain version's 7.2e-7); summing per chunk
// and promoting lost at most 2.2e-7, for 4% more time. chip_smoke.py holds
// the distances to 1e-5 of the plain version, allows an index to differ
// only where the two candidates lie within 1e-6, and holds the 240k picks
// and level-0 partition to an fp64 referee.
//
// Bound: the work is 2*M*N*D operations with fp32-accurate products. The
// card's fastest fp32-accurate products are three TF32 tensor-core passes:
// at FINCH's Kinetics scale (M = N = 240,000, D = 128: 1.47e13 operations)
// 3 * 1.47e13 / 495e12 = 89.4 ms on an H100 SXM at 700 W (dense TF32 of
// the data sheets: PCIe 378 TFLOP/s, 117 ms; NVL 417.5 TFLOP/s, 106 ms);
// IEEE fp32 on the CUDA cores would need 220.1 ms (67 TFLOP/s). Inputs are
// about 0.25 GB: compute-bound.
//
// Design. One CTA of 384 threads owns 128 query rows and sweeps the whole
// bank, so no reduction across CTAs is needed. Warpgroups 0 and 1 are
// consumers: 64 rows each, m64n128k8 wgmma, and a thread keeps 64 chunk
// sums and 64 running sums. Warpgroup 2 is the producer: one of its threads
// issues every TMA copy, and setmaxnreg moves registers from it to the
// consumers. For D <= 128 the CTA's A_hi and A_lo (128 x D each, 128 KB at
// D = 128) are loaded once and stay resident; the bank comes in 128-row x
// 32-wide chunks of B_hi and B_lo (32 KB) through a 3-stage ring with
// full/empty mbarriers (224 KB in all). A wider D streams A's chunks with
// B's through the same ring (64 KB a stage): correct at any D, not tuned.
// After each bank tile, each thread folds its running sums into a running
// (dist, idx) for its two rows; at the end the four threads of a quad merge
// with shuffles.
//
// Hazard 1, L2 traffic: every CTA re-reads the whole bank in hi + lo,
// (M/128) * N * D * 8 bytes = 461 GB at 240k, 3.5-5.2 TB/s from L2 at
// 89-130 ms. chip_smoke.py times one full wave of CTAs on a bank that fits
// in L2 and on the 240k bank, and the 240k bank with half the SMs; PERF.md
// records the finding and why the kernel keeps one CTA per cluster, with no
// TMA multicast.
// Hazard 2, the TMA descriptor: cuTensorMapEncodeTiled is a driver call;
// it is fetched through cudaGetDriverEntryPoint, so the library links no
// -lcuda. The four descriptors go in as __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;       // query rows per CTA
constexpr int BN = 128;       // bank rows per tile
constexpr int BK = 32;        // D chunk: 32 fp32 = one 128-byte swizzle row
constexpr int STAGES = 3;     // depth of the ring
constexpr int THREADS = 384;  // 2 consumer warpgroups + 1 producer
constexpr int TILE_BYTES = 128 * BK * 4;  // one 128-row x 32 box: 16 KB
constexpr int N_BARS = 2 * STAGES + 1;    // full[], empty[], a_full
constexpr float BIG = 3.4e38f;

__host__ __device__ constexpr int stage_bytes(bool resident_a) {
  return (resident_a ? 2 : 4) * TILE_BYTES;
}

// A stays resident while both its parts fit beside the ring: D <= 128
bool keeps_a_resident(int d_pad) { return d_pad <= 128; }

int smem_bytes(bool resident_a, int nk) {
  return 1024 /* alignment slack */ + (resident_a ? 2 * nk * TILE_BYTES : 0) +
         STAGES * stage_bytes(resident_a) + N_BARS * 8;
}

template <bool kResidentA>
__global__ void __launch_bounds__(THREADS, 1)
    nn1_cosine_kernel(const __grid_constant__ CUtensorMap x_hi,
                      const __grid_constant__ CUtensorMap x_lo,
                      const __grid_constant__ CUtensorMap y_hi,
                      const __grid_constant__ CUtensorMap y_lo,
                      long long* __restrict__ out_idx,
                      float* __restrict__ out_dist, int M, int N, int nk,
                      int exclude_self) {
  constexpr int SB = stage_bytes(kResidentA);
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // 128-byte swizzle atoms must start on 1024 bytes
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // resident: [A_hi x nk][A_lo x nk][stage: B_hi B_lo] x STAGES
  // streamed: [stage: B_hi B_lo A_hi A_lo] x STAGES
  uint8_t* a_tiles = smem;
  uint8_t* stages = smem + (kResidentA ? 2 * nk * TILE_BYTES : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + STAGES * SB);
  uint64_t* empty = full + STAGES;
  uint64_t* a_full = empty + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(a_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int m0 = blockIdx.x * BM;
  const int n_tiles = (N + BN - 1) / BN;

  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    reg_dealloc<40>();
    if (tid == 256) {
      if (kResidentA) {
        mbar_arrive_expect_tx(a_full, 2 * nk * TILE_BYTES);
        for (int c = 0; c < nk; ++c) {
          tma_load_2d(a_tiles + c * TILE_BYTES, &x_hi, a_full, c * BK, m0);
          tma_load_2d(a_tiles + (nk + c) * TILE_BYTES, &x_lo, a_full, c * BK,
                      m0);
        }
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int c = 0; c < nk; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sb = stages + stage * SB;
          // rows past M or N arrive as zeros and still count in full
          mbar_arrive_expect_tx(&full[stage], SB);
          tma_load_2d(sb, &y_hi, &full[stage], c * BK, t * BN);
          tma_load_2d(sb + TILE_BYTES, &y_lo, &full[stage], c * BK, t * BN);
          if (!kResidentA) {
            tma_load_2d(sb + 2 * TILE_BYTES, &x_hi, &full[stage], c * BK, m0);
            tma_load_2d(sb + 3 * TILE_BYTES, &x_lo, &full[stage], c * BK, m0);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    reg_alloc<232>();
    const int lane = tid % 32;
    const int row0 = m0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    const int a_off = wg * 64 * 128;  // this warpgroup's rows, in bytes
    const bool signals = (tid % 128) == 0;

    float acc[64];   // the bank tile's dot products, fp32
    float part[64];  // one D chunk's, from the tensor cores
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    float best_d[2] = {BIG, BIG};
    int best_i[2] = {0, 0};

    if (kResidentA) mbar_wait(a_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int t = 0; t < n_tiles; ++t) {
      for (int c = 0; c < nk; ++c) {
        mbar_wait(&full[stage], phase);
        const uint8_t* sb = stages + stage * SB;
        const uint8_t* a_hi =
            kResidentA ? a_tiles + c * TILE_BYTES : sb + 2 * TILE_BYTES;
        const uint8_t* a_lo =
            kResidentA ? a_tiles + (nk + c) * TILE_BYTES : sb + 3 * TILE_BYTES;
        const uint64_t da_hi = sw128_desc(a_hi + a_off);
        const uint64_t da_lo = sw128_desc(a_lo + a_off);
        const uint64_t db_hi = sw128_desc(sb);
        const uint64_t db_lo = sw128_desc(sb + TILE_BYTES);
        wgmma_fence();
        // the chunk's small terms first, while the sum is small; the first
        // product overwrites the partial sum
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t k = 2 * kk;  // 8 fp32 = 32 bytes = 2 units
          wgmma_m64n128k8_tf32(part, da_lo + k, db_hi + k, kk != 0);
          wgmma_m64n128k8_tf32(part, da_hi + k, db_lo + k, 1);
        }
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
          const uint64_t k = 2 * kk;
          wgmma_m64n128k8_tf32(part, da_hi + k, db_hi + k, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(part);
        if (signals) mbar_arrive(&empty[stage]);  // hand the stage back
        // promote the chunk into the fp32 sum, rounded to nearest
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = c ? acc[i] + part[i] : part[i];
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // fold the tile into the running best, columns in increasing order
      const int col0 = t * BN + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = col0 + 8 * j + e;
            const float d = 1.0f - acc[4 * j + 2 * h + e];
            if (col < N && !(exclude_self && col == row) && d < best_d[h]) {
              best_d[h] = d;
              best_i[h] = col;
            }
          }
        }
      }
    }

    // the four threads of a quad share rows: merge on (dist, idx)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bd = best_d[h];
      int bi = best_i[h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, bd, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (od < bd || (od == bd && oi < bi)) {
          bd = od;
          bi = oi;
        }
      }
      const int row = row0 + 8 * h;
      if (lane % 4 == 0 && row < M) {
        out_idx[row] = bi;
        out_dist[row] = bd;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (rows, d_pad) row-major fp32, cut into 128-row x 32 boxes, 128-byte swizzle
CUresult make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                  int rows, int d_pad) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d_pad),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d_pad) * 4};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <bool kResidentA>
int launch(const CUtensorMap (&maps)[4], void* out_idx, void* out_dist, int M,
           int N, int nk, int exclude_self, cudaStream_t stream) {
  auto kernel = nn1_cosine_kernel<kResidentA>;
  const int smem = smem_bytes(kResidentA, nk);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<long long*>(out_idx),
      static_cast<float*>(out_dist), M, N, nk, exclude_self);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_hi, x_lo (M, d_pad) and y_hi, y_lo (N, d_pad): contiguous fp32 holding
// exact TF32 values, d_pad a multiple of 32, 16-byte aligned; out_idx (M,)
// int64 and out_dist (M,) float32, allocated by the caller. Launches on
// `stream` and returns 0 on success, a cudaError_t, -1 for bad sizes, -2 if
// the driver has no cuTensorMapEncodeTiled, or 10000 + CUresult if it
// refuses a descriptor.
extern "C" int nn1_cosine(const void* x_hi, const void* x_lo,
                          const void* y_hi, const void* y_lo, void* out_idx,
                          void* out_dist, int M, int N, int d_pad,
                          int exclude_self, void* stream) {
  if (M <= 0 || N <= 0 || d_pad <= 0 || d_pad % BK != 0) return -1;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -2;
  CUtensorMap maps[4];
  const void* ptrs[4] = {x_hi, x_lo, y_hi, y_lo};
  for (int i = 0; i < 4; ++i) {
    const CUresult r = make_map(encode, &maps[i], ptrs[i], i < 2 ? M : N,
                                d_pad);
    if (r != CUDA_SUCCESS) return 10000 + static_cast<int>(r);
  }
  const int nk = d_pad / BK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return keeps_a_resident(d_pad)
             ? launch<true>(maps, out_idx, out_dist, M, N, nk, exclude_self, s)
             : launch<false>(maps, out_idx, out_dist, M, N, nk, exclude_self,
                             s);
}

// the dynamic shared memory a launch at this d_pad asks for, in bytes
extern "C" int nn1_cosine_smem_bytes(int d_pad) {
  return smem_bytes(keeps_a_resident(d_pad), d_pad / BK);
}
