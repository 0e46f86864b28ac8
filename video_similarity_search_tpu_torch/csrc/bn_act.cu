// The 3-D ResNet's eval-mode BatchNorm epilogue in one pass over the
// activation on Hopper (sm_90a): BatchNorm by the running statistics, an
// optional residual, and ReLU.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm, the residual
// add and ReLU to XLA, which fuses them into the convolutions' neighbours
// (video_similarity_search_tpu/models/resnet3d.py, BasicBlock3d,
// Bottleneck3d and the stem). PyTorch's eager eval forward runs them as
// separate elementwise passes (BatchNorm's broadcasting TensorIterator, an
// add, and a ReLU after each), which read and write the activation up to
// five times a block.
//
//   mode 0:  out = relu(x * s + t)
//   mode 1:  out = relu(x * s + t + r)
//   mode 2:  out = relu(x * s + t + (r * s2 + t2))
//
// with s = w / sqrt(var + eps) and t = b - mean * s of one BatchNorm, and
// s2 and t2 of a second (shortcut B's downsample BatchNorm, whose input,
// the downsample convolution's output, comes in as r). All arithmetic is
// float32 (fmaf for x * s + t and r * s2 + t2); the result is rounded once
// to the output's type.
//
// Operands. x, r, out: bfloat16 or float32 (rows, C) row-major, the memory
// of a channels_last_3d (N, C, T, H, W) tensor (rows = N T H W), 16-byte
// aligned, C a multiple of 16 bytes' worth of elements (8 bf16, 4 float32).
// out may be x (in place). The BatchNorm parameters and statistics are
// float32 vectors of C.
//
// Bound. Bytes: x and r read once and out written once; at R3D-18's
// layer1 in an embedding batch (256 x 64 x 16 x 64 x 64 bf16, 2.15 GB a
// tensor) a mode-1 pass moves 6.4 GB, 1.92 ms at 3.35 TB/s. The arithmetic
// (2-4 FMAs an element) is far below the card's rate.
//
// Design. Every load and store is 16 bytes a thread. threadIdx.x picks a
// fixed 16-byte group of channels (blockIdx.y a span of 256 groups where
// C has more), so each thread computes its groups' s and t once, at the
// start, and keeps them in registers; threadIdx.y picks the row, so a
// warp's loads cover consecutive rows and neighbouring threads read
// neighbouring 16-byte chunks. A block takes a tile of UNROLL x blockDim.y
// rows and issues all of its loads before its first store, to keep
// enough bytes in flight per SM. The grid holds one block a tile (a
// grid-stride loop covers rows beyond the grid's limit): on the H100 this
// ran 5-10% faster than one resident wave of blocks walking the rows,
// whose SMs run out of work unevenly at its end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // threads a block
constexpr int GROUPS = 256;   // 16-byte channel groups a block's x extent
constexpr int UNROLL = 4;     // row tiles a thread loads before it stores

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

struct Norm {
  const float* w;
  const float* b;
  const float* mean;
  const float* var;
  float eps;
};

template <int N>
__device__ __forceinline__ void scale_shift(const Norm& n, int c0, float* s,
                                            float* t) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] = n.w[c0 + i] * (1.0f / sqrtf(n.var[c0 + i] + n.eps));
    t[i] = n.b[c0 + i] - n.mean[c0 + i] * s[i];
  }
}

template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
    bn_act_kernel(const T* x, const T* __restrict__ r, T* out, long long rows,
                  int groups, Norm n, Norm n2) {
  constexpr int V = Vec<T>::N;
  const int g = blockIdx.y * GROUPS + threadIdx.x;
  if (g >= groups) return;
  const long long C = static_cast<long long>(groups) * V;
  const int c0 = g * V;
  float s[V], t[V], s2[V], t2[V];
  scale_shift<V>(n, c0, s, t);
  if (MODE == 2) scale_shift<V>(n2, c0, s2, t2);
  const long long tile = blockDim.y;
  const long long step = static_cast<long long>(gridDim.x) * tile * UNROLL;
  for (long long row0 = blockIdx.x * tile * UNROLL + threadIdx.y;
       row0 < rows; row0 += step) {
    uint4 xv[UNROLL], rv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = row0 + u * tile;
      if (row < rows) {
        xv[u] = *reinterpret_cast<const uint4*>(x + row * C + c0);
        if (MODE != 0)
          rv[u] = __ldg(reinterpret_cast<const uint4*>(r + row * C + c0));
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long row = row0 + u * tile;
      if (row < rows) {
        float y[V], z[V];
        unpack(xv[u], y, x);
        if (MODE != 0) unpack(rv[u], z, x);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float v = fmaf(y[i], s[i], t[i]);
          if (MODE == 1) v += z[i];
          if (MODE == 2) v += fmaf(z[i], s2[i], t2[i]);
          y[i] = v <= 0.0f ? 0.0f : v;  // NaN stays NaN, as torch's ReLU
        }
        *reinterpret_cast<uint4*>(out + row * C + c0) = pack(y, x);
      }
    }
  }
}

template <typename T, int MODE>
int launch(const void* x, const void* r, void* out, long long rows, int C,
           const Norm& n, const Norm& n2, cudaStream_t stream) {
  constexpr int V = Vec<T>::N;
  const int groups = C / V;
  const int bx = groups < GROUPS ? groups : GROUPS;
  const dim3 block(bx, THREADS / bx);
  const int spans = (groups + GROUPS - 1) / GROUPS;
  const long long rows_a_block = static_cast<long long>(block.y) * UNROLL;
  const long long tiles = (rows + rows_a_block - 1) / rows_a_block;
  const int grid_x = static_cast<int>(tiles < INT32_MAX ? tiles : INT32_MAX);
  bn_act_kernel<T, MODE><<<dim3(grid_x, spans), block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<T*>(out), rows, groups, n, n2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int mode, const void* x, const void* r, void* out,
             long long rows, int C, const Norm& n, const Norm& n2,
             cudaStream_t stream) {
  switch (mode) {
    case 0:
      return launch<T, 0>(x, r, out, rows, C, n, n2, stream);
    case 1:
      return launch<T, 1>(x, r, out, rows, C, n, n2, stream);
    case 2:
      return launch<T, 2>(x, r, out, rows, C, n, n2, stream);
  }
  return -1;
}

}  // namespace

extern "C" {

// 0 on success; -1: arguments the kernel does not take; else a
// cudaError_t. dtype 0: bfloat16, 1: float32. mode 0: no residual (r and
// the second BatchNorm unused), 1: r added, 2: r through the second
// BatchNorm, then added.
int bn_act(const void* x, const void* r, void* out, long long rows, int C,
           int dtype, int mode, const float* w, const float* b,
           const float* mean, const float* var, float eps, const float* w2,
           const float* b2, const float* mean2, const float* var2, float eps2,
           cudaStream_t stream) {
  const int vec = dtype == 0 ? Vec<__nv_bfloat16>::N : Vec<float>::N;
  if (rows < 0 || C <= 0 || C % vec || mode < 0 || mode > 2 ||
      (dtype != 0 && dtype != 1))
    return -1;
  if (rows == 0) return 0;
  if ((mode != 0 && r == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(r) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return -1;
  const Norm n{w, b, mean, var, eps};
  const Norm n2{w2, b2, mean2, var2, eps2};
  if (dtype == 0)
    return dispatch<__nv_bfloat16>(mode, x, r, out, rows, C, n, n2, stream);
  return dispatch<float>(mode, x, r, out, rows, C, n, n2, stream);
}

}  // extern "C"
