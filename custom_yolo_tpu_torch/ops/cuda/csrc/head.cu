// Fused stage of the detection head's classification tower, hand-written
// for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/head_kernel.py::_dwpw_kernel (called
// by _dwpw_stage_nochunk, twice per level through cls_tower_pallas). One
// stage is, on an NHWC tensor x (B, H, W, C):
//
//   y = SiLU(depthwise3x3(x) + dw_bias)          zero padding, (B, H, W, C)
//   z = SiLU(y · pw + pw_bias)                   1x1 conv,      (B, H, W, M)
//   logits = z · out + out_bias                  1x1 conv,      (B, H, W, NC)
//
// and writes z (project = 0) or only the logits (project = 1); y, and in
// the second case z, never reach device memory.
//
// Rounding points (the wrapper's plain twin has the same): the nine taps
// are accumulated in fp32, bias added, SiLU in fp32, then y is rounded to
// the tensor's type; each 1x1 product is accumulated in fp32 over all its
// input channels, bias added and SiLU applied in fp32, and the result is
// rounded once.
//
// Bound on the H100: operations. The two 1x1 products are 2·(C·M + M·M +
// M·NC) flops per pixel (53 GFLOP for the x preset's three levels at batch
// 8) against tens of megabytes moved. fp32 tensors are multiplied in fp32
// on the CUDA cores (67 TFLOP/s peak), bf16 tensors on the tensor cores
// (989 TFLOP/s peak) through 16x16x16 mma fragments with fp32 accumulators
// (cls_stage_kernel_tc below); wgmma and TMA are left to later work.
//
// Design (both kernels; the fp32 one is described, the bf16 one differs in
// its step of 64 channels and its operand tiles, see there): the Pallas
// kernel's 128-channel grid axis, its packed tap array
// and its host-side row chunks are what the TPU's memory asked for and are
// not carried over. Here a block owns an 8x8 pixel tile of one image, with
// a one-pixel halo of real neighbours (zeros beyond the image). For each
// pass of 128 output channels it walks the input channels 32 at a time:
// load the 10x10x32 halo tile and the 32x128 slice of the 1x1 weights into
// shared memory, compute the depthwise output of the 64 pixels x 32
// channels into a k-major tile, and multiply: 256 threads, each holding a
// 4 pixel x 8 channel accumulator block in registers. The depthwise part
// is recomputed for every pass of 128 output channels (9 multiply-adds
// against 128 per element). Finished z values wait in shared memory (M x 64,
// in the tensor's type, where they are rounded anyway) until the tile is
// complete; then they are written out, or multiplied by the logits' weights
// the same way with the ragged last pass masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int TILE = 8;                // spatial tile side
constexpr int TP = TILE * TILE;        // pixels per tile
constexpr int HALO = TILE + 2;
constexpr int KC = 32;                 // input channels per step
constexpr int NCH = 128;               // output channels per pass
constexpr int AS = TP + 4;             // row stride of the k-major A tile
constexpr int THREADS = 256;

constexpr int XS_FLOATS = HALO * HALO * KC;
constexpr int A_FLOATS = KC * AS;
constexpr int B_FLOATS = KC * NCH;
constexpr int DW_FLOATS = 10 * KC;     // nine taps and the bias per channel

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// the output channel, within a pass of 128, of accumulator column j of the
// thread whose channel group is tx
__device__ __forceinline__ int acc_channel(int tx, int j) {
  return j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4);
}

// acc[4 pixels][8 channels] += A (KC x TP, k-major) · B (KC x 128)
__device__ __forceinline__ void multiply_tile(const float* a_tile,
                                              const float* b_tile,
                                              float (&acc)[4][8], int tx,
                                              int ty) {
#pragma unroll 8
  for (int k = 0; k < KC; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(a_tile + k * AS + ty * 4);
    const float4 b0 =
        *reinterpret_cast<const float4*>(b_tile + k * NCH + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(b_tile + k * NCH + 64 + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cls_stage_kernel(const T* __restrict__ x, const T* __restrict__ dwk,
                 const T* __restrict__ dwb, const T* __restrict__ pwk,
                 const T* __restrict__ pwb, const T* __restrict__ outk,
                 const T* __restrict__ outb, T* __restrict__ out, int h, int w,
                 int c, int m, int nc, int tiles_w, int project) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* a_tile = xs + XS_FLOATS;
  float* b_tile = a_tile + A_FLOATS;
  float* dws = b_tile + B_FLOATS;
  T* zs = reinterpret_cast<T*>(dws + DW_FLOATS);   // (m, TP), channel-major

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int th0 = (blockIdx.x / tiles_w) * TILE;
  const int tw0 = (blockIdx.x % tiles_w) * TILE;
  const size_t img = blockIdx.y;
  const T* xb = x + img * h * w * c;

  // ---- z = SiLU(SiLU(dw(x) + b) · pw + b), 128 output channels a pass
  for (int n0 = 0; n0 < m; n0 += NCH) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < c; k0 += KC) {
      // the loads of a step are independent: unrolled, they are all in
      // flight before the first is used
#pragma unroll
      for (int e = tid; e < XS_FLOATS; e += THREADS) {
        const int cc = e % KC, hp = e / KC;
        const int hh = th0 - 1 + hp / HALO, ww = tw0 - 1 + hp % HALO;
        float v = 0.0f;
        if (hh >= 0 && hh < h && ww >= 0 && ww < w)
          v = as_float(xb[((size_t)hh * w + ww) * c + k0 + cc]);
        xs[e] = v;
      }
#pragma unroll
      for (int e = tid; e < DW_FLOATS; e += THREADS) {
        const int r = e / KC, cc = e % KC;
        dws[e] = r < 9 ? as_float(dwk[(size_t)r * c + k0 + cc])
                       : as_float(dwb[k0 + cc]);
      }
#pragma unroll
      for (int e = tid; e < B_FLOATS; e += THREADS) {
        const int k = e / NCH, n = e % NCH;
        b_tile[e] = as_float(pwk[(size_t)(k0 + k) * m + n0 + n]);
      }
      __syncthreads();

      {  // depthwise 3x3 of one tile row (8 pixels) for one channel
        const int cc = tid % KC, row = tid / KC;
        float taps[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) taps[t] = dws[t * KC + cc];
        const float bias = dws[9 * KC + cc];
#pragma unroll
        for (int col = 0; col < TILE; ++col) {
          float s = 0.0f;
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj)
              s = fmaf(xs[((row + di) * HALO + col + dj) * KC + cc],
                       taps[di * 3 + dj], s);
          const T y = from_float<T>(silu(s + bias));
          a_tile[cc * AS + row * TILE + col] = as_float(y);
        }
      }
      __syncthreads();
      multiply_tile(a_tile, b_tile, acc, tx, ty);
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = n0 + acc_channel(tx, j);
      const float bias = as_float(pwb[ch]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        zs[(size_t)ch * TP + ty * 4 + i] =
            from_float<T>(silu(acc[i][j] + bias));
    }
  }
  __syncthreads();

  if (!project) {
    T* ob = out + img * h * w * m;
    for (int e = tid; e < TP * m; e += THREADS) {
      const int ch = e % m, pix = e / m;
      const int hh = th0 + pix / TILE, ww = tw0 + pix % TILE;
      if (hh < h && ww < w)
        ob[((size_t)hh * w + ww) * m + ch] = zs[(size_t)ch * TP + pix];
    }
    return;
  }

  // ---- logits = z · out + b, the last pass ragged
  T* ob = out + img * h * w * nc;
  for (int n0 = 0; n0 < nc; n0 += NCH) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < m; k0 += KC) {
      for (int e = tid; e < KC * TP; e += THREADS) {
        const int k = e / TP, pix = e % TP;
        a_tile[k * AS + pix] = as_float(zs[(size_t)(k0 + k) * TP + pix]);
      }
#pragma unroll
      for (int e = tid; e < B_FLOATS; e += THREADS) {
        const int k = e / NCH, n = n0 + e % NCH;
        b_tile[e] = n < nc ? as_float(outk[(size_t)(k0 + k) * nc + n]) : 0.0f;
      }
      __syncthreads();
      multiply_tile(a_tile, b_tile, acc, tx, ty);
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ch = n0 + acc_channel(tx, j);
      if (ch >= nc) continue;
      const float bias = as_float(outb[ch]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pix = ty * 4 + i;
        const int hh = th0 + pix / TILE, ww = tw0 + pix % TILE;
        if (hh < h && ww < w)
          ob[((size_t)hh * w + ww) * nc + ch] = from_float<T>(acc[i][j] + bias);
      }
    }
  }
}


// ------------------------------------------------ bf16 on the tensor cores
// The same tile and the same passes, with the two products on the tensor
// cores (16x16x16 bf16 fragments, fp32 accumulators). Eight warps own the
// 64 x 128 output of a pass as 4 (pixels) x 2 (channels) blocks of one by
// four fragments. A step takes 64 input channels. The depthwise output is
// written k-major in bf16 (a column-major A operand), the 1x1 weights are
// copied as they lie (row-major B), finished z values wait channel-major
// in bf16 and are the A operand of the logits product as they lie. The
// accumulators pass through an fp32 staging tile, which reuses the staging
// area of the operands, for bias, SiLU and the one rounding.
constexpr int WK = 64;                  // input channels per step
constexpr int A_LD = TP + 8;            // bf16 elements
constexpr int B_LD = NCH + 8;           // bf16 elements
constexpr int C_LD = NCH + 4;           // floats
constexpr int Z_LD = TP + 8;            // bf16 elements
constexpr int TC_XS_BYTES = HALO * HALO * WK * 4;
constexpr int TC_DW_BYTES = 10 * WK * 4;
constexpr int TC_A_BYTES = WK * A_LD * 2;
constexpr int TC_B_BYTES = WK * B_LD * 2;
constexpr int TC_STAGE_BYTES =
    TC_XS_BYTES + TC_DW_BYTES + TC_A_BYTES + TC_B_BYTES;
static_assert(TP * C_LD * 4 <= TC_STAGE_BYTES,
              "the fp32 staging tile reuses the operands' staging area");

using bf16 = __nv_bfloat16;
using FragA = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, bf16,
                                     nvcuda::wmma::col_major>;
using FragB = nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, bf16,
                                     nvcuda::wmma::row_major>;
using FragC = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16,
                                     float>;

// acc[4] += A (col-major, WK deep from `a`, leading dimension a_ld) · B tile
__device__ __forceinline__ void multiply_fragments(const bf16* a, int a_ld,
                                                   const bf16* b_tile,
                                                   FragC (&acc)[4], int wr,
                                                   int wc) {
#pragma unroll
  for (int kk = 0; kk < WK; kk += 16) {
    FragA fa;
    nvcuda::wmma::load_matrix_sync(fa, a + kk * a_ld + 16 * wr, a_ld);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB fb;
      nvcuda::wmma::load_matrix_sync(
          fb, b_tile + kk * B_LD + 64 * wc + 16 * j, B_LD);
      nvcuda::wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

__device__ __forceinline__ void store_fragments(float* c_stage,
                                                FragC (&acc)[4], int wr,
                                                int wc) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    nvcuda::wmma::store_matrix_sync(
        c_stage + 16 * wr * C_LD + 64 * wc + 16 * j, acc[j], C_LD,
        nvcuda::wmma::mem_row_major);
}

__global__ void __launch_bounds__(THREADS)
cls_stage_kernel_tc(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                    const bf16* __restrict__ dwb, const bf16* __restrict__ pwk,
                    const bf16* __restrict__ pwb,
                    const bf16* __restrict__ outk,
                    const bf16* __restrict__ outb, bf16* __restrict__ out,
                    int h, int w, int c, int m, int nc, int tiles_w,
                    int project) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  float* xs = reinterpret_cast<float*>(smem_tc);
  float* dws = reinterpret_cast<float*>(smem_tc + TC_XS_BYTES);
  bf16* a_tile = reinterpret_cast<bf16*>(smem_tc + TC_XS_BYTES + TC_DW_BYTES);
  bf16* b_tile = reinterpret_cast<bf16*>(smem_tc + TC_XS_BYTES + TC_DW_BYTES +
                                         TC_A_BYTES);
  float* c_stage = reinterpret_cast<float*>(smem_tc);    // reuses the above
  bf16* zs = reinterpret_cast<bf16*>(smem_tc + TC_STAGE_BYTES);  // (m, Z_LD)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1, wc = warp & 1;
  const int th0 = (blockIdx.x / tiles_w) * TILE;
  const int tw0 = (blockIdx.x % tiles_w) * TILE;
  const size_t img = blockIdx.y;
  const bf16* xb = x + img * h * w * c;

  for (int n0 = 0; n0 < m; n0 += NCH) {
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.0f);

    for (int k0 = 0; k0 < c; k0 += WK) {
      // the loads of a step are independent: unrolled, they are all in
      // flight before the first is used. 16 bytes (8 channels) a load.
#pragma unroll
      for (int e = tid; e < HALO * HALO * (WK / 8); e += THREADS) {
        const int c8 = e % (WK / 8), hp = e / (WK / 8);
        const int hh = th0 - 1 + hp / HALO, ww = tw0 - 1 + hp % HALO;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);         // eight bf16 zeros
        if (hh >= 0 && hh < h && ww >= 0 && ww < w)
          raw = *reinterpret_cast<const uint4*>(
              xb + ((size_t)hh * w + ww) * c + k0 + 8 * c8);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
        float4* dst = reinterpret_cast<float4*>(xs + hp * WK + 8 * c8);
        dst[0] = make_float4(__bfloat162float(v[0]), __bfloat162float(v[1]),
                             __bfloat162float(v[2]), __bfloat162float(v[3]));
        dst[1] = make_float4(__bfloat162float(v[4]), __bfloat162float(v[5]),
                             __bfloat162float(v[6]), __bfloat162float(v[7]));
      }
#pragma unroll
      for (int e = tid; e < 10 * WK; e += THREADS) {
        const int r = e / WK, cc = e % WK;
        dws[e] = __bfloat162float(r < 9 ? dwk[(size_t)r * c + k0 + cc]
                                        : dwb[k0 + cc]);
      }
      // 64 x 128 weights, 16 bytes (8 values) a load
#pragma unroll
      for (int e = tid; e < WK * (NCH / 8); e += THREADS) {
        const int k = e / (NCH / 8), n8 = e % (NCH / 8);
        *reinterpret_cast<uint4*>(b_tile + k * B_LD + 8 * n8) =
            *reinterpret_cast<const uint4*>(pwk + (size_t)(k0 + k) * m + n0 +
                                            8 * n8);
      }
      __syncthreads();

      {  // depthwise 3x3 of two tile rows (16 pixels) for one channel
        const int cc = tid % WK, row0 = 2 * (tid / WK);
        float taps[9];
#pragma unroll
        for (int t = 0; t < 9; ++t) taps[t] = dws[t * WK + cc];
        const float bias = dws[9 * WK + cc];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int col = 0; col < TILE; ++col) {
            const int row = row0 + r;
            float s = 0.0f;
#pragma unroll
            for (int di = 0; di < 3; ++di)
#pragma unroll
              for (int dj = 0; dj < 3; ++dj)
                s = fmaf(xs[((row + di) * HALO + col + dj) * WK + cc],
                         taps[di * 3 + dj], s);
            a_tile[cc * A_LD + row * TILE + col] =
                __float2bfloat16_rn(silu(s + bias));
          }
      }
      __syncthreads();
      multiply_fragments(a_tile, A_LD, b_tile, acc, wr, wc);
      __syncthreads();
    }

    store_fragments(c_stage, acc, wr, wc);
    __syncthreads();
    for (int e = tid; e < TP * NCH; e += THREADS) {
      const int n = e % NCH, pix = e / NCH;
      const float v = c_stage[pix * C_LD + n] + __bfloat162float(pwb[n0 + n]);
      zs[(size_t)(n0 + n) * Z_LD + pix] = __float2bfloat16_rn(silu(v));
    }
    __syncthreads();
  }

  if (!project) {
    bf16* ob = out + img * h * w * m;
    for (int e = tid; e < TP * m; e += THREADS) {
      const int ch = e % m, pix = e / m;
      const int hh = th0 + pix / TILE, ww = tw0 + pix % TILE;
      if (hh < h && ww < w)
        ob[((size_t)hh * w + ww) * m + ch] = zs[(size_t)ch * Z_LD + pix];
    }
    return;
  }

  bf16* ob = out + img * h * w * nc;
  for (int n0 = 0; n0 < nc; n0 += NCH) {
    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[j], 0.0f);

    for (int k0 = 0; k0 < m; k0 += WK) {
#pragma unroll 8
      for (int e = tid; e < WK * NCH; e += THREADS) {
        const int k = e / NCH, n = e % NCH;
        b_tile[k * B_LD + n] = n0 + n < nc
                                   ? outk[(size_t)(k0 + k) * nc + n0 + n]
                                   : __float2bfloat16_rn(0.0f);
      }
      __syncthreads();
      multiply_fragments(zs + (size_t)k0 * Z_LD, Z_LD, b_tile, acc, wr, wc);
      __syncthreads();
    }

    store_fragments(c_stage, acc, wr, wc);
    __syncthreads();
    for (int e = tid; e < TP * NCH; e += THREADS) {
      const int n = e % NCH, pix = e / NCH;
      const int hh = th0 + pix / TILE, ww = tw0 + pix % TILE;
      if (n0 + n < nc && hh < h && ww < w)
        ob[((size_t)hh * w + ww) * nc + n0 + n] = __float2bfloat16_rn(
            c_stage[pix * C_LD + n] + __bfloat162float(outb[n0 + n]));
    }
    __syncthreads();
  }
}

size_t smem_bytes(int m, int elem_size) {
  if (elem_size == 2) return (size_t)TC_STAGE_BYTES + (size_t)m * Z_LD * 2;
  return (size_t)(XS_FLOATS + A_FLOATS + B_FLOATS + DW_FLOATS) * sizeof(float) +
         (size_t)m * TP * elem_size;
}

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* x, const void* dwk, const void* dwb,
           const void* pwk, const void* pwb, const void* outk,
           const void* outb, void* out, int b, int h, int w, int c, int m,
           int nc, int project, cudaStream_t stream) {
  const size_t smem = smem_bytes(m, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + TILE - 1) / TILE, tiles_h = (h + TILE - 1) / TILE;
  const dim3 grid(tiles_w * tiles_h, b);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dwk),
      static_cast<const T*>(dwb), static_cast<const T*>(pwk),
      static_cast<const T*>(pwb), static_cast<const T*>(outk),
      static_cast<const T*>(outb), static_cast<T*>(out), h, w, c, m, nc,
      tiles_w, project);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// shared memory of one block for m middle channels
long long cls_stage_smem_bytes(int m, int elem_size) {
  return (long long)smem_bytes(m, elem_size);
}

// x (b, h, w, c) NHWC; dwk (9, c) tap-major; dwb (c); pwk (c, m); pwb (m);
// outk (m, nc) and outb (nc) read only when project != 0. out is
// (b, h, w, m), or (b, h, w, nc) when project != 0. c must be a multiple
// of 64 and m of 128. All arrays hold `elem_size`-byte elements (2: bf16,
// 4: fp32). Returns cudaGetLastError() after the launch (0 on success).
int cls_stage(const void* x, const void* dwk, const void* dwb, const void* pwk,
              const void* pwb, const void* outk, const void* outb, void* out,
              int b, int h, int w, int c, int m, int nc, int project,
              int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 2)
    return launch<bf16>(cls_stage_kernel_tc, x, dwk, dwb, pwk, pwb, outk,
                        outb, out, b, h, w, c, m, nc, project, s);
  return launch<float>(cls_stage_kernel<float>, x, dwk, dwb, pwk, pwb, outk,
                       outb, out, b, h, w, c, m, nc, project, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
