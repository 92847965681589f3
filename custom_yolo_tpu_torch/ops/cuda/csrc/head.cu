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
// rounded once; the logits are the fp32 sum plus bias, rounded once.
//
// Bound on the H100: operations. The two 1x1 products are 2·(C·M + M·M +
// M·NC) flops per pixel (53 GFLOP for the x preset's three levels at batch
// 8) against tens of megabytes moved. bf16 tensors are multiplied on the
// tensor cores (989 TFLOP/s peak; cls_stage_kernel_tc), fp32 tensors in
// fp32 on the CUDA cores (67 TFLOP/s peak; cls_stage_kernel).
//
// bf16 (cls_stage_kernel_tc):
//  - A block owns an 8x8 pixel tile of one image and up to 384 output
//    channels at once (all M = 384 of the x preset: one pass, so the
//    depthwise runs once per input channel and pixel, not once per pass of
//    output channels). Eight warps as 2 (pixel halves) x 4 (channel
//    quarters): a warp holds a 32 x 96 fp32 accumulator, 2 x 12 m16n8
//    tiles, 96 registers a thread. M = 256 or 128 take narrower passes
//    (one per 256 or 128 channels); 384 < M takes several.
//  - It walks the input channels 32 at a time. The bf16 halo tile (10x10
//    pixels x 32 channels, rows padded to 80 bytes so the depthwise reads
//    are conflict-free) with the step's taps and biases, and the 32 x 384
//    slice of the 1x1 weights arrive by 16-byte cp.async through
//    three-slot rings. The depthwise runs one step ahead of the products:
//    step k issues the copies of halo k+3 and weights k+2, computes the
//    depthwise of step k+1 into one of two bf16 A tiles, and multiplies
//    the other (step k) on the tensor cores, with one barrier a step.
//  - Products are mma.sync.m16n8k16 (bf16 → fp32) from ldmatrix fragments
//    (attention_tiles.cuh), the weights read k-major with ldmatrix.trans.
//  - The epilogue works on the accumulator fragments in registers: bias,
//    SiLU (the special-function unit's exponential and a fast division:
//    the exact forms cost as much as the products), one rounding, straight
//    into a bf16 z tile (64 x M) in shared memory, which is copied out by
//    16-byte stores (project = 0) or is the A operand of the logits
//    (project = 1).
//  - The logits run in passes of 192 channels as n8 tiles (NC = 172 pads
//    to 176). Their weights stream the same way; rows of 172 bf16 are not
//    16-byte multiples, and 4-byte copies of them took as long as the
//    stage's products, so the wrapper pads the kernel's columns to a
//    multiple of 8. The rounded logits are staged in the halo ring and
//    stored by rows of contiguous channels.
//  Shared memory at M = 384: 161,600 B a block; registers (~200-230 a
//  thread) allow one block of 256 threads an SM. Grids: 800 / 200 / 72
//  blocks at the x levels (80², 40², 20²) and batch 8. Where the time goes
//  (ablation, scripts/torch_head_probe.py): PERF.md.
//
// fp32 (cls_stage_kernel): a block owns an 8x8 pixel tile of one image,
// with a one-pixel halo of real neighbours (zeros beyond the image). For
// each pass of 128 output channels it walks the input channels 32 at a
// time: load the 10x10x32 halo tile and the 32x128 slice of the 1x1
// weights into shared memory, compute the depthwise output of the 64
// pixels x 32 channels into a k-major tile, and multiply: 256 threads,
// each holding a 4 pixel x 8 channel accumulator block in registers. The
// depthwise part is recomputed for every pass of 128 output channels.
// Finished z values wait in shared memory (M x 64) until the tile is
// complete; then they are written out, or multiplied by the logits'
// weights the same way with the ragged last pass masked.
//
// The ablation build of scripts/torch_head_probe.py defines
// K6_ABLATE_COPIES, K6_ABLATE_DEPTHWISE or K6_ABLATE_PRODUCTS to leave one
// part of the bf16 kernel's step out (its results are then wrong); the
// port's own build defines none of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tiles.cuh"

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
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
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
using psa::bf16;

constexpr int TC_KC = 32;                   // input channels per step
constexpr int HALO_PX = HALO * HALO;
constexpr int HX_LD = TC_KC + 8;            // bf16 per halo pixel (80 B)
constexpr int HALO_ELEMS = HALO_PX * HX_LD;
constexpr int HSLOT = HALO_ELEMS + 10 * TC_KC;  // + nine taps and the bias
constexpr int A_LD = TC_KC + 8;             // depthwise tile [pixel][k]
constexpr int A_ELEMS = TP * A_LD;
constexpr int RING = 3;                     // slots of each copy ring
constexpr int LW = 192;                     // logits channels per pass
constexpr int LNT = LW / 32;                // n8 tiles a warp per pass
constexpr int LW_LD = LW + 8;
static_assert(TP * LW_LD <= RING * HSLOT,
              "the logits staging tile reuses the halo ring");

// output channels of one pass: four warps of NT n8 tiles
template <int NT> __host__ __device__ constexpr int pass_width() {
  return 32 * NT;
}
template <int NT> __host__ __device__ constexpr int w_ld() {
  return pass_width<NT>() + 8;
}
template <int NT> __host__ __device__ constexpr int wslot() {
  return TC_KC * w_ld<NT>() > TC_KC * LW_LD ? TC_KC * w_ld<NT>()
                                            : TC_KC * LW_LD;
}
template <int NT> constexpr size_t tc_smem_bytes(int m) {
  return 2 * (RING * HSLOT + RING * wslot<NT>() + 2 * A_ELEMS) +
         (size_t)TP * (m + 8) * 2;
}

// SiLU in fp32 with the special-function unit's exponential (2 ulp) and a
// fast division; the value is rounded to bf16 right after. The exact form
// (expf and an IEEE division) cost about as much as the products in the
// epilogue.
__device__ __forceinline__ float silu_fast(float v) {
  return __fdividef(v, 1.0f + __expf(-v));
}

__device__ __forceinline__ float2 bf2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// halo tile of input channels k0..k0+31 of the block's pixels (zeros
// beyond the image) and the taps and biases of those channels
__device__ __forceinline__ void issue_halo(bf16* slot, const bf16* xb,
                                           const bf16* dwk, const bf16* dwb,
                                           int k0, int th0, int tw0, int h,
                                           int w, int c) {
#ifndef K6_ABLATE_COPIES
  for (int e = threadIdx.x; e < HALO_PX * 4 + 40; e += THREADS) {
    if (e < HALO_PX * 4) {
      const int hp = e >> 2, c8 = (e & 3) * 8;
      const int hh = th0 - 1 + hp / HALO, ww = tw0 - 1 + hp % HALO;
      const bool ok = hh >= 0 && hh < h && ww >= 0 && ww < w;
      psa::cp_async16(slot + hp * HX_LD + c8,
                      ok ? xb + ((size_t)hh * w + ww) * c + k0 + c8 : xb, ok);
    } else {
      const int r = (e - HALO_PX * 4) >> 2, c8 = (e & 3) * 8;
      psa::cp_async16(slot + HALO_ELEMS + r * TC_KC + c8,
                      r < 9 ? dwk + (size_t)r * c + k0 + c8 : dwb + k0 + c8,
                      true);
    }
  }
#endif
}

// rows k0..k0+31, columns n0..n0+NW-1 of the 1x1 weights (c x m)
template <int NT>
__device__ __forceinline__ void issue_weights(bf16* slot, const bf16* pwk,
                                              int k0, int n0, int m) {
#ifndef K6_ABLATE_COPIES
  constexpr int CHUNKS = pass_width<NT>() / 8;
#pragma unroll
  for (int i = 0; i < TC_KC * CHUNKS / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CHUNKS, c8 = (e % CHUNKS) * 8;
    psa::cp_async16(slot + r * w_ld<NT>() + c8,
                    pwk + (size_t)(k0 + r) * m + n0 + c8, true);
  }
#endif
}

// rows k0..k0+31, columns q0..q0+LW-1 of the logits' weights (m rows of
// `ld` elements, a multiple of 8: the wrapper pads them), zeros past ld
__device__ __forceinline__ void issue_logit_weights(bf16* slot,
                                                    const bf16* outk, int k0,
                                                    int q0, int ld) {
#ifndef K6_ABLATE_COPIES
  constexpr int CHUNKS = LW / 8;
#pragma unroll
  for (int i = 0; i < TC_KC * CHUNKS / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / CHUNKS, col = (e % CHUNKS) * 8;
    const bool ok = q0 + col < ld;
    psa::cp_async16(slot + r * LW_LD + col,
                    ok ? outk + (size_t)(k0 + r) * ld + q0 + col : outk, ok);
  }
#endif
}

// depthwise 3x3 + bias + SiLU of one step's 64 pixels x 32 channels, fp32,
// rounded once into the A tile [pixel][k]: a thread takes two channels of
// four neighbouring pixels (a half row), a warp one tile row
__device__ __forceinline__ void depthwise(bf16* a, const bf16* slot) {
#ifndef K6_ABLATE_DEPTHWISE
  const int pr = threadIdx.x & 15, half = (threadIdx.x >> 4) & 1;
  const int row = threadIdx.x >> 5, ch = 2 * pr;
  const bf16* dw = slot + HALO_ELEMS;
  float2 tap[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) tap[t] = bf2_at(dw + t * TC_KC + ch);
  const float2 bias = bf2_at(dw + 9 * TC_KC + ch);
  float2 win[3][6];
#pragma unroll
  for (int di = 0; di < 3; ++di)
#pragma unroll
    for (int dj = 0; dj < 6; ++dj)
      win[di][dj] =
          bf2_at(slot + ((row + di) * HALO + 4 * half + dj) * HX_LD + ch);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int di = 0; di < 3; ++di)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        s0 = fmaf(win[di][j + dj].x, tap[di * 3 + dj].x, s0);
        s1 = fmaf(win[di][j + dj].y, tap[di * 3 + dj].y, s1);
      }
    const int p = row * TILE + 4 * half + j;
    *reinterpret_cast<uint32_t*>(a + p * A_LD + ch) =
        psa::pack(silu_fast(s0 + bias.x), silu_fast(s1 + bias.y));
  }
#endif
}

// acc[mt][n] += A rows 32·wm + 16·mt.. (k0..k0+31 of a [pixel][k] tile with
// row stride a_ld) · B columns nb + 8n.. (a [k][n] slot with row stride
// b_ld); n8 tile pairs whose first column is at or past `limit` are left
// out (a warp-uniform test)
template <int NT>
__device__ __forceinline__ void product(float (&acc)[2][NT][4], const bf16* a,
                                        int a_ld, int k0, const bf16* b,
                                        int b_ld, int nb, int limit, int wm,
                                        int lane) {
#ifndef K6_ABLATE_PRODUCTS
#pragma unroll
  for (int kk = 0; kk < TC_KC / 16; ++kk) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      psa::ldsm_x4(af[mt], psa::frag_a_addr(a, a_ld, 32 * wm + 16 * mt,
                                            k0 + 16 * kk, lane));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (nb + 16 * j >= limit) continue;
      uint32_t bf[4];
      psa::ldsm_x4_t(bf, psa::frag_a_addr(b, b_ld, 16 * kk, nb + 16 * j,
                                          lane));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        psa::mma(acc[mt][2 * j], af[mt], bf[0], bf[1]);
        psa::mma(acc[mt][2 * j + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
#endif
}

template <int NT>
__global__ void __launch_bounds__(THREADS, 1)
cls_stage_kernel_tc(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                    const bf16* __restrict__ dwb, const bf16* __restrict__ pwk,
                    const bf16* __restrict__ pwb,
                    const bf16* __restrict__ outk,
                    const bf16* __restrict__ outb, bf16* __restrict__ out,
                    int h, int w, int c, int m, int nc, int out_ld,
                    int tiles_w, int project) {
  constexpr int NW = pass_width<NT>();
  constexpr int WSLOT = wslot<NT>();
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* hs = reinterpret_cast<bf16*>(smem_tc);  // RING halo slots
  bf16* ws = hs + RING * HSLOT;                 // RING weight slots
  bf16* as = ws + RING * WSLOT;                 // 2 depthwise tiles
  bf16* zs = as + 2 * A_ELEMS;                  // z: [TP][m + 8]
  const int z_ld = m + 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  const int th0 = (blockIdx.x / tiles_w) * TILE;
  const int tw0 = (blockIdx.x % tiles_w) * TILE;
  const size_t img = blockIdx.y;
  const bf16* xb = x + img * h * w * c;
  const int steps = c / TC_KC;

  // Copy group j holds halo j+1 and weights j, in slots (j+1) % RING and
  // j % RING; step k waits for group k, then issues group k + RING − 1,
  // whose halo slot held halo k (read by the depthwise of step k, during
  // step k − 1) and whose weight slot held weights k − 1 (read by step
  // k − 1's products): both are free once every warp has passed step k's
  // barrier.
  auto issue_group = [&](int j, int n0) {
    if (j + 1 < steps)
      issue_halo(hs + ((j + 1) % RING) * HSLOT, xb, dwk, dwb, (j + 1) * TC_KC,
                 th0, tw0, h, w, c);
    if (j < steps)
      issue_weights<NT>(ws + (j % RING) * WSLOT, pwk, j * TC_KC, n0, m);
    psa::cp_async_commit();
  };

  // ---- z = SiLU(SiLU(dw(x) + b) · pw + b), NW output channels a pass
  for (int n0 = 0; n0 < m; n0 += NW) {
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;

    __syncthreads();  // the previous pass no longer reads the slots
    issue_halo(hs, xb, dwk, dwb, 0, th0, tw0, h, w, c);
    psa::cp_async_commit();
    for (int j = 0; j < RING - 1; ++j) issue_group(j, n0);
    psa::cp_async_wait<RING - 1>();  // halo 0
    __syncthreads();
    depthwise(as, hs);
    for (int k = 0; k < steps; ++k) {
      // group k has landed, the depthwise of step k is in its A tile, and
      // every warp is done with step k − 1
      psa::cp_async_wait<RING - 2>();
      __syncthreads();
      issue_group(k + RING - 1, n0);
      if (k + 1 < steps)
        depthwise(as + ((k + 1) & 1) * A_ELEMS,
                  hs + ((k + 1) % RING) * HSLOT);
      product<NT>(acc, as + (k & 1) * A_ELEMS, A_LD, 0,
                  ws + (k % RING) * WSLOT, w_ld<NT>(), wn * 8 * NT, NW, wm,
                  lane);
    }

    // bias, SiLU and one rounding on the fragments, into z
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int ch = n0 + wn * 8 * NT + 8 * n + t2;
      const float2 bias = bf2_at(pwb + ch);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = 32 * wm + 16 * mt + g;
        *reinterpret_cast<uint32_t*>(zs + p * z_ld + ch) =
            psa::pack(silu_fast(acc[mt][n][0] + bias.x),
                      silu_fast(acc[mt][n][1] + bias.y));
        *reinterpret_cast<uint32_t*>(zs + (p + 8) * z_ld + ch) =
            psa::pack(silu_fast(acc[mt][n][2] + bias.x),
                      silu_fast(acc[mt][n][3] + bias.y));
      }
    }
  }
  __syncthreads();

  if (!project) {
    bf16* ob = out + img * h * w * m;
    const int chunks = m / 8;
    for (int e = tid; e < TP * chunks; e += THREADS) {
      const int p = e / chunks, c8 = (e % chunks) * 8;
      const int hh = th0 + p / TILE, ww = tw0 + p % TILE;
      if (hh < h && ww < w)
        *reinterpret_cast<uint4*>(ob + ((size_t)hh * w + ww) * m + c8) =
            *reinterpret_cast<const uint4*>(zs + p * z_ld + c8);
    }
    return;
  }

  // ---- logits = z · out + b, LW channels a pass, n8 tiles past nc skipped
  bf16* ob = out + img * h * w * nc;
  const int lsteps = m / TC_KC;
  for (int q0 = 0; q0 < nc; q0 += LW) {
    float acc[2][LNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < LNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][n][i] = 0.f;

    __syncthreads();  // the slots are free
    for (int j = 0; j < RING - 1; ++j) {
      if (j < lsteps)
        issue_logit_weights(ws + j * WSLOT, outk, j * TC_KC, q0, out_ld);
      psa::cp_async_commit();
    }
    for (int k = 0; k < lsteps; ++k) {
      psa::cp_async_wait<RING - 2>();
      __syncthreads();
      const int j = k + RING - 1;
      if (j < lsteps)
        issue_logit_weights(ws + (j % RING) * WSLOT, outk, j * TC_KC, q0,
                            out_ld);
      psa::cp_async_commit();
      product<LNT>(acc, zs, z_ld, k * TC_KC, ws + (k % RING) * WSLOT, LW_LD,
                   wn * 8 * LNT, nc - q0, wm, lane);
    }

    // bias and one rounding on the fragments, into a [pixel][LW] tile in
    // the halo ring (free now), then out by rows of contiguous channels
#pragma unroll
    for (int n = 0; n < LNT; ++n) {
      const int col = wn * 8 * LNT + 8 * n + t2;
      if (q0 + col >= nc) continue;
      const float b0 = __bfloat162float(outb[q0 + col]);
      const float b1 =
          q0 + col + 1 < nc ? __bfloat162float(outb[q0 + col + 1]) : 0.f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = 32 * wm + 16 * mt + g;
        *reinterpret_cast<uint32_t*>(hs + p * LW_LD + col) =
            psa::pack(acc[mt][n][0] + b0, acc[mt][n][1] + b1);
        *reinterpret_cast<uint32_t*>(hs + (p + 8) * LW_LD + col) =
            psa::pack(acc[mt][n][2] + b0, acc[mt][n][3] + b1);
      }
    }
    __syncthreads();
    const int cols = min(LW, nc - q0);
    for (int e = tid; e < TP * cols; e += THREADS) {
      const int p = e / cols, col = e % cols;
      const int hh = th0 + p / TILE, ww = tw0 + p % TILE;
      if (hh < h && ww < w)
        ob[((size_t)hh * w + ww) * nc + q0 + col] = hs[p * LW_LD + col];
    }
  }
}

size_t smem_bytes(int m, int elem_size) {
  if (elem_size == 2) {
    if (m % 384 == 0) return tc_smem_bytes<12>(m);
    if (m % 256 == 0) return tc_smem_bytes<8>(m);
    return tc_smem_bytes<4>(m);
  }
  return (size_t)(XS_FLOATS + A_FLOATS + B_FLOATS + DW_FLOATS) * sizeof(float) +
         (size_t)m * TP * elem_size;
}

// cudaFuncSetAttribute once per device and kernel: the largest dynamic
// shared memory a block may take (each launch asks for what it needs)
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_OPT_IN = 232448;
bool smem_allowed[MAX_DEVICES][4];

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int which) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && smem_allowed[dev][which]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
  if (err == cudaSuccess && dev < MAX_DEVICES) smem_allowed[dev][which] = true;
  return err;
}

template <int NT>
int launch_tc(const void* x, const void* dwk, const void* dwb,
              const void* pwk, const void* pwb, const void* outk,
              const void* outb, void* out, int b, int h, int w, int c, int m,
              int nc, int out_ld, int project, cudaStream_t stream) {
  cudaError_t err = allow_smem(cls_stage_kernel_tc<NT>, NT / 4);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + TILE - 1) / TILE, tiles_h = (h + TILE - 1) / TILE;
  const dim3 grid(tiles_w * tiles_h, b);
  const size_t smem = tc_smem_bytes<NT>(m);
  cls_stage_kernel_tc<NT><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dwk),
      static_cast<const bf16*>(dwb), static_cast<const bf16*>(pwk),
      static_cast<const bf16*>(pwb), static_cast<const bf16*>(outk),
      static_cast<const bf16*>(outb), static_cast<bf16*>(out), h, w, c, m, nc,
      out_ld, tiles_w, project);
  return (int)cudaGetLastError();
}

int launch_fp32(const void* x, const void* dwk, const void* dwb,
                const void* pwk, const void* pwb, const void* outk,
                const void* outb, void* out, int b, int h, int w, int c,
                int m, int nc, int project, cudaStream_t stream) {
  cudaError_t err = allow_smem(cls_stage_kernel<float>, 0);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (w + TILE - 1) / TILE, tiles_h = (h + TILE - 1) / TILE;
  const dim3 grid(tiles_w * tiles_h, b);
  const size_t smem = smem_bytes(m, 4);
  cls_stage_kernel<float><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dwk),
      static_cast<const float*>(dwb), static_cast<const float*>(pwk),
      static_cast<const float*>(pwb), static_cast<const float*>(outk),
      static_cast<const float*>(outb), static_cast<float*>(out), h, w, c, m,
      nc, tiles_w, project);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// shared memory of one block for m middle channels
long long cls_stage_smem_bytes(int m, int elem_size) {
  return (long long)smem_bytes(m, elem_size);
}

// x (b, h, w, c) NHWC; dwk (9, c) tap-major; dwb (c); pwk (c, m); pwb (m);
// outk (m, nc) with rows of out_ld >= nc elements and outb (nc) read
// only when project != 0. out is
// (b, h, w, m), or (b, h, w, nc) when project != 0. c must be a multiple
// of 32 and m of 128. bf16: x, dwk, dwb, pwk, pwb and outk start on
// 16-byte boundaries, out_ld is a multiple of 8 (columns past nc zero);
// fp32: out_ld == nc. All arrays hold `elem_size`-byte elements (2: bf16, 4:
// fp32). Launches on the current device; returns cudaGetLastError() after
// the launch (0 on success).
int cls_stage(const void* x, const void* dwk, const void* dwb, const void* pwk,
              const void* pwb, const void* outk, const void* outb, void* out,
              int b, int h, int w, int c, int m, int nc, int out_ld,
              int project, int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % 32 || m % 128 || out_ld < nc) return (int)cudaErrorInvalidValue;
  if (elem_size != 2) {
    if (out_ld != nc) return (int)cudaErrorInvalidValue;
    return launch_fp32(x, dwk, dwb, pwk, pwb, outk, outb, out, b, h, w, c, m,
                       nc, project, s);
  }
  if (out_ld % 8) return (int)cudaErrorInvalidValue;
  if (m % 384 == 0)
    return launch_tc<12>(x, dwk, dwb, pwk, pwb, outk, outb, out, b, h, w, c,
                         m, nc, out_ld, project, s);
  if (m % 256 == 0)
    return launch_tc<8>(x, dwk, dwb, pwk, pwb, outk, outb, out, b, h, w, c, m,
                        nc, out_ld, project, s);
  return launch_tc<4>(x, dwk, dwb, pwk, pwb, outk, outb, out, b, h, w, c, m,
                      nc, out_ld, project, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
