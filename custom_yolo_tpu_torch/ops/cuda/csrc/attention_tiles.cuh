// Tensor-core building blocks shared by the bf16 PSA attention kernels
// (attention.cu, forward; attention_bwd.cu, backward), for sm_90a.
//
// Products are mma.sync.m16n8k16 with bf16 operands and fp32 accumulators.
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A 16x16 : a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//             a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B 16x8  : b0 (rows 2t, 2t+1, col g), b1 (rows 2t+8, 2t+9, col g)
//   C 16x8  : c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// so the accumulators of two neighbouring 16x8 products (16 columns) are,
// once rounded to bf16 in pairs, the A operand of a product that contracts
// over those 16 columns (pack_a below): probabilities go from Q·Kᵀ into
// P·V without a trip through shared memory.
//
// Tiles live in shared memory as bf16 rows of W + PAD elements (W a
// multiple of 16); the 16-byte pad puts the eight rows an ldmatrix reads on
// eight different groups of four banks. Columns past the operand's width
// and rows past the sequence are zero, and zeros add exactly 0 to every
// product.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace psa {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;          // query rows of a block, keys of a tile
constexpr int THREADS = 128;      // four warps of 16 rows each
constexpr int PAD = 8;            // bf16 elements after each row in smem
// depth of the ring the streamed tiles pass through: a tile is requested
// STAGES − 1 steps before it is used (a ring of four gave the same times
// on the H100: the loads are not what a step waits for)
constexpr int STAGES = 2;

// the padded widths the kernels are instantiated for
__host__ __device__ constexpr int pad_dk(int dk) { return dk <= 32 ? 32 : 64; }
__host__ __device__ constexpr int pad_dh(int dh) {
  return dh <= 32 ? 32 : dh <= 64 ? 64 : 128;
}
constexpr int MAX_DK = 64;
constexpr int MAX_DH = 128;

// bytes of one TILE-row bf16 tile of padded width w in shared memory
__host__ __device__ constexpr int tile_bytes(int w) {
  return TILE * (w + PAD) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a · b, one m16n8k16 product
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A operand (16 rows x 16 contracted columns) from the accumulators of
// the two 16x8 products over those columns, rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// Address a lane gives ldmatrix for the 16x16 block at (row0, col0) of a
// tile with row stride ld: as an A operand (x4, not transposed) and as two
// B operands contracting over the tile's rows (x4.trans) alike.
__device__ __forceinline__ const bf16* frag_a_addr(const bf16* tile, int ld,
                                                   int row0, int col0,
                                                   int lane) {
  return tile + (row0 + (lane & 15)) * ld + col0 + ((lane >> 4) << 3);
}

// Address for two B operands contracting over the tile's columns (x4, not
// transposed): rows row0..row0+7 give registers 0-1, rows row0+8..+15
// registers 2-3, each (cols col0..+7, col0+8..+15).
__device__ __forceinline__ const bf16* frag_b_addr(const bf16* tile, int ld,
                                                   int row0, int col0,
                                                   int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 +
         (((lane >> 3) & 1) << 3);
}

// 16-byte asynchronous copy; with valid == false the 16 bytes are zeroed
// and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte asynchronous copy, zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows row0..row0+TILE-1, columns 0..width-1 of a bf16 matrix with
// row stride ld (src points at column 0 of row 0) into a [TILE][W + PAD]
// tile, zeros past `rows` and past `width`. aligned: src, ld and width
// allow 16-byte copies (then asynchronous, to be committed by the caller);
// otherwise element by element, synchronously.
template <int W>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld,
                                          int row0, int rows, int width,
                                          bool aligned) {
  constexpr int LD = W + PAD;
  if (aligned) {
    // each thread copies one 16-byte column chunk of every STEP-th row;
    // issuing the copies is a third of a step's time at the x shape, so
    // their addresses are strided pointers, not recomputed per copy
    constexpr int CHUNKS = W / 8;
    constexpr int STEP = THREADS / CHUNKS;
    const int r = threadIdx.x / CHUNKS, c = (threadIdx.x % CHUNKS) * 8;
    const bf16* from = src + (size_t)(row0 + r) * ld + c;
    bf16* to = dst + r * LD + c;
    const int valid_rows = c < width ? rows - row0 - r : 0;
#pragma unroll
    for (int k = 0; k < TILE / STEP; ++k) {
      const bool ok = k * STEP < valid_rows;
      cp_async16(to + k * STEP * LD, ok ? from : src, ok);
      from += (size_t)STEP * ld;
    }
  } else {
    for (int i = threadIdx.x; i < TILE * W; i += THREADS) {
      const int r = i / W, c = i % W;
      dst[r * LD + c] = row0 + r < rows && c < width
                            ? src[(size_t)(row0 + r) * ld + c]
                            : __float2bfloat16_rn(0.f);
    }
  }
}

// The A fragments of a warp's 16 rows (row0..row0+15) of a staged tile,
// over all W columns.
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[W / 16][4],
                                       const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk)
    ldsm_x4(a[kk], frag_a_addr(tile, W + PAD, row0, 16 * kk, lane));
}

// Raw products of 16 rows (A fragments `a`, contracted over W columns)
// with rows r0..r0+15 of a staged [TILE][W + PAD] tile: c[0] for rows
// r0..r0+7 of the tile, c[1] for r0+8..r0+15. Each accumulator sums its
// 16-column blocks in ascending order, so every caller gets the same bits.
template <int W>
__device__ __forceinline__ void products16(float (&c)[2][4],
                                           const uint32_t (&a)[W / 16][4],
                                           const bf16* tile, int r0,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) c[0][i] = c[1][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, frag_b_addr(tile, W + PAD, r0, 16 * kk, lane));
    mma(c[0], a[kk], b[0], b[1]);
    mma(c[1], a[kk], b[2], b[3]);
  }
}

// acc[n] += a · tile[r0..r0+15][8n..8n+7] for every 8-column block n of a
// staged [TILE][W + PAD] tile: a (16 rows x 16) contracts over the tile's
// rows r0..r0+15.
template <int W>
__device__ __forceinline__ void accumulate16(float (&acc)[W / 8][4],
                                             const uint32_t (&a)[4],
                                             const bf16* tile, int r0,
                                             int lane) {
#pragma unroll
  for (int n = 0; n < W / 16; ++n) {
    uint32_t b[4];
    ldsm_x4_t(b, frag_a_addr(tile, W + PAD, r0, 16 * n, lane));
    mma(acc[2 * n], a, b[0], b[1]);
    mma(acc[2 * n + 1], a, b[2], b[3]);
  }
}

// The softmax works in base 2, on raw scores (q·k before the scale): with
// c = dk^-0.5 · log2(e) and m the row maximum of raw·c, exp(s − m) is
// 2^(raw·c − m), one FMA and one ex2.approx (2 ulp) on the special-function
// unit. Every pass and both kernels of the backward form it with the same
// FMA, so they get the same bits; the row maximum is taken on raw scores
// (c > 0) and scaled once.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the softmax probability of a raw score, given its row's m and 1/l
__device__ __forceinline__ float softmax_p(float raw, float c, float m,
                                           float inv_l) {
  return exp2_approx(__fmaf_rn(raw, c, -m)) * inv_l;
}

// Pass 1 over one key tile: the running row maximum m (of raw·c) and row
// sum l of 2^(raw·c − m) for the warp's rows g (index 0) and g + 8 (index
// 1), keys at or past `seq` left out. q holds the rows' A fragments over
// DKP columns, kt the staged key tile whose first key is key0. m is the
// same in the four lanes of a row; l is this lane's share (reduce_quad_sum
// finishes it).
template <int DKP>
__device__ __forceinline__ void softmax_stats_tile(
    float (&m)[2], float (&l)[2], const uint32_t (&q)[DKP / 16][4],
    const bf16* kt, int key0, int seq, float c_log2, int lane) {
  float s[8][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float pair[2][4];
    products16<DKP>(pair, q, kt, 16 * c, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[2 * c][i] = pair[0][i];
      s[2 * c + 1][i] = pair[1][i];
    }
  }
  if (key0 + TILE > seq) {  // the last tile: keys past the sequence
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (key0 + 8 * n + 2 * (lane & 3) + (i & 1) >= seq)
          s[n][i] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i >> 1] = fmaxf(mx[i >> 1], s[n][i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], __fmul_rn(mx[r], c_log2));
    l[r] *= exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      l[i >> 1] += softmax_p(s[n][i], c_log2, m[i >> 1], 1.f);
}

// sum over the four lanes that share a row
__device__ __forceinline__ float reduce_quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

}  // namespace psa
