// PSA attention forward, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/attention_kernel.py::_attn_kernel
// (attention_kernel.py:37, called by psa_attention_pallas). Computes, per
// batch element and head,
//   p   = softmax(q kᵀ · dk^-0.5)   scores and softmax in fp32,
//   out = p·v                        p rounded to the input type, fp32 sum,
// from token-major qkv (B, T, nh·(2dk+dh)) with the per-head channel layout
// [q(dk) | k(dk) | v(dh)], and writes out and a bit-exact copy of v, each
// (B, T, nh·dh). Rounding points are those of psa_attention_reference.
//
// Bound on the H100: bytes. At the x shape (B=8, T=400, nh=6, dk=32,
// dh=64, bf16) the function reads qkv once and writes out and v, 9.8 MB
// (2.9 µs at 3.35 TB/s), and does 1.5 GFLOP of products (1.5 µs at the
// bf16 tensor-core peak).
//
// bf16 (psa_attention_fwd_tc): the earlier version widened q, k and v to
// fp32 in shared memory and ran both products on the CUDA cores, two
// shared-memory loads per FMA; it kept a 32-row fp32 score tile over all T
// keys plus kᵀ in shared memory (106,624 B a block at T=400, two blocks an
// SM) and so refused T > 891. Now one block of four warps takes 64 query
// rows (16 a warp) of one (batch element, head); the q fragments stay in
// registers, and 64-key tiles of k and v, kept bf16, stream through a
// double-buffered cp.async ring in shared memory (33 KB a block at dk=32,
// dh=64, whatever T is, so any T runs and up to five blocks share an SM).
// Both products are mma.sync.m16n8k16 (bf16 → fp32) from ldmatrix
// fragments, dk and dh zero-padded to 32/64/128. Two passes over the key
// tiles keep the reference's rounding point: pass 1 takes each row's
// maximum m and sum l online across tiles (attention_tiles.cuh::
// softmax_stats_tile, shared with the backward); pass 2 recomputes the
// scores, forms p = exp(s − m)/l in fp32 (base 2: one FMA, ex2.approx and a
// multiply by 1/l), rounds it to bf16 straight into the A fragments of P·V
// (no shared-memory trip) and sums out in fp32, rounded once. v is copied by
// 16-byte vectors where rows are aligned, element by element otherwise;
// unaligned rows (c_qkv, dk or dh not a multiple of 8) are staged element
// by element, synchronously. Grid ⌈T/64⌉ × nh × B: 336 blocks at B=8; at
// B=1 the 42 blocks leave most of the 132 SMs idle and the call costs one
// block's latency, which is left as it is. What a block waits on is spread
// over its 14 tile steps at T=400 (issuing the copies, the second pass,
// the products, the softmax, the barrier), not one of them: PERF.md.
// ptxas (chip_smoke.py phase 2, H100): 94 registers at dk=32, dh=64, 166
// at 64/128, no spills.
//
// fp32 (psa_attention_fwd_kernel): TF32 tensor cores cannot meet the fp32
// limit (1e-5), so fp32 keeps the CUDA-core kernel: one block takes 32
// query rows and keeps their fp32 score rows over all T keys, the q tile
// and kᵀ in shared memory, 4·(32·dk + dk·(T+1) + 32·T) bytes, so the
// wrapper refuses a T for which that exceeds 232,448 bytes (fp32 only).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

// ------------------------------------------------------------ fp32 route

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int MAX_DH = 128;
constexpr int MAX_OUT = ROWS * MAX_DH / THREADS;

__host__ __device__ constexpr long long smem_floats(int seq, int dk) {
  return (long long)ROWS * dk + (long long)dk * (seq + 1) +
         (long long)ROWS * seq;
}

__global__ void __launch_bounds__(THREADS)
psa_attention_fwd_kernel(const float* __restrict__ qkv,
                         float* __restrict__ out, float* __restrict__ vout,
                         int seq, int nh, int dk, int dh, float scale) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(ROWS, seq - r0);
  const int per_head = 2 * dk + dh;
  const int c_qkv = nh * per_head;
  const int c_out = nh * dh;
  const int tid = threadIdx.x;

  const int kt_stride = seq + 1;
  float* qs = smem;                   // [ROWS][dk]
  float* kt = qs + ROWS * dk;         // [dk][seq + 1], later v chunks
  float* s = kt + dk * kt_stride;     // [ROWS][seq]

  const float* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;

  for (int idx = tid; idx < rows * dk; idx += THREADS) {
    const int r = idx / dk, d = idx % dk;
    qs[r * dk + d] = head[(size_t)(r0 + r) * c_qkv + d];
  }
  for (int idx = tid; idx < seq * dk; idx += THREADS) {
    const int j = idx / dk, d = idx % dk;
    kt[d * kt_stride + j] = head[(size_t)j * c_qkv + dk + d];
  }
  __syncthreads();

  // scores: s[r][j] = (q_r · k_j) · scale, fp32
  for (int idx = tid; idx < rows * seq; idx += THREADS) {
    const int r = idx / seq, j = idx % seq;
    const float* q = qs + r * dk;
    float acc = 0.f;
    for (int d = 0; d < dk; ++d) acc += q[d] * kt[d * kt_stride + j];
    s[r * seq + j] = acc * scale;
  }
  __syncthreads();

  // softmax over keys, one warp per row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* row = s + r * seq;
    float m = -INFINITY;
    for (int j = lane; j < seq; j += 32) m = fmaxf(m, row[j]);
    for (int o = 16; o > 0; o /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < seq; j += 32) row[j] = row[j] / sum;
  }
  __syncthreads();

  // out[r][e] = Σ_j p[r][j] · v[j][e], summed in fp32 in token order; v
  // is staged through the kᵀ region, `chunk` tokens at a time
  const float* v = head + 2 * dk;
  float* vs = kt;
  const int chunk = dk * kt_stride / dh;
  float acc[MAX_OUT];
#pragma unroll
  for (int m = 0; m < MAX_OUT; ++m) acc[m] = 0.f;
  for (int j0 = 0; j0 < seq; j0 += chunk) {
    const int n = min(chunk, seq - j0);
    __syncthreads();  // the previous chunk (or kᵀ) is no longer read
    for (int idx = tid; idx < n * dh; idx += THREADS) {
      const int jj = idx / dh, e = idx % dh;
      vs[jj * dh + e] = v[(size_t)(j0 + jj) * c_qkv + e];
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MAX_OUT; ++m) {
      const int idx = tid + m * THREADS;
      if (idx < rows * dh) {
        const int r = idx / dh, e = idx % dh;
        const float* p = s + r * seq + j0;
        float a = acc[m];
        for (int jj = 0; jj < n; ++jj) a += p[jj] * vs[jj * dh + e];
        acc[m] = a;
      }
    }
  }

  // write out and the bit-exact copy of v
#pragma unroll
  for (int m = 0; m < MAX_OUT; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < rows * dh) {
      const int r = idx / dh, e = idx % dh;
      const size_t o = ((size_t)b * seq + r0 + r) * c_out + (size_t)h * dh + e;
      out[o] = acc[m];
      vout[o] = v[(size_t)(r0 + r) * c_qkv + e];
    }
  }
}

// ------------------------------------------------------------- bf16 route
using psa::bf16;
using psa::TILE;

template <int DKP, int DHP>
constexpr int tc_smem_bytes() {
  return psa::tile_bytes(DKP) * (1 + psa::STAGES) +
         psa::tile_bytes(DHP) * psa::STAGES;
}

// the bit-exact copy of v for rows r0..r0+TILE-1 of one head
__device__ __forceinline__ void copy_v(const bf16* v, bf16* vout, int r0,
                                       int seq, int dh, int c_qkv, int c_out,
                                       bool vec) {
  const int rows = min(TILE, seq - r0);
  if (vec) {
    const int chunks = dh / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += psa::THREADS) {
      const int r = i / chunks, c = (i % chunks) * 8;
      *reinterpret_cast<uint4*>(vout + (size_t)(r0 + r) * c_out + c) =
          *reinterpret_cast<const uint4*>(v + (size_t)(r0 + r) * c_qkv + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dh; i += psa::THREADS) {
      const int r = i / dh, e = i % dh;
      vout[(size_t)(r0 + r) * c_out + e] = v[(size_t)(r0 + r) * c_qkv + e];
    }
  }
}

template <int DKP, int DHP>
__global__ void __launch_bounds__(psa::THREADS)
psa_attention_fwd_tc(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     bf16* __restrict__ vout, int seq, int nh, int dk, int dh,
                     float scale, int aligned, int vec_v) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr int KB = TILE * (DKP + psa::PAD);   // elements of one k tile
  constexpr int VB = TILE * (DHP + psa::PAD);   // of one v tile
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [TILE][DKP + PAD]
  bf16* ks = qs + KB;                           // STAGES k tiles
  bf16* vs = ks + psa::STAGES * KB;             // STAGES v tiles

  const int r0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int per_head = 2 * dk + dh;
  const int c_qkv = nh * per_head;
  const int c_out = nh * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (seq + TILE - 1) / TILE;
  const bf16* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;

  // step s < tiles: pass 1 over key tile s (k only); s ≥ tiles: pass 2
  // over key tile s − tiles (k and v); ring slot s % STAGES
  const int steps = 2 * tiles;
  auto stage = [&](int s) {
    if (s >= steps) return;
    const int key0 = (s % tiles) * TILE, slot = s % psa::STAGES;
    psa::load_tile<DKP>(ks + slot * KB, head + dk, c_qkv, key0, seq, dk,
                        aligned);
    if (s >= tiles)
      psa::load_tile<DHP>(vs + slot * VB, head + 2 * dk, c_qkv, key0, seq,
                          dh, aligned);
  };
  psa::load_tile<DKP>(qs, head, c_qkv, r0, seq, dk, aligned);
  for (int s = 0; s < psa::STAGES - 1; ++s) {
    stage(s);
    psa::cp_async_commit();
  }
  copy_v(head + 2 * dk, vout + (size_t)b * seq * c_out + (size_t)h * dh, r0,
         seq, dh, c_qkv, c_out, vec_v);

  const float c_log2 = scale * 1.4426950408889634f;  // dk^-0.5 · log2(e)
  uint32_t qf[DKP / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DHP / 8][4];
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    // step s's tiles have landed and every warp is done with step s − 1,
    // whose slot takes step s + STAGES − 1's tiles
    psa::cp_async_wait<psa::STAGES - 2>();
    __syncthreads();
    stage(s + psa::STAGES - 1);
    psa::cp_async_commit();
    if (s == 0) psa::load_a<DKP>(qf, qs, 16 * warp, lane);
    const int slot = s % psa::STAGES;
    const bf16* kt = ks + slot * KB;
    const int key0 = (s % tiles) * TILE;
    if (s < tiles) {
      psa::softmax_stats_tile<DKP>(m, l, qf, kt, key0, seq, c_log2, lane);
    } else {
      if (s == tiles) {  // from here on l holds 1 / (row sum)
        l[0] = 1.f / psa::reduce_quad_sum(l[0]);
        l[1] = 1.f / psa::reduce_quad_sum(l[1]);
      }
      const bf16* vt = vs + slot * VB;
      const bool last = key0 + TILE > seq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sc[2][4];
        psa::products16<DKP>(sc, qf, kt, 16 * c, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sc[n][i] = psa::softmax_p(sc[n][i], c_log2, m[i >> 1], l[i >> 1]);
            if (last &&
                key0 + 16 * c + 8 * n + 2 * (lane & 3) + (i & 1) >= seq)
              sc[n][i] = 0.f;
          }
        uint32_t pa[4];
        psa::pack_a(pa, sc[0], sc[1]);
        psa::accumulate16<DHP>(acc, pa, vt, 16 * c, lane);
      }
    }
  }

  // out, rounded once
  bf16* o = out + (size_t)b * seq * c_out + (size_t)h * dh;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + 16 * warp + g + 8 * half;
      const int col = 8 * n + t2;
      if (row >= seq) continue;
      bf16* dst = o + (size_t)row * c_out + col;
      if (col < dh) dst[0] = __float2bfloat16_rn(acc[n][2 * half]);
      if (col + 1 < dh) dst[1] = __float2bfloat16_rn(acc[n][2 * half + 1]);
    }
}

template <int DKP, int DHP>
int launch_tc(const void* qkv, void* out, void* v, int batch, int seq, int nh,
              int dk, int dh, float scale, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<DKP, DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_fwd_tc<DKP, DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int c_qkv = nh * (2 * dk + dh), c_out = nh * dh;
  const bool rows16 = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                      c_qkv % 8 == 0 && dk % 8 == 0 && dh % 8 == 0;
  const bool vec_v = rows16 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                     c_out % 8 == 0;
  const dim3 grid((seq + TILE - 1) / TILE, nh, batch);
  psa_attention_fwd_tc<DKP, DHP><<<grid, psa::THREADS, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<bf16*>(v), seq, nh, dk, dh, scale, (int)rows16,
      (int)vec_v);
  return (int)cudaGetLastError();
}

template <int DKP>
int launch_tc_dh(const void* qkv, void* out, void* v, int batch, int seq,
                 int nh, int dk, int dh, float scale, cudaStream_t stream) {
  switch (psa::pad_dh(dh)) {
    case 32:
      return launch_tc<DKP, 32>(qkv, out, v, batch, seq, nh, dk, dh, scale,
                                stream);
    case 64:
      return launch_tc<DKP, 64>(qkv, out, v, batch, seq, nh, dk, dh, scale,
                                stream);
    default:
      return launch_tc<DKP, 128>(qkv, out, v, batch, seq, nh, dk, dh, scale,
                                 stream);
  }
}

int launch_fp32(const void* qkv, void* out, void* v, int batch, int seq,
                int nh, int dk, int dh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(seq, dk);
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + ROWS - 1) / ROWS, nh, batch);
  psa_attention_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out),
      static_cast<float*>(v), seq, nh, dk, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block of the fp32 kernel needs for `seq` tokens (the
// bf16 kernel's does not depend on seq).
long long psa_attention_smem_bytes(int seq, int dk) {
  return (long long)sizeof(float) * smem_floats(seq, dk);
}

// Largest key width (dk, bf16 route) and head width (dh) the kernels take.
int psa_attention_max_dk() { return psa::MAX_DK; }
int psa_attention_max_dh() { return MAX_DH; }

// is_bf16: 1 → bfloat16 tensors (tensor cores), 0 → float32 (CUDA cores).
// Returns cudaGetLastError() after the launch (0 on success).
int psa_attention_fwd(const void* qkv, void* out, void* v, int batch, int seq,
                      int nh, int dk, int dh, float scale, int is_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return launch_fp32(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
  if (psa::pad_dk(dk) == 32)
    return launch_tc_dh<32>(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
  return launch_tc_dh<64>(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
