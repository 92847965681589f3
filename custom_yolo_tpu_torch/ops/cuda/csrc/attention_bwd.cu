// PSA attention backward, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/attention_kernel.py::_attn_bwd_kernel
// (attention_kernel.py:90, called by _psa_attention_bwd_pallas, the VJP of
// psa_attention). From token-major qkv (B, T, nh·(2dk+dh)), per-head
// channels [q | k | v], and the cotangents dout and dv_pos (B, T, nh·dh) it
// writes dqkv, laid out as qkv. Per batch element and head, with the
// reference's rounding points:
//   s   = q kᵀ · scale                        fp32
//   p32 = softmax(s)                          fp32, recomputed from qkv
//   pb  = round(p32 → input type)
//   dv  = pbᵀ · do (fp32 sum) + float(dv_pos) → rounded once
//   dp  = do · vᵀ                             fp32
//   ds  = round(p32 ⊙ (dp − rowsum(dp ⊙ p32)) · scale → input type)
//   dq  = ds · k,  dk = dsᵀ · q               fp32 sums → rounded
//
// Bound on the H100: bytes. At the x shape (B=8, T=400, nh=6, dk=32,
// dh=64, bf16) the function reads qkv, dout and dv_pos and writes dqkv,
// 14.7 MB (4.4 µs at 3.35 TB/s), and does 3.4 GFLOP of products (3.5 µs at
// the bf16 tensor-core peak).
//
// dk and dv contract over the query axis, so a block that owns query rows
// cannot finish them: two kernels, no atomics, so results are the same
// from run to run. Both exist twice, for bf16 (tensor cores) and fp32.
//
// bf16: the earlier version worked in fp32 on the CUDA cores with every
// operand read from shared memory, kept a 32-row tile of fp32 scores and
// dp over all T keys in its dq kernel (166,016 B a block at T=400, one
// block an SM, T ≤ 573) and recomputed each score and dp entry of its dk/dv
// kernel as a scalar dot product. Now both kernels are four warps over 64
// rows (16 a warp), with their own rows' fragments in registers and the
// other side streamed in 64-row bf16 tiles through a double-buffered
// cp.async ring in shared memory (43 KB a block at dk=32, dh=64, whatever
// T is); every product is mma.sync.m16n8k16 (bf16 → fp32) from ldmatrix
// fragments, dk and dh zero-padded to 32/64/128. The softmax is formed as
// in the forward (base 2, one FMA, ex2.approx, times 1/l):
//  1. psa_attention_bwd_dq_tc — per 64 query rows, three passes over the
//     key tiles: (1) the row maximum m and sum l online, the forward's pass
//     1 (attention_tiles.cuh::softmax_stats_tile); (2) s → p32, dP = dO·Vᵀ,
//     delta += rowsum(dP ⊙ p32); (3) s → p32 and dP again,
//     ds = round(p32 ⊙ (dP − delta)·scale) straight into A fragments,
//     dq += ds·K. It writes dq and (m, 1/l, delta) per query row to an fp32
//     scratch.
//  2. psa_attention_bwd_dkv_tc — per 64 key rows, k and v fragments in
//     registers, one pass over the query tiles (q, do and the scratch
//     staged): Sᵀ = K·Qᵀ → p32, dPᵀ = V·dOᵀ → dsᵀ from delta, then
//     dv += round(p32)ᵀ·dO and dk += dsᵀ·Q on the tensor cores. dv adds
//     dv_pos and rounds once. Held to three blocks an SM up to dh = 64, so
//     that the x shape's 336 blocks run in one wave.
// ptxas (chip_smoke.py phase 2, H100) at dk=32, dh=64: dq 121 registers,
// dk/dv 168, no spills; at 64/128 dq 167, dk/dv 255, no spills (dk/dv at
// 64/64 spills 16 bytes under the three-block bound).
//
// fp32: TF32 tensor cores cannot meet the fp32 limit (1e-4), so fp32 keeps
// the CUDA-core kernels. psa_attention_bwd_dq_kernel takes 32 query rows
// and streams the keys in tiles of 64 through a fixed buffer
// (4·(32·(dk+dh) + 65·dk + 64·(dh+1) + 2·32·64) bytes, 54 KB at dk=32,
// dh=64), so any T runs, walking them three times as the bf16 dq kernel
// does: m and l online; delta = rowsum(dp ⊙ p32); ds and dq += ds·k.
// psa_attention_bwd_dkv_kernel walks the queries 64 at a time per 32-key
// tile, rebuilding p32 as exp(s − m)/l on scores summed in the same order
// as the dq kernel; its shared memory does not depend on T either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

// ------------------------------------------------------------ fp32 route

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int QCHUNK = 64;
constexpr int MAX_DK = 64;
constexpr int MAX_DH = 128;
constexpr int MAX_QK = ROWS * MAX_DK / THREADS;  // dq or dk sums per thread
constexpr int MAX_V = ROWS * MAX_DH / THREADS;   // dv sums per thread

constexpr int KEYS = 64;            // keys of a streamed tile (dq kernel)

__host__ __device__ constexpr int dq_smem_floats(int dk, int dh) {
  return ROWS * (dk + dh) + dk * (KEYS + 1) + KEYS * (dh + 1) +
         2 * ROWS * KEYS;
}

__host__ __device__ constexpr long long dkv_smem_floats(int dk, int dh) {
  return (long long)ROWS * (dk + 1) + (long long)ROWS * (dh + 1) +
         (long long)QCHUNK * (dk + dh + 3) + 2LL * QCHUNK * ROWS;
}

// keys j0..j0+n-1 of one head: kᵀ into kt ([dk][KEYS + 1]) and, when vs
// is given, v into vs ([KEYS][dh + 1])
__device__ __forceinline__ void stage_keys(const float* head, float* kt,
                                           float* vs, int j0, int n, int dk,
                                           int dh, int c_qkv) {
  for (int idx = threadIdx.x; idx < n * dk; idx += THREADS) {
    const int j = idx / dk, d = idx % dk;
    kt[d * (KEYS + 1) + j] = head[(size_t)(j0 + j) * c_qkv + dk + d];
  }
  if (vs == nullptr) return;
  for (int idx = threadIdx.x; idx < n * dh; idx += THREADS) {
    const int j = idx / dh, e = idx % dh;
    vs[j * (dh + 1) + e] = head[(size_t)(j0 + j) * c_qkv + 2 * dk + e];
  }
}

// s[r][j] = (q_r · k_j) · scale for the tile's n keys, summed over d in
// ascending order (the dk/dv kernel repeats exactly this sum)
__device__ __forceinline__ void score_tile(const float* qs, const float* kt,
                                           float* s, int rows, int n, int dk,
                                           float scale) {
  for (int idx = threadIdx.x; idx < rows * n; idx += THREADS) {
    const int r = idx / n, j = idx % n;
    const float* q = qs + r * dk;
    float acc = 0.f;
    for (int d = 0; d < dk; ++d) acc += q[d] * kt[d * (KEYS + 1) + j];
    s[r * KEYS + j] = acc * scale;
  }
}

// dp[r][j] = do_r · v_j for the tile's n keys
__device__ __forceinline__ void dp_tile(const float* dos, const float* vs,
                                        float* dp, int rows, int n, int dh) {
  for (int idx = threadIdx.x; idx < rows * n; idx += THREADS) {
    const int r = idx / n, j = idx % n;
    const float* g = dos + r * dh;
    const float* vv = vs + j * (dh + 1);
    float acc = 0.f;
    for (int e = 0; e < dh; ++e) acc += g[e] * vv[e];
    dp[r * KEYS + j] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
psa_attention_bwd_dq_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ dout,
                            float* __restrict__ dqkv,
                            float* __restrict__ stats, int seq, int nh, int dk,
                            int dh, float scale) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(ROWS, seq - r0);
  const int per_head = 2 * dk + dh;
  const int c_qkv = nh * per_head;
  const int c_out = nh * dh;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  float* qs = smem;                   // [ROWS][dk]
  float* dos = qs + ROWS * dk;        // [ROWS][dh]
  float* kt = dos + ROWS * dh;        // [dk][KEYS + 1]
  float* vs = kt + dk * (KEYS + 1);   // [KEYS][dh + 1]
  float* s = vs + KEYS * (dh + 1);    // [ROWS][KEYS]: scores, then p32
  float* dp = s + ROWS * KEYS;        // [ROWS][KEYS]: dp, then ds

  const float* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const float* do_head = dout + (size_t)b * seq * c_out + (size_t)h * dh;
  float* stat = stats + ((size_t)(b * nh + h) * seq + r0) * 3;

  for (int idx = tid; idx < rows * dk; idx += THREADS) {
    const int r = idx / dk, d = idx % dk;
    qs[idx] = head[(size_t)(r0 + r) * c_qkv + d];
  }
  for (int idx = tid; idx < rows * dh; idx += THREADS) {
    const int r = idx / dh, e = idx % dh;
    dos[idx] = do_head[(size_t)(r0 + r) * c_out + e];
  }

  // Three passes over key tiles of 64, each tile staged into the same
  // buffer; warp w keeps the statistics of rows w, w + 8, w + 16, w + 24.
  // (1) the row maximum m and sum l, online (the forward's pass 1)
  float m[ROWS / 8], l[ROWS / 8], delta[ROWS / 8];
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) m[i] = -INFINITY, l[i] = delta[i] = 0.f;
  for (int j0 = 0; j0 < seq; j0 += KEYS) {
    const int n = min(KEYS, seq - j0);
    __syncthreads();  // the previous tile is no longer read
    stage_keys(head, kt, nullptr, j0, n, dk, dh, c_qkv);
    __syncthreads();
    score_tile(qs, kt, s, rows, n, dk, scale);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS / 8; ++i) {
      const int r = warp + 8 * i;
      if (r >= rows) continue;
      const float* row = s + r * KEYS;
      float mx = -INFINITY;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
      for (int o = 16; o > 0; o /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) sum += expf(row[j] - m_new);
      for (int o = 16; o > 0; o /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  // (2) delta = rowsum(dp ⊙ p32), p32 = exp(s − m) / l; (3) ds = p32 ⊙
  // (dp − delta) · scale, dq += ds · k. dq[r][d] is owned by one thread.
  float acc[MAX_QK];
#pragma unroll
  for (int o = 0; o < MAX_QK; ++o) acc[o] = 0.f;
  for (int pass = 2; pass <= 3; ++pass) {
    for (int j0 = 0; j0 < seq; j0 += KEYS) {
      const int n = min(KEYS, seq - j0);
      __syncthreads();
      stage_keys(head, kt, vs, j0, n, dk, dh, c_qkv);
      __syncthreads();
      score_tile(qs, kt, s, rows, n, dk, scale);
      dp_tile(dos, vs, dp, rows, n, dh);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ROWS / 8; ++i) {
        const int r = warp + 8 * i;
        if (r >= rows) continue;
        const float* row = s + r * KEYS;
        float* g = dp + r * KEYS;
        if (pass == 2) {
          float part = 0.f;
          for (int j = lane; j < n; j += 32)
            part += g[j] * (expf(row[j] - m[i]) / l[i]);
          for (int o = 16; o > 0; o /= 2)
            part += __shfl_xor_sync(0xffffffffu, part, o);
          delta[i] += part;
        } else {
          for (int j = lane; j < n; j += 32) {
            const float p = expf(row[j] - m[i]) / l[i];
            g[j] = p * (g[j] - delta[i]) * scale;
          }
        }
      }
      if (pass == 2) continue;
      __syncthreads();
#pragma unroll
      for (int o = 0; o < MAX_QK; ++o) {
        const int idx = tid + o * THREADS;
        if (idx < rows * dk) {
          const int r = idx / dk, d = idx % dk;
          const float* g = dp + r * KEYS;
          const float* kk = kt + d * (KEYS + 1);
          float a = acc[o];
          for (int j = 0; j < n; ++j) a += g[j] * kk[j];
          acc[o] = a;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) {
    const int r = warp + 8 * i;
    if (r < rows && lane == 0) {
      stat[r * 3 + 0] = m[i];
      stat[r * 3 + 1] = l[i];
      stat[r * 3 + 2] = delta[i];
    }
  }
#pragma unroll
  for (int o = 0; o < MAX_QK; ++o) {
    const int idx = tid + o * THREADS;
    if (idx < rows * dk) {
      const int r = idx / dk, d = idx % dk;
      dqkv[((size_t)b * seq + r0 + r) * c_qkv + (size_t)h * per_head + d] =
          acc[o];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
psa_attention_bwd_dkv_kernel(const float* __restrict__ qkv,
                             const float* __restrict__ dout,
                             const float* __restrict__ dvpos,
                             float* __restrict__ dqkv,
                             const float* __restrict__ stats, int seq, int nh,
                             int dk, int dh, float scale) {
  extern __shared__ float smem[];
  const int j0 = blockIdx.x * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rows = min(ROWS, seq - j0);
  const int per_head = 2 * dk + dh;
  const int c_qkv = nh * per_head;
  const int c_out = nh * dh;
  const int tid = threadIdx.x;

  const int k_stride = dk + 1, v_stride = dh + 1;
  float* ks = smem;                     // [ROWS][dk + 1]
  float* vs = ks + ROWS * k_stride;     // [ROWS][dh + 1]
  float* qs = vs + ROWS * v_stride;     // [QCHUNK][dk]
  float* dos = qs + QCHUNK * dk;        // [QCHUNK][dh]
  float* st = dos + QCHUNK * dh;        // [QCHUNK][3]: m, l, delta
  float* pb = st + QCHUNK * 3;          // [QCHUNK][ROWS]: p32
  float* ds = pb + QCHUNK * ROWS;       // [QCHUNK][ROWS]

  const float* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const float* do_head = dout + (size_t)b * seq * c_out + (size_t)h * dh;
  const float* stat = stats + (size_t)(b * nh + h) * seq * 3;

  for (int idx = tid; idx < rows * dk; idx += THREADS) {
    const int jj = idx / dk, d = idx % dk;
    ks[jj * k_stride + d] = head[(size_t)(j0 + jj) * c_qkv + dk + d];
  }
  for (int idx = tid; idx < rows * dh; idx += THREADS) {
    const int jj = idx / dh, e = idx % dh;
    vs[jj * v_stride + e] = head[(size_t)(j0 + jj) * c_qkv + 2 * dk + e];
  }

  float acc_k[MAX_QK], acc_v[MAX_V];
#pragma unroll
  for (int m = 0; m < MAX_QK; ++m) acc_k[m] = 0.f;
#pragma unroll
  for (int m = 0; m < MAX_V; ++m) acc_v[m] = 0.f;

  for (int i0 = 0; i0 < seq; i0 += QCHUNK) {
    const int n = min(QCHUNK, seq - i0);
    __syncthreads();  // the previous chunk is no longer read
    for (int idx = tid; idx < n * dk; idx += THREADS) {
      const int ii = idx / dk, d = idx % dk;
      qs[idx] = head[(size_t)(i0 + ii) * c_qkv + d];
    }
    for (int idx = tid; idx < n * dh; idx += THREADS) {
      const int ii = idx / dh, e = idx % dh;
      dos[idx] = do_head[(size_t)(i0 + ii) * c_out + e];
    }
    for (int idx = tid; idx < n * 3; idx += THREADS)
      st[idx] = stat[(size_t)i0 * 3 + idx];
    __syncthreads();

    // the chunk's columns of p32 and ds for this tile's keys
    for (int idx = tid; idx < n * ROWS; idx += THREADS) {
      const int ii = idx / ROWS, jj = idx % ROWS;
      float p_val = 0.f, ds_val = 0.f;
      if (jj < rows) {
        const float* q = qs + ii * dk;
        const float* kk = ks + jj * k_stride;
        float acc = 0.f;
        for (int d = 0; d < dk; ++d) acc += q[d] * kk[d];
        // __fmul_rn: the score is rounded before m is taken off, as it
        // is where kernel 1 stores it
        const float p =
            expf(__fmul_rn(acc, scale) - st[ii * 3]) / st[ii * 3 + 1];
        const float* g = dos + ii * dh;
        const float* vv = vs + jj * v_stride;
        float dpv = 0.f;
        for (int e = 0; e < dh; ++e) dpv += g[e] * vv[e];
        p_val = p;
        ds_val = p * (dpv - st[ii * 3 + 2]) * scale;
      }
      pb[idx] = p_val;
      ds[idx] = ds_val;
    }
    __syncthreads();

    // dk[j][d] += Σ_i ds[i][j] · q[i][d];  dv[j][e] += Σ_i pb[i][j] · do[i][e]
#pragma unroll
    for (int m = 0; m < MAX_QK; ++m) {
      const int idx = tid + m * THREADS;
      if (idx < rows * dk) {
        const int jj = idx / dk, d = idx % dk;
        float a = acc_k[m];
        for (int ii = 0; ii < n; ++ii) a += ds[ii * ROWS + jj] * qs[ii * dk + d];
        acc_k[m] = a;
      }
    }
#pragma unroll
    for (int m = 0; m < MAX_V; ++m) {
      const int idx = tid + m * THREADS;
      if (idx < rows * dh) {
        const int jj = idx / dh, e = idx % dh;
        float a = acc_v[m];
        for (int ii = 0; ii < n; ++ii)
          a += pb[ii * ROWS + jj] * dos[ii * dh + e];
        acc_v[m] = a;
      }
    }
  }

  float* out = dqkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
#pragma unroll
  for (int m = 0; m < MAX_QK; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < rows * dk) {
      const int jj = idx / dk, d = idx % dk;
      out[(size_t)(j0 + jj) * c_qkv + dk + d] = acc_k[m];
    }
  }
  const float* dv_head = dvpos + (size_t)b * seq * c_out + (size_t)h * dh;
#pragma unroll
  for (int m = 0; m < MAX_V; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < rows * dh) {
      const int jj = idx / dh, e = idx % dh;
      out[(size_t)(j0 + jj) * c_qkv + 2 * dk + e] = (
          acc_v[m] + (dv_head[(size_t)(j0 + jj) * c_out + e]));
    }
  }
}

// ------------------------------------------------------------- bf16 route
using psa::bf16;
using psa::TILE;

template <int DKP, int DHP>
constexpr int dq_smem_bytes() {
  return (1 + psa::STAGES) * (psa::tile_bytes(DKP) + psa::tile_bytes(DHP));
}

template <int DKP, int DHP>
constexpr int dkv_smem_bytes() {
  return (1 + psa::STAGES) * (psa::tile_bytes(DKP) + psa::tile_bytes(DHP)) +
         psa::STAGES * TILE * 4 * (int)sizeof(float);
}

template <int DKP, int DHP>
__global__ void __launch_bounds__(psa::THREADS)
psa_attention_bwd_dq_tc(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ dout,
                        bf16* __restrict__ dqkv, float* __restrict__ stats,
                        int seq, int nh, int dk, int dh, float scale,
                        int aligned) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr int KB = TILE * (DKP + psa::PAD);
  constexpr int VB = TILE * (DHP + psa::PAD);
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [TILE][DKP + PAD]
  bf16* dos = qs + KB;                          // [TILE][DHP + PAD]
  bf16* ks = dos + VB;                          // STAGES k tiles
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
  const bf16* do_head = dout + (size_t)b * seq * c_out + (size_t)h * dh;

  // step s: pass s / tiles over key tile s % tiles, ring slot s % STAGES;
  // pass 0 stages k, passes 1 and 2 k and v
  const int steps = 3 * tiles;
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
  psa::load_tile<DHP>(dos, do_head, c_out, r0, seq, dh, aligned);
  for (int s = 0; s < psa::STAGES - 1; ++s) {
    stage(s);
    psa::cp_async_commit();
  }

  const float c_log2 = scale * 1.4426950408889634f;  // dk^-0.5 · log2(e)
  uint32_t qf[DKP / 16][4], dof[DHP / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float delta[2] = {0.f, 0.f};
  float dq[DKP / 8][4];
#pragma unroll
  for (int n = 0; n < DKP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[n][i] = 0.f;

  for (int s = 0; s < steps; ++s) {
    // step s's tiles have landed and every warp is done with step s − 1,
    // whose slot takes step s + STAGES − 1's tiles
    psa::cp_async_wait<psa::STAGES - 2>();
    __syncthreads();
    stage(s + psa::STAGES - 1);
    psa::cp_async_commit();
    if (s == 0) {
      psa::load_a<DKP>(qf, qs, 16 * warp, lane);
      psa::load_a<DHP>(dof, dos, 16 * warp, lane);
    }
    const int slot = s % psa::STAGES;
    const bf16* kt = ks + slot * KB;
    const int key0 = (s % tiles) * TILE;
    const int pass = s / tiles;
    if (pass == 0) {
      psa::softmax_stats_tile<DKP>(m, l, qf, kt, key0, seq, c_log2, lane);
    } else {
      if (s == tiles) {  // from here on l holds 1 / (row sum)
        l[0] = 1.f / psa::reduce_quad_sum(l[0]);
        l[1] = 1.f / psa::reduce_quad_sum(l[1]);
      } else if (s == 2 * tiles) {
        delta[0] = psa::reduce_quad_sum(delta[0]);
        delta[1] = psa::reduce_quad_sum(delta[1]);
      }
      const bf16* vt = vs + slot * VB;
      const bool last = key0 + TILE > seq;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float sc[2][4], dp[2][4];
        psa::products16<DKP>(sc, qf, kt, 16 * c, lane);
        psa::products16<DHP>(dp, dof, vt, 16 * c, lane);
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1;
            float p = psa::softmax_p(sc[n][i], c_log2, m[r], l[r]);
            if (last &&
                key0 + 16 * c + 8 * n + 2 * (lane & 3) + (i & 1) >= seq)
              p = 0.f;
            if (pass == 1)
              delta[r] += dp[n][i] * p;
            else
              sc[n][i] = p * (dp[n][i] - delta[r]) * scale;
          }
        if (pass == 2) {
          uint32_t da[4];
          psa::pack_a(da, sc[0], sc[1]);
          psa::accumulate16<DKP>(dq, da, kt, 16 * c, lane);
        }
      }
    }
  }

  const int g = lane >> 2, t2 = 2 * (lane & 3);
  bf16* out = dqkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 16 * warp + g + 8 * half;
    if (row >= seq) continue;
#pragma unroll
    for (int n = 0; n < DKP / 8; ++n) {
      const int col = 8 * n + t2;
      bf16* dst = out + (size_t)row * c_qkv + col;
      if (col < dk) dst[0] = __float2bfloat16_rn(dq[n][2 * half]);
      if (col + 1 < dk) dst[1] = __float2bfloat16_rn(dq[n][2 * half + 1]);
    }
    if ((lane & 3) == 0) {
      float* st = stats + ((size_t)(b * nh + h) * seq + row) * 3;
      st[0] = m[half];  // base-2 units
      st[1] = l[half];  // 1 / (row sum)
      st[2] = delta[half];
    }
  }
}

// three blocks an SM up to dh = 64 (at most 170 registers), so that the x
// shape's 336 blocks run in one wave
template <int DKP, int DHP>
__global__ void __launch_bounds__(psa::THREADS, DHP <= 64 ? 3 : 1)
psa_attention_bwd_dkv_tc(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ dout,
                         const bf16* __restrict__ dvpos,
                         bf16* __restrict__ dqkv,
                         const float* __restrict__ stats, int seq, int nh,
                         int dk, int dh, float scale, int aligned) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  constexpr int KB = TILE * (DKP + psa::PAD);
  constexpr int VB = TILE * (DHP + psa::PAD);
  constexpr int SB = TILE * 4;                   // floats of one stats tile
  bf16* kst = reinterpret_cast<bf16*>(smem_tc);  // this block's k rows
  bf16* vst = kst + KB;                          // this block's v rows
  bf16* qs = vst + VB;                           // STAGES q tiles
  bf16* dos = qs + psa::STAGES * KB;             // STAGES do tiles
  // STAGES [TILE][4] tiles of (m, 1/l, delta)
  float* sts = reinterpret_cast<float*>(dos + psa::STAGES * VB);

  const int j0 = blockIdx.x * TILE;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int per_head = 2 * dk + dh;
  const int c_qkv = nh * per_head;
  const int c_out = nh * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (seq + TILE - 1) / TILE;
  const bf16* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const bf16* do_head = dout + (size_t)b * seq * c_out + (size_t)h * dh;
  const float* stat = stats + (size_t)(b * nh + h) * seq * 3;
  const float c_log2 = scale * 1.4426950408889634f;  // dk^-0.5 · log2(e)

  // step s: query tile s (q, do and their rows' m, 1/l, delta), ring slot
  // s % STAGES
  auto stage = [&](int s) {
    if (s >= tiles) return;
    const int i0 = s * TILE, slot = s % psa::STAGES;
    psa::load_tile<DKP>(qs + slot * KB, head, c_qkv, i0, seq, dk, aligned);
    psa::load_tile<DHP>(dos + slot * VB, do_head, c_out, i0, seq, dh,
                        aligned);
    for (int i = threadIdx.x; i < TILE * 3; i += psa::THREADS) {
      const int r = i / 3, c = i % 3;
      const bool ok = i0 + r < seq;
      psa::cp_async4(sts + slot * SB + 4 * r + c,
                     ok ? stat + (size_t)(i0 + r) * 3 + c : stat, ok);
    }
  };
  psa::load_tile<DKP>(kst, head + dk, c_qkv, j0, seq, dk, aligned);
  psa::load_tile<DHP>(vst, head + 2 * dk, c_qkv, j0, seq, dh, aligned);
  for (int s = 0; s < psa::STAGES - 1; ++s) {
    stage(s);
    psa::cp_async_commit();
  }

  uint32_t kf[DKP / 16][4], vf[DHP / 16][4];
  float dka[DKP / 8][4], dva[DHP / 8][4];
#pragma unroll
  for (int n = 0; n < DKP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dva[n][i] = 0.f;

  for (int s = 0; s < tiles; ++s) {
    // step s's tiles have landed and every warp is done with step s − 1,
    // whose slot takes step s + STAGES − 1's tiles
    psa::cp_async_wait<psa::STAGES - 2>();
    __syncthreads();
    stage(s + psa::STAGES - 1);
    psa::cp_async_commit();
    if (s == 0) {
      psa::load_a<DKP>(kf, kst, 16 * warp, lane);
      psa::load_a<DHP>(vf, vst, 16 * warp, lane);
    }
    const int slot = s % psa::STAGES;
    const bf16* qt = qs + slot * KB;
    const bf16* dot = dos + slot * VB;
    const float* stt = sts + slot * SB;
    const int i0 = s * TILE;
    const bool last = i0 + TILE > seq;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // rows: this warp's keys; columns: queries 16c..16c+15 of the tile
      float st[2][4], dp[2][4];
      psa::products16<DKP>(st, kf, qt, 16 * c, lane);
      psa::products16<DHP>(dp, vf, dot, 16 * c, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = 16 * c + 8 * n + 2 * (lane & 3) + (i & 1);
          const float* row = stt + 4 * ql;  // m, 1/l, delta of query ql
          float p = psa::softmax_p(st[n][i], c_log2, row[0], row[1]);
          if (last && i0 + ql >= seq) p = 0.f;
          st[n][i] = p;
          dp[n][i] = p * (dp[n][i] - row[2]) * scale;
        }
      uint32_t pa[4], da[4];
      psa::pack_a(pa, st[0], st[1]);
      psa::pack_a(da, dp[0], dp[1]);
      psa::accumulate16<DHP>(dva, pa, dot, 16 * c, lane);
      psa::accumulate16<DKP>(dka, da, qt, 16 * c, lane);
    }
  }

  const int g = lane >> 2, t2 = 2 * (lane & 3);
  bf16* out = dqkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const bf16* dv_head = dvpos + (size_t)b * seq * c_out + (size_t)h * dh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = j0 + 16 * warp + g + 8 * half;
    if (key >= seq) continue;
    bf16* dst = out + (size_t)key * c_qkv;
#pragma unroll
    for (int n = 0; n < DKP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + t2 + e;
        if (col < dk)
          dst[dk + col] = __float2bfloat16_rn(dka[n][2 * half + e]);
      }
    const bf16* pos = dv_head + (size_t)key * c_out;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + t2 + e;
        if (col < dh)
          dst[2 * dk + col] = __float2bfloat16_rn(
              dva[n][2 * half + e] + __bfloat162float(pos[col]));
      }
  }
}

template <int DKP, int DHP>
int launch_tc(const void* qkv, const void* dout, const void* dv, void* dqkv,
              float* stats, int batch, int seq, int nh, int dk, int dh,
              float scale, cudaStream_t stream) {
  constexpr int smem_dq = dq_smem_bytes<DKP, DHP>();
  constexpr int smem_dkv = dkv_smem_bytes<DKP, DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_bwd_dq_tc<DKP, DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(psa_attention_bwd_dkv_tc<DKP, DHP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const int c_qkv = nh * (2 * dk + dh);
  const int aligned = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dout) % 16 == 0 &&
                      c_qkv % 8 == 0 && dk % 8 == 0 && dh % 8 == 0;
  const dim3 grid((seq + TILE - 1) / TILE, nh, batch);
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* g = static_cast<const bf16*>(dout);
  bf16* out = static_cast<bf16*>(dqkv);
  psa_attention_bwd_dq_tc<DKP, DHP><<<grid, psa::THREADS, smem_dq, stream>>>(
      q, g, out, stats, seq, nh, dk, dh, scale, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  psa_attention_bwd_dkv_tc<DKP, DHP>
      <<<grid, psa::THREADS, smem_dkv, stream>>>(
          q, g, static_cast<const bf16*>(dv), out, stats, seq, nh, dk, dh,
          scale, aligned);
  return (int)cudaGetLastError();
}

template <int DKP>
int launch_tc_dh(const void* qkv, const void* dout, const void* dv,
                 void* dqkv, float* stats, int batch, int seq, int nh, int dk,
                 int dh, float scale, cudaStream_t stream) {
  switch (psa::pad_dh(dh)) {
    case 32:
      return launch_tc<DKP, 32>(qkv, dout, dv, dqkv, stats, batch, seq, nh,
                                dk, dh, scale, stream);
    case 64:
      return launch_tc<DKP, 64>(qkv, dout, dv, dqkv, stats, batch, seq, nh,
                                dk, dh, scale, stream);
    default:
      return launch_tc<DKP, 128>(qkv, dout, dv, dqkv, stats, batch, seq, nh,
                                 dk, dh, scale, stream);
  }
}

int launch_fp32(const void* qkv, const void* dout, const void* dv, void* dqkv,
                float* stats, int batch, int seq, int nh, int dk, int dh,
                float scale, cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * dq_smem_floats(dk, dh);
  const size_t smem_dkv = sizeof(float) * dkv_smem_floats(dk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_bwd_dq_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(psa_attention_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + ROWS - 1) / ROWS, nh, batch);
  psa_attention_bwd_dq_kernel<<<grid, THREADS, smem_dq, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<float*>(dqkv), stats, seq, nh, dk, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  psa_attention_bwd_dkv_kernel<<<grid, THREADS, smem_dkv, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(dout),
      static_cast<const float*>(dv), static_cast<float*>(dqkv), stats, seq,
      nh, dk, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest key width (dk) and head width (dh) the kernels take.
int psa_attention_bwd_max_dk() { return MAX_DK; }
int psa_attention_bwd_max_dh() { return MAX_DH; }

// stats: fp32 scratch of batch·nh·seq·3 words (softmax row maximum, row
// sum, delta). is_bf16: 1 → bfloat16 tensors (tensor cores), 0 → float32
// (CUDA cores). Returns cudaGetLastError() after the launches (0 on
// success).
int psa_attention_bwd(const void* qkv, const void* dout, const void* dv,
                      void* dqkv, void* stats, int batch, int seq, int nh,
                      int dk, int dh, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk > MAX_DK || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(stats);
  if (!is_bf16)
    return launch_fp32(qkv, dout, dv, dqkv, st, batch, seq, nh, dk, dh, scale,
                       s);
  if (psa::pad_dk(dk) == 32)
    return launch_tc_dh<32>(qkv, dout, dv, dqkv, st, batch, seq, nh, dk, dh,
                            scale, s);
  return launch_tc_dh<64>(qkv, dout, dv, dqkv, st, batch, seq, nh, dk, dh,
                          scale, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
