// PSA attention backward, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/attention_kernel.py::_attn_bwd_kernel
// (called by _psa_attention_bwd_pallas, the VJP of psa_attention). From
// token-major qkv (B, T, nh·(2dk+dh)), per-head channels [q | k | v], and
// the cotangents dout and dv_pos (B, T, nh·dh) it writes dqkv, laid out as
// qkv. Per batch element and head, with the reference's rounding points:
//   s   = q kᵀ · scale                        fp32
//   p32 = softmax(s)                          fp32, recomputed from qkv
//   pb  = round(p32 → input type)
//   dv  = pbᵀ · do (fp32 sum) + float(dv_pos) → rounded once
//   dp  = do · vᵀ                             fp32
//   ds  = round(p32 ⊙ (dp − rowsum(dp ⊙ p32)) · scale → input type)
//   dq  = ds · k,  dk = dsᵀ · q               fp32 sums → rounded
//
// Bound on the H100: at the flagship shape (B=8, T=400, nh=6, dk=32,
// dh=64, bf16) the function moves ~14.7 MB (≈4.4 µs at 3.35 TB/s) and does
// ~3.4 GFLOP (≈3.5 µs at the bf16 tensor-core peak): bytes bound it. This
// version is far from that: fp32 on the CUDA cores, every product reads
// both operands from shared memory, and the scores are computed twice.
//
// Design: the Pallas kernel holds one batch element whole in VMEM. Here
// one head's T×T fp32 matrix (640 KB at T=400) does not fit in a block's
// 227 KB, and dk and dv contract over the *query* axis, so a block that
// owns query rows cannot finish them. Two kernels, no atomics, so results
// are the same from run to run:
//  1. psa_attention_bwd_dq_kernel — one block per (tile of ROWS query
//     rows, head, batch element). It keeps the tile's fp32 score rows and
//     dp rows over all T keys in shared memory, finishes the softmax,
//     streams v through the kᵀ region to form dp, reduces
//     delta = rowsum(dp ⊙ p32), forms ds in place, reloads kᵀ and writes
//     dq. It also writes three fp32 numbers per (b, h, query row) to a
//     scratch tensor: the softmax row maximum m, the row sum l, and delta.
//     Shared memory = 4·(ROWS·(dk+dh) + dk·(T+1) + 2·ROWS·T) bytes; the
//     wrapper refuses a T for which that exceeds the card's 232,448 bytes.
//  2. psa_attention_bwd_dkv_kernel — one block per (tile of ROWS key rows,
//     head, batch element). It walks the queries QCHUNK at a time, rebuilds
//     the needed columns of p32 as exp(s − m)/l (the same expression, on
//     scores summed in the same order, as kernel 1) and of ds from delta,
//     and sums dk and dv in registers in query order. Tiles of k and v are
//     padded by one word per row so that threads on neighbouring keys hit
//     different banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int QCHUNK = 64;
constexpr int MAX_DK = 64;
constexpr int MAX_DH = 128;
constexpr int MAX_QK = ROWS * MAX_DK / THREADS;  // dq or dk sums per thread
constexpr int MAX_V = ROWS * MAX_DH / THREADS;   // dv sums per thread

__host__ __device__ constexpr long long dq_smem_floats(int seq, int dk,
                                                       int dh) {
  return (long long)ROWS * (dk + dh) + (long long)dk * (seq + 1) +
         2LL * ROWS * seq;
}

__host__ __device__ constexpr long long dkv_smem_floats(int dk, int dh) {
  return (long long)ROWS * (dk + 1) + (long long)ROWS * (dh + 1) +
         (long long)QCHUNK * (dk + dh + 3) + 2LL * QCHUNK * ROWS;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened again
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
psa_attention_bwd_dq_kernel(const T* __restrict__ qkv,
                            const T* __restrict__ dout, T* __restrict__ dqkv,
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

  const int kt_stride = seq + 1;
  float* qs = smem;                 // [ROWS][dk]
  float* dos = qs + ROWS * dk;      // [ROWS][dh]
  float* kt = dos + ROWS * dh;      // [dk][seq + 1]; v chunks in between
  float* s = kt + dk * kt_stride;   // [ROWS][seq]: scores, then p32
  float* dp = s + ROWS * seq;       // [ROWS][seq]: dp, then ds

  const T* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const T* do_head = dout + (size_t)b * seq * c_out + (size_t)h * dh;
  float* stat = stats + ((size_t)(b * nh + h) * seq + r0) * 3;

  for (int idx = tid; idx < rows * dk; idx += THREADS) {
    const int r = idx / dk, d = idx % dk;
    qs[idx] = to_float(head[(size_t)(r0 + r) * c_qkv + d]);
  }
  for (int idx = tid; idx < rows * dh; idx += THREADS) {
    const int r = idx / dh, e = idx % dh;
    dos[idx] = to_float(do_head[(size_t)(r0 + r) * c_out + e]);
  }
  for (int idx = tid; idx < seq * dk; idx += THREADS) {
    const int j = idx / dk, d = idx % dk;
    kt[d * kt_stride + j] = to_float(head[(size_t)j * c_qkv + dk + d]);
  }
  __syncthreads();

  // s[r][j] = (q_r · k_j) · scale, summed over d in ascending order (the
  // dk/dv kernel repeats exactly this sum)
  for (int idx = tid; idx < rows * seq; idx += THREADS) {
    const int r = idx / seq, j = idx % seq;
    const float* q = qs + r * dk;
    float acc = 0.f;
    for (int d = 0; d < dk; ++d) acc += q[d] * kt[d * kt_stride + j];
    s[r * seq + j] = acc * scale;
  }
  __syncthreads();

  // p32 = exp(s − m) / l, one warp per row; m and l go to the scratch
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
    if (lane == 0) {
      stat[r * 3 + 0] = m;
      stat[r * 3 + 1] = sum;
    }
  }

  // dp[r][j] = do_r · v_j; v is staged through the kᵀ region, `chunk`
  // tokens at a time, rows padded to dh + 1 words
  const T* v = head + 2 * dk;
  float* vs = kt;
  const int v_stride = dh + 1;
  const int chunk = dk * kt_stride / v_stride;
  for (int j0 = 0; j0 < seq; j0 += chunk) {
    const int n = min(chunk, seq - j0);
    __syncthreads();  // kᵀ, or the previous chunk, is no longer read
    for (int idx = tid; idx < n * dh; idx += THREADS) {
      const int jj = idx / dh, e = idx % dh;
      vs[jj * v_stride + e] = to_float(v[(size_t)(j0 + jj) * c_qkv + e]);
    }
    __syncthreads();
    for (int idx = tid; idx < rows * n; idx += THREADS) {
      const int r = idx / n, jj = idx % n;
      const float* g = dos + r * dh;
      const float* vv = vs + jj * v_stride;
      float acc = 0.f;
      for (int e = 0; e < dh; ++e) acc += g[e] * vv[e];
      dp[r * seq + j0 + jj] = acc;
    }
  }
  __syncthreads();

  // delta = rowsum(dp ⊙ p32); ds = round(p32 ⊙ (dp − delta) · scale) in
  // place of dp; then kᵀ comes back into the region the v chunks used
  for (int r = warp; r < rows; r += THREADS / 32) {
    const float* p = s + r * seq;
    float* g = dp + r * seq;
    float delta = 0.f;
    for (int j = lane; j < seq; j += 32) delta += g[j] * p[j];
    for (int o = 16; o > 0; o /= 2)
      delta += __shfl_xor_sync(0xffffffffu, delta, o);
    for (int j = lane; j < seq; j += 32)
      g[j] = round_to<T>(p[j] * (g[j] - delta) * scale);
    if (lane == 0) stat[r * 3 + 2] = delta;
  }
  for (int idx = tid; idx < seq * dk; idx += THREADS) {
    const int j = idx / dk, d = idx % dk;
    kt[d * kt_stride + j] = to_float(head[(size_t)j * c_qkv + dk + d]);
  }
  __syncthreads();

  // dq[r][d] = Σ_j ds[r][j] · k[j][d]
#pragma unroll
  for (int m = 0; m < MAX_QK; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < rows * dk) {
      const int r = idx / dk, d = idx % dk;
      const float* g = dp + r * seq;
      const float* kk = kt + d * kt_stride;
      float acc = 0.f;
      for (int j = 0; j < seq; ++j) acc += g[j] * kk[j];
      dqkv[((size_t)b * seq + r0 + r) * c_qkv + (size_t)h * per_head + d] =
          from_float<T>(acc);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
psa_attention_bwd_dkv_kernel(const T* __restrict__ qkv,
                             const T* __restrict__ dout,
                             const T* __restrict__ dvpos, T* __restrict__ dqkv,
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
  float* pb = st + QCHUNK * 3;          // [QCHUNK][ROWS]: round(p32)
  float* ds = pb + QCHUNK * ROWS;       // [QCHUNK][ROWS]

  const T* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const T* do_head = dout + (size_t)b * seq * c_out + (size_t)h * dh;
  const float* stat = stats + (size_t)(b * nh + h) * seq * 3;

  for (int idx = tid; idx < rows * dk; idx += THREADS) {
    const int jj = idx / dk, d = idx % dk;
    ks[jj * k_stride + d] = to_float(head[(size_t)(j0 + jj) * c_qkv + dk + d]);
  }
  for (int idx = tid; idx < rows * dh; idx += THREADS) {
    const int jj = idx / dh, e = idx % dh;
    vs[jj * v_stride + e] =
        to_float(head[(size_t)(j0 + jj) * c_qkv + 2 * dk + e]);
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
      qs[idx] = to_float(head[(size_t)(i0 + ii) * c_qkv + d]);
    }
    for (int idx = tid; idx < n * dh; idx += THREADS) {
      const int ii = idx / dh, e = idx % dh;
      dos[idx] = to_float(do_head[(size_t)(i0 + ii) * c_out + e]);
    }
    for (int idx = tid; idx < n * 3; idx += THREADS)
      st[idx] = stat[(size_t)i0 * 3 + idx];
    __syncthreads();

    // the chunk's columns of round(p32) and ds for this tile's keys
    for (int idx = tid; idx < n * ROWS; idx += THREADS) {
      const int ii = idx / ROWS, jj = idx % ROWS;
      float p_round = 0.f, ds_round = 0.f;
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
        p_round = round_to<T>(p);
        ds_round = round_to<T>(p * (dpv - st[ii * 3 + 2]) * scale);
      }
      pb[idx] = p_round;
      ds[idx] = ds_round;
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

  T* out = dqkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
#pragma unroll
  for (int m = 0; m < MAX_QK; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < rows * dk) {
      const int jj = idx / dk, d = idx % dk;
      out[(size_t)(j0 + jj) * c_qkv + dk + d] = from_float<T>(acc_k[m]);
    }
  }
  const T* dv_head = dvpos + (size_t)b * seq * c_out + (size_t)h * dh;
#pragma unroll
  for (int m = 0; m < MAX_V; ++m) {
    const int idx = tid + m * THREADS;
    if (idx < rows * dh) {
      const int jj = idx / dh, e = idx % dh;
      out[(size_t)(j0 + jj) * c_qkv + 2 * dk + e] = from_float<T>(
          acc_v[m] + to_float(dv_head[(size_t)(j0 + jj) * c_out + e]));
    }
  }
}

template <typename T>
int launch(const void* qkv, const void* dout, const void* dv, void* dqkv,
           float* stats, int batch, int seq, int nh, int dk, int dh,
           float scale, cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * dq_smem_floats(seq, dk, dh);
  const size_t smem_dkv = sizeof(float) * dkv_smem_floats(dk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_bwd_dq_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(psa_attention_bwd_dkv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + ROWS - 1) / ROWS, nh, batch);
  psa_attention_bwd_dq_kernel<T><<<grid, THREADS, smem_dq, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), stats, seq, nh, dk, dh, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  psa_attention_bwd_dkv_kernel<T><<<grid, THREADS, smem_dkv, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<const T*>(dv), static_cast<T*>(dqkv), stats, seq, nh, dk,
      dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the larger of the two kernels needs for `seq` tokens.
long long psa_attention_bwd_smem_bytes(int seq, int dk, int dh) {
  const long long a = dq_smem_floats(seq, dk, dh);
  const long long b = dkv_smem_floats(dk, dh);
  return (long long)sizeof(float) * (a > b ? a : b);
}

// Largest key width (dk) and head width (dh) the kernels take.
int psa_attention_bwd_max_dk() { return MAX_DK; }
int psa_attention_bwd_max_dh() { return MAX_DH; }

// stats: fp32 scratch of batch·nh·seq·3 words (softmax row maximum, row
// sum, delta). is_bf16: 1 → bfloat16 tensors, 0 → float32. Returns
// cudaGetLastError() after the launches (0 on success).
int psa_attention_bwd(const void* qkv, const void* dout, const void* dv,
                      void* dqkv, void* stats, int batch, int seq, int nh,
                      int dk, int dh, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (is_bf16)
    return launch<__nv_bfloat16>(qkv, dout, dv, dqkv, st, batch, seq, nh, dk,
                                 dh, scale, s);
  return launch<float>(qkv, dout, dv, dqkv, st, batch, seq, nh, dk, dh, scale,
                       s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
