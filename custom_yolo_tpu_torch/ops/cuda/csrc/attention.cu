// PSA attention forward, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/attention_kernel.py::_attn_kernel
// (called by psa_attention_pallas). Computes, per batch element and head,
//   p   = softmax(q kᵀ · dk^-0.5)   scores and softmax in fp32,
//   out = p·v                        p rounded to the input type, fp32 sum,
// from token-major qkv (B, T, nh·(2dk+dh)) with the per-head channel layout
// [q(dk) | k(dk) | v(dh)], and writes out and a bit-exact copy of v, each
// (B, T, nh·dh). Rounding points are those of psa_attention_reference.
//
// Bound on the H100: at the flagship shape (B=8, T=400, nh=6, dk=32,
// dh=64, bf16) the function moves ~10 MB and does ~1.5 GFLOP, so the
// least time is set by bytes (~3 µs at 3.35 TB/s). This version is far
// from that: it works in fp32 on the CUDA cores, not the tensor cores, and
// each product reads both operands from shared memory.
//
// Design: the Pallas kernel holds one batch element whole in VMEM; one
// head's T×T fp32 score matrix (640 KB at T=400) does not fit in a
// block's 227 KB of shared memory. So one block takes (row tile of
// ROWS queries, head, batch element) and keeps in shared memory the tile's
// fp32 score rows over all T keys, the q tile and kᵀ (both fp32; kᵀ rows
// padded by one word so the transposing store is free of bank
// conflicts). It finishes the softmax in place (no online softmax: p is
// normalised before it is rounded, as in the reference), then streams v
// through the kᵀ region in chunks of tokens and sums p·v into registers,
// each thread owning up to MAX_OUT outputs.
// Shared memory = 4·(ROWS·dk + dk·(T+1) + ROWS·T) bytes; the wrapper
// refuses a T for which that exceeds the card's 232,448 bytes, and a dh
// above MAX_DH.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 32;
constexpr int THREADS = 256;
constexpr int MAX_DH = 128;
constexpr int MAX_OUT = ROWS * MAX_DH / THREADS;

__host__ __device__ constexpr long long smem_floats(int seq, int dk) {
  return (long long)ROWS * dk + (long long)dk * (seq + 1) +
         (long long)ROWS * seq;
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
psa_attention_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                         T* __restrict__ vout, int seq, int nh, int dk,
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

  const int kt_stride = seq + 1;
  float* qs = smem;                   // [ROWS][dk]
  float* kt = qs + ROWS * dk;         // [dk][seq + 1], later v chunks
  float* s = kt + dk * kt_stride;     // [ROWS][seq]

  const T* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;

  for (int idx = tid; idx < rows * dk; idx += THREADS) {
    const int r = idx / dk, d = idx % dk;
    qs[r * dk + d] = to_float(head[(size_t)(r0 + r) * c_qkv + d]);
  }
  for (int idx = tid; idx < seq * dk; idx += THREADS) {
    const int j = idx / dk, d = idx % dk;
    kt[d * kt_stride + j] = to_float(head[(size_t)j * c_qkv + dk + d]);
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

  // softmax over keys, one warp per row; p rounded to T as the reference
  // rounds it before the PV product
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
    for (int j = lane; j < seq; j += 32)
      row[j] = to_float(from_float<T>(row[j] / sum));
  }
  __syncthreads();

  // out[r][e] = Σ_j p[r][j] · v[j][e], summed in fp32 in token order; v
  // is staged through the kᵀ region, `chunk` tokens at a time
  const T* v = head + 2 * dk;
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
      vs[jj * dh + e] = to_float(v[(size_t)(j0 + jj) * c_qkv + e]);
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
      out[o] = from_float<T>(acc[m]);
      vout[o] = v[(size_t)(r0 + r) * c_qkv + e];
    }
  }
}

template <typename T>
int launch(const void* qkv, void* out, void* v, int batch, int seq, int nh,
           int dk, int dh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(seq, dk);
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + ROWS - 1) / ROWS, nh, batch);
  psa_attention_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<T*>(v),
      seq, nh, dk, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs for a sequence of `seq` tokens.
long long psa_attention_smem_bytes(int seq, int dk) {
  return (long long)sizeof(float) * smem_floats(seq, dk);
}

// Largest head width (dh) the kernel takes.
int psa_attention_max_dh() { return MAX_DH; }

// is_bf16: 1 → bfloat16 tensors, 0 → float32. Returns cudaGetLastError()
// after the launch (0 on success).
int psa_attention_fwd(const void* qkv, void* out, void* v, int batch, int seq,
                      int nh, int dk, int dh, float scale, int is_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
  return launch<float>(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
