// Seeded stochastic rounding to int8, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/quant.py::_stochastic_round_kernel (called by
// stochastic_quantize_int8). For float32 arrays `flat` (kh*kw*cin, cout),
// each already divided by its per-channel scale and clipped to [-127, 127],
// it writes clip(floor(flat + u), -127, 127) as int8, u uniform in [0, 1).
//
// Random bits: the TPU kernel draws them from the core's own generator
// (pltpu.prng_random_bits), which a GPU does not have. Here each element
// draws u from a counter-based Philox4x32-10 (Salmon et al., SC'11) written
// into the kernel: the key is the 64-bit seed, the counter the element's
// flat index within its array, and u = (word0 >> 8) * 2^-24, which is exact
// in fp32. The same generator in plain integer arithmetic is the twin
// (ops/quant_kernel.py::stochastic_round_reference), so kernel and twin agree
// bit for bit; neither gives the TPU's or jax.random's stream.
//
// One launch for many arrays: Detector.quantize() rounds every int8 leaf of
// the model (149 arrays of the x preset) in one launch. The wrapper copies a
// table of leaves (source, destination, element count, first block) to the
// card; a block finds its leaf by a binary search over the first blocks and
// takes BLOCK_ELEMS consecutive elements of it, eight a thread: two 16-byte
// loads, eight Philox draws (independent, so their multiplies overlap), one
// 8-byte store. A leaf's last block, and a leaf whose addresses are not
// aligned for those accesses, loads and stores its elements one by one.
//
// Bound on the H100: bytes, narrowly. Each element runs ten Philox rounds
// (two 32x32->64 multiplies and two three-input xors a round) for 5 bytes of
// memory traffic. chip_smoke.py counts an element's instructions in this
// kernel's SASS (44 on the vector path: the multiplies on the FMA pipe, the
// xors, shift and clip on the ALU pipe beside it, 3 conversions, 2 fp32
// operations); the issue rate of 128 a clock per SM binds them at 0.34
// clocks an element, a little under the 5 bytes' time at 3.35 TB/s.
//
// 127 + u rounds to 128.0 in fp32 when u > 1 - 2^-18, hence the clip after
// the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 8;
constexpr int BLOCK_ELEMS = THREADS * PER_THREAD;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

// one array to round; the layout of a row of the wrapper's int64 table
struct Leaf {
  const float* src;
  int8_t* dst;
  long long n;
  long long first_block;
};

// first output word of Philox4x32-10 at counter (idx_lo, idx_hi, 0, 0)
__device__ __forceinline__ uint32_t philox_word0(uint64_t idx, uint32_t k0,
                                                 uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(idx);
  uint32_t c1 = static_cast<uint32_t>(idx >> 32);
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c0), lo0 = PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c2), lo1 = PHILOX_M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c0;
}

__device__ __forceinline__ int8_t round_one(float x, uint64_t idx,
                                            uint32_t k0, uint32_t k1) {
  // (bits >> 8) < 2^24 converts exactly; the product by 2^-24 is exact
  const float u = __fmul_rn(__uint2float_rn(philox_word0(idx, k0, k1) >> 8),
                            0x1p-24f);
  const float q = floorf(__fadd_rn(x, u));
  return static_cast<int8_t>(__float2int_rz(fminf(fmaxf(q, -127.0f), 127.0f)));
}

__global__ void __launch_bounds__(THREADS)
stochastic_round_grouped_kernel(const Leaf* __restrict__ leaves, int n_leaves,
                                uint32_t k0, uint32_t k1) {
  // the last leaf whose first block is at or before this block
  const long long block = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first_block <= block) lo = mid; else hi = mid - 1;
  }
  const float* src = leaves[lo].src;
  int8_t* dst = leaves[lo].dst;
  const long long n = leaves[lo].n;
  const long long start =
      (block - leaves[lo].first_block) * BLOCK_ELEMS
      + static_cast<long long>(threadIdx.x) * PER_THREAD;
  if (start >= n) return;
  const bool whole = start + PER_THREAD <= n
      && (reinterpret_cast<uintptr_t>(src) & 15) == 0
      && (reinterpret_cast<uintptr_t>(dst) & 7) == 0;
  float x[PER_THREAD];
  if (whole) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(src + start));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(src + start) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      x[k] = start + k < n ? src[start + k] : 0.0f;
  }
  // one copy of the draws for both cases, so the SASS holds PER_THREAD
  // Philox draws (chip_smoke.py counts their instructions)
  uint32_t packed[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const uint32_t q = static_cast<uint8_t>(
        round_one(x[k], static_cast<uint64_t>(start) + k, k0, k1));
    packed[k / 4] |= q << (8 * (k % 4));
  }
  if (whole) {
    __stcs(reinterpret_cast<uint2*>(dst + start),
           make_uint2(packed[0], packed[1]));
  } else {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k)
      if (start + k < n)
        dst[start + k] = static_cast<int8_t>(packed[k / 4] >> (8 * (k % 4)));
  }
}

}  // namespace

extern "C" {

// leaves: n_leaves rows of the table (device memory), each leaf non-empty
// and its first_block the number of blocks of the leaves before it, a block
// taking block_elems elements (the wrapper's count, which must be this
// kernel's); blocks: the blocks of all leaves. Seeded by (k0, k1) = the low
// and high words of the seed. Returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for arguments the kernel does not
// take.
int stochastic_round_int8_grouped(const void* leaves, int n_leaves,
                                  long long blocks, int block_elems,
                                  uint32_t k0, uint32_t k1, void* stream) {
  if (block_elems != BLOCK_ELEMS || blocks > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_leaves <= 0 || blocks <= 0) return 0;
  stochastic_round_grouped_kernel<<<static_cast<unsigned>(blocks), THREADS,
                                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
