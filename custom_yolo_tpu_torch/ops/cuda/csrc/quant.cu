// Seeded stochastic rounding to int8, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/quant.py::_stochastic_round_kernel (called by
// stochastic_quantize_int8). For a float32 array `flat` (kh*kw*cin, cout),
// already divided by its per-channel scale and clipped to [-127, 127], it
// writes clip(floor(flat + u), -127, 127) as int8, u uniform in [0, 1).
//
// Random bits: the TPU kernel draws them from the core's own generator
// (pltpu.prng_random_bits), which a GPU does not have. Here each element
// draws u from a counter-based Philox4x32-10 (Salmon et al., SC'11) written
// into the kernel: the key is the 64-bit seed, the counter the element's
// flat index, and u = (word0 >> 8) * 2^-24, which is exact in fp32. The same
// generator in plain integer arithmetic is the twin
// (ops/quant_kernel.py::stochastic_round_reference), so kernel and twin agree
// bit for bit; neither gives the TPU's or jax.random's stream.
//
// Bound on the H100: bytes by the contract's table, 4 B read and 1 B written
// per element (21 MB for the x preset's largest leaf, (6912, 768), about
// 8 us at 3.35 TB/s). Ten Philox rounds cost about 100 integer operations per
// element on the CUDA cores besides (4 multiplies, 4 xors, 2 adds a round). One thread per element in a grid-stride
// loop: neighbouring threads read neighbouring floats, nothing is staged.
//
// 127 + u rounds to 128.0 in fp32 when u > 1 - 2^-18, hence the clip after
// the floor.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

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

__global__ void __launch_bounds__(THREADS)
stochastic_round_kernel(const float* __restrict__ x, int8_t* __restrict__ out,
                        uint64_t n, uint32_t k0, uint32_t k1) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * THREADS;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    // (bits >> 8) < 2^24 converts exactly; the product by 2^-24 is exact
    const float u = __fmul_rn(__uint2float_rn(philox_word0(i, k0, k1) >> 8),
                              0x1p-24f);
    const float q = floorf(__fadd_rn(x[i], u));
    out[i] = static_cast<int8_t>(
        __float2int_rz(fminf(fmaxf(q, -127.0f), 127.0f)));
  }
}

}  // namespace

extern "C" {

// x: n float32 values → out: n int8 values, seeded by (k0, k1) = the low and
// high words of the seed. Returns cudaGetLastError() after the launch (0 on
// success).
int stochastic_round_int8(const void* x, void* out, long long n, uint32_t k0,
                          uint32_t k1, void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  // enough blocks to fill the card several times over; the loop takes the rest
  const int grid = static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
  stochastic_round_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(out),
      static_cast<uint64_t>(n), k0, k1);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
