// SPPF pooling pyramid, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/sppf_kernel.py::_sppf_kernel (called
// by sppf_pyramid_pallas). For an NHWC tensor x (B, H, W, C) it writes
// concat[x, p(x), p(p(x)), p(p(p(x)))] along the channel axis, (B, H, W, 4C),
// where p is the 5x5 stride-1 max-pool with -inf borders.
//
// Bound on the H100: bytes. Nothing is computed but comparisons; the input
// is read once and the four slices are written once (12.3 MB at the x
// preset's 8 x 20 x 20 x 384 bf16, a few microseconds at 3.35 TB/s). The
// library chain (three max_pool2d and a cat) reads and writes the pooled
// tensors seven times over.
//
// Design: one block per (image, chunk of CH channels). The H x W x CH tile
// sits in shared memory twice: each pool is a 5x1 pass from the first copy
// to the second and a 1x5 pass back, and after each pool the tile is
// written to its channel slice of the output. Threads run along the channel
// axis, so shared memory is read without bank conflicts and global memory
// in runs of CH elements. The wrapper picks CH so that both copies fit; a
// narrow chunk (16 channels) gives the x preset's p5 map 192 blocks for the
// card's 132 SMs.
//
// Exactness: a max selects one of its inputs, so the result equals the
// max_pool2d chain bit for bit whatever the order. fmaxf would drop a NaN
// where max_pool2d and jnp.maximum propagate it; nan_max below propagates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// max that returns a NaN if either side is one
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  const float fa = as_float(a), fb = as_float(b);
  if (fa != fa) return a;
  return (fb != fb || fb > fa) ? b : a;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sppf_pyramid_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w,
                    int c, int ch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* tmp = cur + (size_t)h * w * ch;

  const int c0 = blockIdx.x * ch;
  const int cw = min(ch, c - c0);
  const size_t img = blockIdx.y;
  const T* xin = x + img * h * w * c + c0;
  T* yout = out + img * h * w * 4 * c + c0;
  // a thread keeps one channel of the chunk and walks the pixels in steps
  // of `lanes`, carrying (row, col) along, so no loop divides
  const int cc = threadIdx.x % ch, lanes = THREADS / ch;
  const int p0 = threadIdx.x / ch, pixels = h * w;
  const bool active = cc < cw;

  if (active)
    for (int p = p0; p < pixels; p += lanes) {
      const T v = xin[(size_t)p * c + cc];
      cur[p * ch + cc] = v;
      yout[(size_t)p * 4 * c + cc] = v;
    }
  __syncthreads();

  for (int level = 1; level <= 3; ++level) {
    // 5x1 along the rows: cur -> tmp
    if (active)
      for (int p = p0, row = p0 / w, col = p0 % w; p < pixels;
           p += lanes, col += lanes) {
        for (; col >= w; col -= w) ++row;
        const int e = p * ch + cc;
        T m = cur[e];
#pragma unroll
        for (int d = -2; d <= 2; ++d) {
          const int r = row + d;
          if (d != 0 && r >= 0 && r < h) m = nan_max(m, cur[e + d * w * ch]);
        }
        tmp[e] = m;
      }
    __syncthreads();
    // 1x5 along the columns: tmp -> cur, and out to this level's slice
    if (active)
      for (int p = p0, col = p0 % w; p < pixels; p += lanes, col += lanes) {
        for (; col >= w; col -= w) {}
        const int e = p * ch + cc;
        T m = tmp[e];
#pragma unroll
        for (int d = -2; d <= 2; ++d) {
          const int q = col + d;
          if (d != 0 && q >= 0 && q < w) m = nan_max(m, tmp[e + d * ch]);
        }
        cur[e] = m;
        yout[(size_t)p * 4 * c + level * c + cc] = m;
      }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, void* out, int b, int h, int w, int c, int ch,
           cudaStream_t stream) {
  const size_t smem = 2 * (size_t)h * w * ch * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      sppf_pyramid_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((c + ch - 1) / ch, b);
  sppf_pyramid_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, c, ch);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (b, h, w, c) NHWC → out (b, h, w, 4c), both of `elem_size` bytes per
// element (2: bf16, 4: fp32). `ch` is the channel chunk of one block, a
// power of two up to 256; 2·h·w·ch·elem_size bytes of shared memory. Returns cudaGetLastError()
// after the launch (0 on success).
int sppf_pyramid(const void* x, void* out, int b, int h, int w, int c, int ch,
                 int elem_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 2)
    return launch<__nv_bfloat16>(x, out, b, h, w, c, ch, s);
  return launch<float>(x, out, b, h, w, c, ch, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
