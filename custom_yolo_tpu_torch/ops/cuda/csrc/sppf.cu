// SPPF pooling pyramid, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/sppf_kernel.py::_sppf_kernel (called
// by sppf_pyramid_pallas). For an NHWC tensor x (B, H, W, C) it writes
// concat[x, p(x), p(p(x)), p(p(p(x)))] along the channel axis, (B, H, W, 4C),
// where p is the 5x5 stride-1 max-pool with -inf borders.
//
// Bound on the H100: bytes. Nothing is computed but maxima; the input is
// read once and the four slices are written once (12.3 MB at the x preset's
// 8 x 20 x 20 x 384 bf16, 3.7 us at 3.35 TB/s). The library chain (three
// max_pool2d and a cat) reads and writes the pooled tensors seven times.
//
// Fewer passes: with -inf borders, p^k(x) at a pixel is the maximum of x over
// the (4k+1) x (4k+1) window around it, clipped to the map (a point z of the
// map within distance 2k of x is reached through the points between them,
// which lie in the map too). So one separable pass forms the radius-2, -4
// and -6 maxima at once: along each row of the tile the maxima over 5, 9
// and 13 columns, growing one from the other, then down each column the
// maxima of those over 5, 9 and 13 rows. A max selects one of its inputs,
// so the values equal the chained pools' whatever the order.
//
// Design: a block takes a tile of TH x TW pixels (at most 16 x 16, chosen
// by the wrapper so the tiles split the map evenly) of one image and CVB
// channel vectors of 16 bytes (8 bf16 or 4 fp32 channels; one channel when
// C or the address does not allow it). The row pass reads x from global memory
// for the tile's columns and for 6 rows of halo above and below (the 6
// columns each side come from the same cache lines, so L1 serves them;
// -inf off the map), writes the x slice of the tile's own pixels, and keeps
// the three row maxima in shared memory; after one barrier the column pass
// writes the three pooled slices. Shared memory holds 3 x (TH + 12) x TW x
// CVB vectors, so its size depends on the tile, never on H x W: any map
// runs, within the 48 KB a block gets without cudaFuncSetAttribute, so
// there is no per-call or per-device setup. Every access is one vector a
// thread, neighbouring threads on neighbouring vectors of a pixel, then on
// neighbouring pixels. Blocks are held to 64 registers, four an SM, so the
// x serve shape's 384 blocks run in one wave.
//
// NaN: max.NaN (bf16x2, bf16, f32; sm_80+) returns a NaN when either input
// is one, as max_pool2d and jnp.maximum propagate it, without a branch or a
// conversion; the NaN it returns is the canonical one, so outputs are NaN
// where the chain's are but their bits may differ. Signed zeros: max.NaN
// orders -0 below +0, so a zero maximum is +0 exactly where its window
// holds a +0, as jnp.maximum gives it in the JAX kernel and the twin
// (sppf_kernel.py::sppf_pyramid_reference) sets it; max_pool2d alone
// keeps the first zero in scan order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HALO = 6;                 // three chained 5x5 pools reach 6
constexpr int MAX_TILE = 16;            // the wrapper's largest tile side
constexpr int MIN_BLOCKS = 4;           // blocks an SM: at most 64 registers
constexpr size_t SMEM_BUDGET = 48 * 1024;

// the element types, as the words a vector is made of
struct Bf16x2 {                         // two bf16 channels
  using Word = uint32_t;
  static __device__ __forceinline__ Word neg_inf() { return 0xFF80FF80u; }
  static __device__ __forceinline__ Word max(Word a, Word b) {
    Word d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
};

struct Bf16 {                           // one bf16 channel (odd C)
  using Word = unsigned short;
  static __device__ __forceinline__ Word neg_inf() { return 0xFF80u; }
  static __device__ __forceinline__ Word max(Word a, Word b) {
    Word d;
    asm("max.NaN.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
    return d;
  }
};

struct F32 {
  using Word = float;
  static __device__ __forceinline__ Word neg_inf() {
    return __int_as_float(static_cast<int>(0xFF800000u));
  }
  static __device__ __forceinline__ Word max(Word a, Word b) {
    Word d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
  }
};

// N words moved as one access (16 bytes, or one element)
template <typename Ops, int N>
struct alignas(sizeof(typename Ops::Word) * N) Vec {
  typename Ops::Word w[N];
};

template <typename Ops, int N>
__device__ __forceinline__ void vmax(Vec<Ops, N>& a, const Vec<Ops, N>& b) {
#pragma unroll
  for (int i = 0; i < N; ++i) a.w[i] = Ops::max(a.w[i], b.w[i]);
}

template <typename Ops, int N>
__device__ __forceinline__ Vec<Ops, N> neg_inf_vec() {
  Vec<Ops, N> v;
#pragma unroll
  for (int i = 0; i < N; ++i) v.w[i] = Ops::neg_inf();
  return v;
}

// x: (b, h, w, nv) vectors; out: (b, h, w, 4 nv) vectors. Block (tile,
// chunk of cvb vectors, image); the tile is th x tw pixels at
// (tile / tiles_x * th, tile % tiles_x * tw).
template <typename Ops, int N>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sppf_pyramid_kernel(const Vec<Ops, N>* __restrict__ x,
                    Vec<Ops, N>* __restrict__ out, int h, int w, int nv,
                    int th, int tw, int tiles_x, int cvb) {
  using V = Vec<Ops, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int eh = th + 2 * HALO;
  V* rows2 = reinterpret_cast<V*>(smem_raw);           // eh x tw x cvb each
  V* rows4 = rows2 + eh * tw * cvb;
  V* rows6 = rows4 + eh * tw * cvb;

  const int y0 = (blockIdx.x / tiles_x) * th, x0 = (blockIdx.x % tiles_x) * tw;
  const int v0 = blockIdx.y * cvb;
  const size_t img = blockIdx.z;
  const V* xin = x + img * h * w * nv;
  V* yout = out + img * h * w * 4 * nv;

  // along the rows, from global memory (neighbouring items share lines in
  // L1): the maxima over 5, 9 and 13 columns around each of the tile's
  // columns, for every row of tile and halo; -inf outside the map. The x
  // slice of the tile's own pixels is written on the way.
  for (int i = threadIdx.x; i < eh * tw * cvb; i += THREADS) {
    const int v = i % cvb, p = i / cvb;
    const int gy = y0 - HALO + p / tw, gx = x0 + p % tw, cv = v0 + v;
    V m2 = neg_inf_vec<Ops, N>(), m4 = m2, m6 = m2;
    if (gy >= 0 && gy < h && gx < w && cv < nv) {
      const V* row = xin + (size_t)gy * w * nv + cv;
      const V centre = row[(size_t)gx * nv];
      // the columns d each side, grown from the radius before; -inf off
      // the map
      auto widen = [&](V& m, int d) {
        const V lo = gx - d >= 0 ? row[(size_t)(gx - d) * nv]
                                 : neg_inf_vec<Ops, N>();
        const V hi = gx + d < w ? row[(size_t)(gx + d) * nv]
                                : neg_inf_vec<Ops, N>();
        vmax(m, lo);
        vmax(m, hi);
      };
      m2 = centre;
      widen(m2, 1);
      widen(m2, 2);
      m4 = m2;
      widen(m4, 3);
      widen(m4, 4);
      m6 = m4;
      widen(m6, 5);
      widen(m6, 6);
      if (gy >= y0 && gy < y0 + th)
        yout[((size_t)gy * w + gx) * 4 * nv + cv] = centre;
    }
    rows2[i] = m2;
    rows4[i] = m4;
    rows6[i] = m6;
  }
  __syncthreads();

  // down the columns: the three pooled slices of the tile's own pixels
  for (int i = threadIdx.x; i < th * tw * cvb; i += THREADS) {
    const int v = i % cvb, p = i / cvb;
    const int r = p / tw, c = p % tw;
    const int gy = y0 + r, gx = x0 + c, cv = v0 + v;
    if (gy >= h || gx >= w || cv >= nv) continue;
    const int at = ((r + HALO) * tw + c) * cvb + v, step = tw * cvb;
    V m1 = rows2[at], m2 = rows4[at], m3 = rows6[at];
#pragma unroll
    for (int d = 1; d <= HALO; ++d) {
      if (d <= 2) {
        vmax(m1, rows2[at - d * step]);
        vmax(m1, rows2[at + d * step]);
      }
      if (d <= 4) {
        vmax(m2, rows4[at - d * step]);
        vmax(m2, rows4[at + d * step]);
      }
      vmax(m3, rows6[at - d * step]);
      vmax(m3, rows6[at + d * step]);
    }
    V* o = yout + ((size_t)gy * w + gx) * 4 * nv + cv;
    o[nv] = m1;
    o[2 * nv] = m2;
    o[3 * nv] = m3;
  }
}

template <typename Ops, int N>
size_t smem_bytes(int th, int tw, int cvb) {
  return 3 * (size_t)(th + 2 * HALO) * tw * cvb * sizeof(Vec<Ops, N>);
}

template <typename Ops, int N>
int launch(const void* x, void* out, int b, int h, int w, int nv, int th,
           int tw, int cvb, cudaStream_t stream) {
  const size_t smem = smem_bytes<Ops, N>(th, tw, cvb);
  if (th < 1 || tw < 1 || th > MAX_TILE || tw > MAX_TILE || cvb < 1
      || smem > SMEM_BUDGET)
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (w + tw - 1) / tw, tiles_y = (h + th - 1) / th;
  const dim3 grid(tiles_y * tiles_x, (nv + cvb - 1) / cvb, b);
  sppf_pyramid_kernel<Ops, N><<<grid, THREADS, smem, stream>>>(
      static_cast<const Vec<Ops, N>*>(x), static_cast<Vec<Ops, N>*>(out), h,
      w, nv, th, tw, tiles_x, cvb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (b, h, w, c) NHWC → out (b, h, w, 4c), elements of `elem_size` bytes
// (2: bf16, 4: fp32) taken `vec` channels at a time (bf16: 8 or 1; fp32: 4
// or 1; c a multiple of vec, both pointers aligned to vec elements); nv =
// c / vec. Tiles of th x tw pixels (each at most 16) and cvb vectors of
// channels a block, at most 48 KB of shared memory (sppf_smem_bytes).
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int sppf_pyramid(const void* x, void* out, int b, int h, int w, int nv,
                 int elem_size, int vec, int th, int tw, int cvb,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 2 && vec == 8)
    return launch<Bf16x2, 4>(x, out, b, h, w, nv, th, tw, cvb, s);
  if (elem_size == 2 && vec == 1)
    return launch<Bf16, 1>(x, out, b, h, w, nv, th, tw, cvb, s);
  if (elem_size == 4 && vec == 4)
    return launch<F32, 4>(x, out, b, h, w, nv, th, tw, cvb, s);
  if (elem_size == 4 && vec == 1)
    return launch<F32, 1>(x, out, b, h, w, nv, th, tw, cvb, s);
  return (int)cudaErrorInvalidValue;
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
