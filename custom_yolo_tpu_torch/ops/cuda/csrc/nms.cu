// Batched greedy-NMS keep mask, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/nms_kernel.py::_nms_kernel_batched
// (called by nms_keep_pallas_batched). For each image: boxes (K, 4) xyxy
// sorted by descending score, keep starts as `valid`, and for i = 0..K-1,
// if keep[i], every j > i with IoU(i, j) > iou_thres is cleared. The K×K
// IoU matrix is never stored.
//
// Bound on the H100: the inputs are tiny (8 images × 1024 boxes is
// ~150 KB) and the IoU work is a few MFLOP, so the least time is well
// under a microsecond. What bounds this kernel is the sequential sweep:
// K dependent steps, each ending in a block-wide barrier.
//
// Design: one block per image, one thread per candidate (up to 1024, a
// thread owns ⌈K/1024⌉ candidates beyond that). Boxes, areas and keep
// flags sit in shared memory (24·K bytes). Step i reads keep[i] from
// shared memory, so the branch is uniform across the block; a step whose
// box is already suppressed or invalid costs no barrier.
//
// Exactness: keep-sets are compared bit for bit with the JAX package.
// The IoU is evaluated in the same order as ops/nms.py and the Pallas
// kernel, with round-to-nearest intrinsics and the file compiled with
// -fmad=false, so no multiply-add contracts into an FMA; the division is
// IEEE; the threshold is the fp32 value the wrapper passes and the test
// is a strict >.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS)
nms_keep_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int k, float iou_thres) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  int* flag = reinterpret_cast<int*>(area + k);

  const size_t n = blockIdx.x;
  const float* b = boxes + n * k * 4;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float bx1 = b[4 * j], by1 = b[4 * j + 1];
    const float bx2 = b[4 * j + 2], by2 = b[4 * j + 3];
    x1[j] = bx1;
    y1[j] = by1;
    x2[j] = bx2;
    y2[j] = by2;
    area[j] = __fmul_rn(__fsub_rn(bx2, bx1), __fsub_rn(by2, by1));
    flag[j] = valid[n * k + j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (!flag[i]) continue;  // uniform: every thread reads the same word
    const float ix1 = x1[i], iy1 = y1[i], ix2 = x2[i], iy2 = y2[i];
    const float iarea = area[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!flag[j]) continue;
      const float iw = fmaxf(__fsub_rn(fminf(x2[j], ix2), fmaxf(x1[j], ix1)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(y2[j], iy2), fmaxf(y1[j], iy1)), 0.f);
      const float inter = __fmul_rn(iw, ih);
      const float denom =
          __fadd_rn(__fsub_rn(__fadd_rn(area[j], iarea), inter), 1e-7f);
      if (__fdiv_rn(inter, denom) > iou_thres) flag[j] = 0;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep[n * k + j] = static_cast<uint8_t>(flag[j]);
}

}  // namespace

extern "C" {

long long nms_keep_smem_bytes(int k) { return 6LL * sizeof(float) * k; }

// boxes (n, k, 4) fp32, valid (n, k) bool → keep (n, k) bool. Returns
// cudaGetLastError() after the launch (0 on success).
int nms_keep_batched(const void* boxes, const void* valid, void* keep, int n,
                     int k, float iou_thres, void* stream) {
  const size_t smem = nms_keep_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = k < MAX_THREADS ? ((k + 31) / 32) * 32 : MAX_THREADS;
  nms_keep_kernel<<<n, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, iou_thres);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
