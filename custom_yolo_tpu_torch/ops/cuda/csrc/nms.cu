// Greedy-NMS keep masks, hand-written for Hopper (sm_90a): the batched
// sweep, and the bitmask route for a single image.
//
// Both compute, for each image: boxes (K, 4) xyxy sorted by descending
// score, keep starts as `valid`, and for i = 0..K-1, if keep[i], every
// j > i with IoU(i, j) > iou_thres is cleared.
//
// Bound on the H100: the inputs are tiny (8 images × 1024 boxes is
// ~150 KB) and the IoU work is a few MFLOP, so the least time is well
// under a microsecond. What bounds these kernels is the sequential sweep:
// K dependent steps.
//
// nms_keep_kernel — replaces custom_yolo_tpu/ops/pallas/nms_kernel.py::
// _nms_kernel_batched (called by nms_keep_pallas_batched). One block per
// image, one thread per candidate (up to 1024, a thread owns ⌈K/1024⌉
// candidates beyond that). Boxes, areas and keep flags sit in shared
// memory (24·K bytes); the K×K IoU matrix is never stored. Step i reads
// keep[i] from shared memory, so the branch is uniform across the block;
// a step whose box is already suppressed or invalid costs no barrier.
//
// nms_mask_kernel + nms_sweep_kernel — replace custom_yolo_tpu/ops/pallas/
// nms_kernel.py::_nms_kernel (called by nms_keep_pallas), the keep mask of
// one image per program. With one image the batched kernel occupies one of
// the card's 132 SMs and pays a block-wide barrier per kept box. Here a
// grid of 64-thread blocks first writes the upper triangle of the bit
// matrix "j > i and IoU(i, j) > iou_thres" (K rows of ⌈K/64⌉ 64-bit words,
// scratch from the wrapper); then one block walks it 64 rows at a time:
// all its threads bring the 64 rows into shared memory, one warp settles
// the 64 boxes against the word of removed bits that covers them (a chain
// of 64 dependent shared-memory reads, no barrier), and its lanes OR the
// rows of the kept boxes into the removed words of later boxes.
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
constexpr int SWEEP_THREADS = 256;

// IoU(a, b) > iou_thres, in the operation order of ops/nms.py
__device__ __forceinline__ bool iou_above(float ax1, float ay1, float ax2,
                                          float ay2, float aarea, float bx1,
                                          float by1, float bx2, float by2,
                                          float barea, float iou_thres) {
  const float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(aarea, barea), inter), 1e-7f);
  return __fdiv_rn(inter, denom) > iou_thres;
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

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
    area[j] = box_area(bx1, by1, bx2, by2);
    flag[j] = valid[n * k + j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    if (!flag[i]) continue;  // uniform: every thread reads the same word
    const float ix1 = x1[i], iy1 = y1[i], ix2 = x2[i], iy2 = y2[i];
    const float iarea = area[i];
    for (int j = i + 1 + threadIdx.x; j < k; j += blockDim.x) {
      if (!flag[j]) continue;
      if (iou_above(x1[j], y1[j], x2[j], y2[j], area[j], ix1, iy1, ix2, iy2,
                    iarea, iou_thres))
        flag[j] = 0;
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < k; j += blockDim.x)
    keep[n * k + j] = static_cast<uint8_t>(flag[j]);
}

// Word (i, col) of the bit matrix of one image: bit t says that box
// 64·col + t comes after box i and overlaps it above the threshold. Only
// the upper triangle (col ≥ i / 64) is written; the sweep reads no other.
__global__ void __launch_bounds__(64)
nms_mask_kernel(const float* __restrict__ boxes,
                unsigned long long* __restrict__ mask, int k, int words,
                float iou_thres) {
  const int col_blk = blockIdx.x, row_blk = blockIdx.y;
  if (col_blk < row_blk) return;
  __shared__ float cx1[64], cy1[64], cx2[64], cy2[64], carea[64];
  const float* b = boxes + (size_t)blockIdx.z * k * 4;
  const int t = threadIdx.x;
  const int j = col_blk * 64 + t;
  if (j < k) {
    cx1[t] = b[4 * j];
    cy1[t] = b[4 * j + 1];
    cx2[t] = b[4 * j + 2];
    cy2[t] = b[4 * j + 3];
    carea[t] = box_area(cx1[t], cy1[t], cx2[t], cy2[t]);
  }
  __syncthreads();
  const int i = row_blk * 64 + t;
  if (i >= k) return;
  const float ix1 = b[4 * i], iy1 = b[4 * i + 1];
  const float ix2 = b[4 * i + 2], iy2 = b[4 * i + 3];
  const float iarea = box_area(ix1, iy1, ix2, iy2);
  const int cols = min(64, k - col_blk * 64);
  unsigned long long bits = 0;
  for (int u = 0; u < cols; ++u)
    if (col_blk * 64 + u > i &&
        iou_above(cx1[u], cy1[u], cx2[u], cy2[u], carea[u], ix1, iy1, ix2, iy2,
                  iarea, iou_thres))
      bits |= 1ULL << u;
  mask[((size_t)blockIdx.z * k + i) * words + col_blk] = bits;
}

// The ordered sweep over the bit matrix of one image per block.
__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                 const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 int k, int words) {
  extern __shared__ unsigned long long sweep_smem[];
  unsigned long long* rows = sweep_smem;              // (64, words)
  unsigned long long* removed = rows + 64 * words;    // (words)
  mask += (size_t)blockIdx.x * k * words;
  valid += (size_t)blockIdx.x * k;
  keep += (size_t)blockIdx.x * k;
  const int tid = threadIdx.x;

  for (int wd = tid; wd < words; wd += SWEEP_THREADS) removed[wd] = 0;
  for (int c = 0; c < words; ++c) {
    const int first = 64 * c;
    const int nrows = min(64, k - first);
    const int span = words - c;
    for (int e = tid; e < nrows * span; e += SWEEP_THREADS) {
      const int r = e / span, wd = c + e % span;
      rows[r * words + wd] = mask[(size_t)(first + r) * words + wd];
    }
    __syncthreads();
    if (tid < 32) {
      const unsigned lo = __ballot_sync(
          0xffffffffu, tid < nrows && valid[first + tid] != 0);
      const unsigned hi = __ballot_sync(
          0xffffffffu, 32 + tid < nrows && valid[first + 32 + tid] != 0);
      const unsigned long long live = lo | ((unsigned long long)hi << 32);
      // the 64 boxes of this word against each other, in order
      unsigned long long gone = removed[c], kept = 0;
      for (int r = 0; r < nrows; ++r)
        if (((live >> r) & 1ULL) && !((gone >> r) & 1ULL)) {
          kept |= 1ULL << r;
          gone |= rows[r * words + c];
        }
      // what the kept boxes remove among later words
      for (int wd = c + 1 + tid; wd < words; wd += 32) {
        unsigned long long acc = removed[wd];
        for (unsigned long long left = kept; left; left &= left - 1)
          acc |= rows[(__ffsll((long long)left) - 1) * words + wd];
        removed[wd] = acc;
      }
      for (int r = tid; r < nrows; r += 32)
        keep[first + r] = static_cast<uint8_t>((kept >> r) & 1ULL);
    }
    __syncthreads();
  }
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

long long nms_sweep_smem_bytes(int k) {
  return 65LL * sizeof(unsigned long long) * ((k + 63) / 64);
}

// The bitmask route: boxes (n, k, 4) fp32, valid (n, k) bool → keep (n, k)
// bool, with `mask` a scratch array of n·k·⌈k/64⌉ 64-bit words. Returns the
// first CUDA error of the two launches (0 on success).
int nms_keep_bitmask(const void* boxes, const void* valid, void* keep,
                     void* mask, int n, int k, float iou_thres, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + 63) / 64;
  const size_t smem = nms_sweep_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_mask_kernel<<<dim3(words, words, n), 64, 0, s>>>(
      static_cast<const float*>(boxes),
      static_cast<unsigned long long*>(mask), k, words, iou_thres);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<n, SWEEP_THREADS, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), k,
      words);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
