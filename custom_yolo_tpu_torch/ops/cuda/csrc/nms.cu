// Greedy-NMS keep masks, hand-written for Hopper (sm_90a): one design for
// a batch of images and for a single image.
//
// Both compute, for each image: boxes (K, 4) xyxy sorted by descending
// score, keep starts as `valid`, and for i = 0..K-1, if keep[i], every
// j > i with IoU(i, j) > iou_thres is cleared; an invalid box never
// suppresses.
//
// Replaces custom_yolo_tpu/ops/pallas/nms_kernel.py::_nms_kernel_batched
// (called by nms_keep_pallas_batched) and ::_nms_kernel (called by
// nms_keep_pallas); the wrappers nms_keep_batched and nms_keep_single of
// ops/nms_kernel.py both launch nms_keep_bitmask below.
//
// Bound on the H100: the inputs are tiny (8 images × 1024 boxes is
// ~150 KB) and the IoU work is a few MFLOP, so the least time is well
// under a microsecond. What bounds these kernels is the sequential sweep:
// ⌈K/64⌉ dependent steps per image.
//
// nms_mask_kernel writes the upper triangle of the bit matrix "j > i and
// IoU(i, j) > iou_thres" of every image into global scratch from the
// wrapper, word-major: ⌈K/64⌉ words of K rows. A linear block index walks
// the upper-triangle 64 × 64 tiles of all images, so every block that
// launches has work and the whole card builds the matrix. A tile's 64
// column boxes go into shared memory once; four threads share a row box,
// 16 columns each, and OR their bits together with two shuffles. Rows of
// invalid boxes are written as 0: the sweep never reads them. The
// diagonal tiles also write each box's column word (the earlier boxes of
// its 64 that it overlaps), which is what the sweep settles a chunk with.
//
// nms_sweep_kernel walks one image per block, 64 boxes (a chunk, one word)
// at a time, with a block barrier per chunk and no other. Each of its 8
// warps holds 4 words of a 32-word tile of the chunk's rows in registers,
// lane l rows l and l + 32, and loads the next tile while this one is
// swept, so nothing of the sweep grows with K but the removed words. Every
// warp settles the chunk itself, by rounds of ballots over the column
// words (a round keeps each undecided box that no earlier undecided box
// overlaps and removes what those overlap), so no barrier waits for one
// settling thread. Then each warp ORs the kept
// rows of its words (a reduction over its lanes) into the removed words,
// each of which one lane alone writes. The removed words start as the
// invalid boxes; they live in shared memory up to REMOVED_CAP words
// (K ≤ 65,536; the wrapper may set a lower limit) and in the global
// scratch beyond that. Neither kernel uses dynamic shared memory, so no
// cudaFuncSetAttribute is needed.
//
// scripts/torch_nms_probe.py --ablate builds this file with one part of
// the sweep left out (-DNMS_ABLATE_LOADS / _SETTLE / _PUSH; the keep-sets
// are then wrong, only their time is read), and with -DNMS_PROFILE, which
// counts the cycles of the sweep's phases.
//
// Exactness: keep-sets are compared bit for bit with the JAX package.
// The IoU is evaluated in the same order as ops/nms.py and the Pallas
// kernel, with round-to-nearest intrinsics and the file compiled with
// -fmad=false, so no multiply-add contracts into an FMA; every test that
// a fast quotient cannot settle with a margin (see iou_terms) takes the
// IEEE division; the threshold is the fp32 value the wrapper passes and
// the test is a strict >.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int MASK_THREADS = 256;  // 64 rows of a tile, 4 threads a row
constexpr int TILE_WORDS = 32;     // words of 64 rows a sweep tile holds
constexpr int SWEEP_THREADS = 256; // 8 warps × 4 words of a tile
constexpr int REMOVED_CAP = 1024;  // removed words kept in shared memory

// The intersection of boxes a and b and the denominator of their IoU, in
// the operation order of ops/nms.py: the IoU is inter / denom, and a box
// overlaps another when the IEEE quotient is > iou_thres.
//
// The mask kernel first takes the fast quotient q = __fdividef(inter,
// denom), within 2 ulp (2^-22 relative) of the real quotient x while
// 2^-100 ≤ denom ≤ 2^100, inter ≤ 2^100, and settles the test only when
// the threshold t (2^-60 ≤ t ≤ 2^60) is clear of it: q ≥ t·(1 + 2^-18)
// gives x > t·(1 + 2^-19), so RN(x) > t; q ≤ t·(1 − 2^-18) gives
// x < t·(1 − 2^-19), so RN(x) ≤ t (both cuts rounded to nearest, 2^-24).
// Every other test, including each pair within 2^-18 of the threshold and
// every NaN, infinity, empty or degenerate box, takes the IEEE division, so
// the bit is the one the division gives.
__device__ __forceinline__ void iou_terms(float ax1, float ay1, float ax2,
                                          float ay2, float aarea, float bx1,
                                          float by1, float bx2, float by2,
                                          float barea, float* inter,
                                          float* denom) {
  const float iw = fmaxf(__fsub_rn(fminf(ax2, bx2), fmaxf(ax1, bx1)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(ay2, by2), fmaxf(ay1, by1)), 0.f);
  *inter = __fmul_rn(iw, ih);
  *denom = __fadd_rn(__fsub_rn(__fadd_rn(aarea, barea), *inter), 1e-7f);
}

__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
}

// Block b of the grid → (image, row tile, column tile ≥ row tile). The
// tiles of one image are numbered row by row; counted from the last one,
// row tile words-1-q holds q+1 tiles.
__device__ __forceinline__ void tile_of(long long b, int words,
                                        long long tiles, int* image,
                                        int* row_blk, int* col_blk) {
  *image = (int)(b / tiles);
  const long long u = tiles - 1 - b % tiles;
  long long q = (long long)((sqrt(8.0 * (double)u + 1.0) - 1.0) * 0.5);
  while ((q + 1) * (q + 2) / 2 <= u) ++q;
  while (q * (q + 1) / 2 > u) --q;
  const long long p = u - q * (q + 1) / 2;
  *row_blk = words - 1 - (int)q;
  *col_blk = words - 1 - (int)p;
}

// Word (col, i) of the bit matrix of one image: bit t says that box
// 64·col + t comes after box i and overlaps it above the threshold. Only
// the upper triangle (col ≥ i / 64) is written; the sweep reads no other.
// The matrix is stored word-major, (words, K) per image, so the sweep
// reads 32 rows of a word as 256 contiguous bytes. A diagonal tile also
// writes each box's column word: bit t says that box 64·(i / 64) + t comes
// before box i and overlaps it (the test of (i, j) is bit for bit that of
// (j, i): each of its operations is commutative). Four threads share a
// row, 16 columns each, so a thread has 16 independent IoUs in flight.
__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(const float* __restrict__ boxes,
                const uint8_t* __restrict__ valid, u64* __restrict__ mask,
                u64* __restrict__ earlier, int k, int words, long long tiles,
                float iou_thres) {
  int image, row_blk, col_blk;
  tile_of(blockIdx.x, words, tiles, &image, &row_blk, &col_blk);
  __shared__ float cx1[64], cy1[64], cx2[64], cy2[64], carea[64];
  const float* b = boxes + (size_t)image * k * 4;
  const int t = threadIdx.x;
  if (t < 64) {
    // columns past K get an empty box, so their (unused) test is settled
    // by the fast quotient
    const int j = col_blk * 64 + t;
    const bool in = j < k;
    cx1[t] = in ? b[4 * j] : 0.f;
    cy1[t] = in ? b[4 * j + 1] : 0.f;
    cx2[t] = in ? b[4 * j + 2] : 0.f;
    cy2[t] = in ? b[4 * j + 3] : 0.f;
    carea[t] = box_area(cx1[t], cy1[t], cx2[t], cy2[t]);
  }
  __syncthreads();
  const int r = t / 4, part = t % 4;
  const int i = row_blk * 64 + r;
  const bool diagonal = col_blk == row_blk;
  u64 later = 0, before = 0;
  if (i < k && valid[(size_t)image * k + i]) {
    const float ix1 = b[4 * i], iy1 = b[4 * i + 1];
    const float ix2 = b[4 * i + 2], iy2 = b[4 * i + 3];
    const float iarea = box_area(ix1, iy1, ix2, iy2);
    const int cols = min(64, k - col_blk * 64);
    // A fast quotient settles a test when it lies clearly on one side of
    // the threshold; the IEEE division decides the rest (see iou_terms)
    const bool certified = iou_thres >= 0x1p-60f && iou_thres <= 0x1p60f;
    const float hi_cut = __fmul_rn(iou_thres, 1.0f + 0x1p-18f);
    const float lo_cut = __fmul_rn(iou_thres, 1.0f - 0x1p-18f);
    u64 above = 0, unsure = 0;
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const int u = 16 * part + v;
      float inter, denom;
      iou_terms(cx1[u], cy1[u], cx2[u], cy2[u], carea[u], ix1, iy1, ix2, iy2,
                iarea, &inter, &denom);
      const float q = __fdividef(inter, denom);
      const bool sure = certified && denom >= 0x1p-100f &&
                        denom <= 0x1p100f && inter <= 0x1p100f;
      if (sure && q >= hi_cut) above |= 1ULL << u;
      if (!(sure && (q >= hi_cut || q <= lo_cut))) unsure |= 1ULL << u;
    }
    while (unsure) {
      const int u = __ffsll(static_cast<long long>(unsure)) - 1;
      unsure &= unsure - 1;
      float inter, denom;
      iou_terms(cx1[u], cy1[u], cx2[u], cy2[u], carea[u], ix1, iy1, ix2, iy2,
                iarea, &inter, &denom);
      if (__fdiv_rn(inter, denom) > iou_thres) above |= 1ULL << u;
    }
    const u64 in_row = cols == 64 ? ~0ULL : (1ULL << cols) - 1;
    const u64 after = diagonal ? ~0ULL << r << 1 : ~0ULL;
    later = above & in_row & after;
    if (diagonal) before = above & ((1ULL << r) - 1);
  }
  later |= __shfl_xor_sync(0xffffffffu, later, 1);
  later |= __shfl_xor_sync(0xffffffffu, later, 2);
  before |= __shfl_xor_sync(0xffffffffu, before, 1);
  before |= __shfl_xor_sync(0xffffffffu, before, 2);
  if (i < k && part == 0) {
    mask[((size_t)image * words + col_blk) * k + i] = later;
    if (diagonal) earlier[(size_t)image * k + i] = before;
  }
}

// This thread's rows of tile `tile` of chunk `chunk` (rows 64·chunk..,
// words chunk + TILE_WORDS·tile ..): warp w holds the tile's words 4w ..
// 4w+3, lane l rows l and l + 32 of each (dst[2j], dst[2j+1] of word
// 4w+j); 0 past K, past the row, and for the chunk's own word.
__device__ __forceinline__ void load_rows(u64 (&dst)[8],
                                          const u64* __restrict__ mask,
                                          int k, int words, int chunk,
                                          int tile, int warp, int lane) {
  const int wd = chunk + TILE_WORDS * tile + 4 * warp;
  const int row = 64 * chunk + lane;
  const u64* at = mask + (size_t)wd * k + row;
  const bool lo = row < k, hi = row + 32 < k;
  if (wd >= words || wd + 3 <= chunk) {  // none of the warp's words
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = 0ULL;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = wd + j > chunk && wd + j < words;
    dst[2 * j] = in && lo ? at[(size_t)j * k] : 0ULL;
    dst[2 * j + 1] = in && hi ? at[(size_t)j * k + 32] : 0ULL;
  }
}

// The keep-set of one 64-box chunk, the same in every lane of the warp:
// `undecided` holds the boxes neither removed by earlier chunks nor
// invalid; lane l holds the column words of boxes l (`cl`) and l + 32
// (`ch`), the earlier boxes of the chunk that overlap them. A round keeps
// every undecided box that no earlier undecided box overlaps (the first
// one always qualifies) and removes the boxes those overlap; a box is
// decided in at most as many rounds as the chain of overlaps before it.
// `rounds`, where given (the -DNMS_PROFILE build), counts the rounds.
__device__ __forceinline__ u64 settle(u64 undecided, u64 cl, u64 ch,
                                      int lane, long long* rounds) {
  constexpr unsigned ALL = 0xffffffffu;
  u64 kept = 0;
#ifndef NMS_ABLATE_SETTLE
  while (undecided) {
    const bool in_l = (undecided >> lane) & 1ULL;
    const bool in_h = (undecided >> (lane + 32)) & 1ULL;
    const u64 safe =
        __ballot_sync(ALL, in_l && !(cl & undecided)) |
        (static_cast<u64>(__ballot_sync(ALL, in_h && !(ch & undecided)))
         << 32);
    const u64 gone =
        __ballot_sync(ALL, in_l && (cl & safe)) |
        (static_cast<u64>(__ballot_sync(ALL, in_h && (ch & safe))) << 32);
    kept |= safe;
    undecided &= ~(safe | gone);
    if (rounds) ++*rounds;
  }
#else
  kept = undecided;
#endif
  return kept;
}

#ifdef NMS_PROFILE
// cycles of the sweep's phases in block 0: threads 0 and 32, 8 counters
// each: barrier, loads, settle, ORs, settle rounds, loop, set-up, tiles
__device__ long long nms_profile_cycles[16];
#define NMS_MARK(i)                        \
  do {                                     \
    const long long now_ = clock64();      \
    prof[i] += now_ - prof_mark;           \
    prof_mark = now_;                      \
  } while (0)
#else
#define NMS_MARK(i) \
  do {              \
  } while (0)
#endif

// The ordered sweep over the bit matrix, one image per block; the removed
// words in shared memory (InShared) or in `removed_global`.
template <bool InShared>
__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const u64* __restrict__ mask,
                 const u64* __restrict__ earlier,
                 const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 u64* __restrict__ removed_global, int k, int words) {
  __shared__ u64 removed_shared[InShared ? REMOVED_CAP : 1];
  const int image = blockIdx.x;
  mask += (size_t)image * words * k;
  earlier += (size_t)image * k;
  valid += (size_t)image * k;
  keep += (size_t)image * k;
  u64* removed =
      InShared ? removed_shared : removed_global + (size_t)image * words;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
#ifdef NMS_PROFILE
  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0}, prof_mark = clock64();
#endif

  // the tile being swept and the next one, and the column words of this
  // chunk and the next, in registers
  u64 cur[8], next[8];
  load_rows(cur, mask, k, words, 0, 0, warp, lane);
  u64 cl = lane < k ? earlier[lane] : 0ULL;
  u64 ch = 32 + lane < k ? earlier[32 + lane] : 0ULL;
  u64 next_cl = 0, next_ch = 0;
  // the removed words start as the invalid boxes (and those past K), so
  // the settle reads no flag from global memory
  for (int wd = warp; wd < words; wd += SWEEP_THREADS / 32) {
    const int first = 64 * wd;
    const unsigned lo = __ballot_sync(
        0xffffffffu, first + lane < k && valid[first + lane] != 0);
    const unsigned hi = __ballot_sync(
        0xffffffffu, first + 32 + lane < k && valid[first + 32 + lane] != 0);
    if (lane == 0) removed[wd] = ~(lo | (static_cast<u64>(hi) << 32));
  }
  // the tiles in order: chunk by chunk, each chunk's words from its own on
  int chunk = 0, tile = 0;
  u64 kept = 0;
  NMS_MARK(6);
  for (;;) {
    NMS_MARK(5);
    int next_chunk = chunk, next_tile = tile + 1;
    if (chunk + TILE_WORDS * next_tile >= words) {
      ++next_chunk;
      next_tile = 0;
    }
    const bool more = next_chunk < words;
    // every earlier chunk's ORs are done
    if (tile == 0) __syncthreads();
    NMS_MARK(0);
#ifndef NMS_ABLATE_LOADS
    if (more) {
      load_rows(next, mask, k, words, next_chunk, next_tile, warp, lane);
      if (next_tile == 0) {
        const int first = 64 * next_chunk;
        next_cl = first + lane < k ? earlier[first + lane] : 0ULL;
        next_ch = first + 32 + lane < k ? earlier[first + 32 + lane] : 0ULL;
      }
    }
#else
#pragma unroll
    for (int i = 0; i < 8; ++i) next[i] = cur[i];
    next_cl = cl;
    next_ch = ch;
#endif
    NMS_MARK(1);
    if (tile == 0) {
      // every warp settles the chunk itself, so no barrier waits for it
#ifdef NMS_PROFILE
      kept = settle(~removed[chunk], cl, ch, lane, &prof[4]);
#else
      kept = settle(~removed[chunk], cl, ch, lane, nullptr);
#endif
      if (warp == 0) {
        const int first = 64 * chunk, nrows = min(64, k - first);
        if (lane < nrows)
          keep[first + lane] = static_cast<uint8_t>((kept >> lane) & 1ULL);
        if (32 + lane < nrows)
          keep[first + 32 + lane] =
              static_cast<uint8_t>((kept >> (32 + lane)) & 1ULL);
      }
    }
    NMS_MARK(2);
#ifndef NMS_ABLATE_PUSH
    // what the chunk's kept boxes remove among later words: a lane ORs its
    // kept rows of each of its warp's four words, the warp folds them, and
    // lane 0 writes the word, which no other thread writes (words outside
    // the chunk's later ones were loaded as 0)
    if (kept) {
      const bool kl = (kept >> lane) & 1ULL, kh = (kept >> (lane + 32)) & 1ULL;
      unsigned lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const u64 acc = (kl ? cur[2 * j] : 0ULL) | (kh ? cur[2 * j + 1] : 0ULL);
        lo[j] = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(acc));
        hi[j] = __reduce_or_sync(0xffffffffu, static_cast<unsigned>(acc >> 32));
      }
      if (lane == 0) {
        const int wd = chunk + TILE_WORDS * tile + 4 * warp;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (lo[j] | hi[j])
            removed[wd + j] |= lo[j] | (static_cast<u64>(hi[j]) << 32);
      }
    }
#endif
    NMS_MARK(3);
#ifdef NMS_PROFILE
    ++prof[7];
#endif
    if (!more) break;
#pragma unroll
    for (int i = 0; i < 8; ++i) cur[i] = next[i];
    if (next_tile == 0) {
      cl = next_cl;
      ch = next_ch;
    }
    chunk = next_chunk;
    tile = next_tile;
  }
#ifdef NMS_PROFILE
  if (blockIdx.x == 0 && (tid == 0 || tid == 32))
    for (int i = 0; i < 8; ++i) nms_profile_cycles[tid / 4 + i] = prof[i];
#endif
}

}  // namespace

extern "C" {

// boxes (n, k, 4) fp32, valid (n, k) bool → keep (n, k) bool, with
// `scratch` a device array of n·(⌈k/64⌉·(k + 1) + k) 64-bit words: the bit
// matrix (n, ⌈k/64⌉, k), the column words (n, k), then the removed words
// (n, ⌈k/64⌉) of pools beyond shared memory. The removed words of an image
// stay in shared memory while there are at most min(shared_words,
// REMOVED_CAP) of them. Returns the first CUDA error of the two launches
// (0 on success).
int nms_keep_bitmask(const void* boxes, const void* valid, void* keep,
                     void* scratch, int n, int k, float iou_thres,
                     int shared_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (k + 63) / 64;
  const long long tiles = (long long)words * (words + 1) / 2;
  u64* mask = static_cast<u64*>(scratch);
  u64* earlier = mask + (size_t)n * words * k;
  u64* removed = earlier + (size_t)n * k;
  nms_mask_kernel<<<(unsigned)(tiles * n), MASK_THREADS, 0, s>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      mask, earlier, k, words, tiles, iou_thres);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (words <= shared_words && words <= REMOVED_CAP)
    nms_sweep_kernel<true><<<n, SWEEP_THREADS, 0, s>>>(
        mask, earlier, static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(keep), removed, k, words);
  else
    nms_sweep_kernel<false><<<n, SWEEP_THREADS, 0, s>>>(
        mask, earlier, static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(keep), removed, k, words);
  return (int)cudaGetLastError();
}

#ifdef NMS_PROFILE
// the counters of the last sweep, 16 × int64 into host memory `out`
int nms_profile_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, nms_profile_cycles,
                                   sizeof(nms_profile_cycles));
}
#endif

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
