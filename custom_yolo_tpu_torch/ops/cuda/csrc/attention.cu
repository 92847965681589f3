// PSA attention forward, hand-written for Hopper (sm_90a).
//
// Replaces: custom_yolo_tpu/ops/pallas/attention_kernel.py::_attn_kernel
// (attention_kernel.py:37, called by psa_attention_pallas). Computes, per
// batch element and head,
//   p   = softmax(q kᵀ · dk^-0.5)   scores and softmax in fp32,
//   out = p·v                        p rounded to the input type, fp32 sum,
// from token-major qkv (B, T, nh·(2dk+dh)) with the per-head channel layout
// [q(dk) | k(dk) | v(dh)], and writes out and a bit-exact copy of v, each
// (B, T, nh·dh). Rounding points are those of psa_attention_reference.
//
// Bounds on the H100 (132 SMs at 1.98 GHz): bytes or products, and the
// exponentials. At the x shape (B=8, T=400, nh=6, dk=32, dh=64, bf16) the
// function reads qkv once and writes out and v, 9.8 MB (2.9 µs at 3.35
// TB/s), does 1.5 GFLOP of products (1.5 µs at the bf16 tensor-core peak)
// and takes 7.7·10⁶ exponentials (1.8 µs at the special-function units'
// 16 ex2 a clock an SM). At head size 32 the exponentials bound it: a 4K
// frame of YOLO12x (16 calls, 40 strips of 8,160 tokens, 12 heads, dk = dh
// = 32) takes 3.2·10¹⁰, 7.7 ms, against 4.1 ms for its bytes and products.
//
// bf16 (psa_attention_fwd_tc): one pass over the keys, online softmax.
// A block of four warps takes ROWS = 64·MB query rows of one (batch
// element, head); a warp's 16·MB rows keep their q fragments in
// registers, and 64-key tiles of k and v, kept bf16, stream through a
// double-buffered cp.async ring in shared memory, so any T runs. Each tile
// is taken 32 keys at a time: S = q·kᵀ by mma.sync.m16n8k16 (bf16 → fp32,
// each k fragment from ldmatrix serving all MB row blocks), the row
// maximum of the 32 raw scores, p̃ = 2^(raw·c − m) in fp32 with one FMA and
// one ex2.approx (c = dk^-0.5·log2 e), summed into the row's l and rounded
// to bf16 straight into the A fragments of P·V, whose fp32 accumulators
// (the output) stay in registers over all T. m is a running maximum that
// may lag a row's true maximum by up to 2^8 (attend32: GROWTH): when a
// row's maximum passes it by more, the warp rescales l and the
// accumulators by 2^(m_old − m_new). So the rescale, which a maximum kept
// exact asks for whenever any of a warp's rows grows, is rare. At the end
// out = acc / l, rounded once to bf16. Only the last tile masks keys
// past the sequence; dk and dh are zero-padded to 32/64/128. Each
// exponential, product and key is taken once: half the exponentials and
// two thirds of the products of a two-pass schedule, which takes the
// statistics first and the scores again for p = exp(s − m)/l.
//
// Rounding: bf16 operands, scores, softmax, sums and the output's
// accumulation in fp32, as in psa_attention_reference. Only the point
// where p is rounded to bf16 moves, from after the division by the row sum
// (the twin's p = bf16(e/l)) to before it (bf16(p̃), divided by l once at
// the end), as in FlashAttention. Both are p·(1 + δ) with |δ| ≤ 2^-9, but
// of different values, so the output strays further from the twin's than
// the two-pass kernel's did, which rounded where the twin rounds. Against
// the twin's limit (2e-2 as atol and rtol, chip_smoke.py ATTN_TOL) on
// chip_smoke.py's cases: up to 0.0078 at T ≤ 1,600, 0.21 of the limit
// (about 5× room, where the two-pass kernel's 0.002 left about 10×); at
// the two 4K cases, whose q and k are scaled so that each query picks out
// a few keys, up to 0.031 (one bf16 step of an output near 4), 0.31-0.34
// of it (3× room). From a float64 attention it lies about as far as the
// twin: up to 0.0035 at T ≤ 1,600 (the twin 0.0053) and 0.0155 at 4K
// (0.0151) (scripts/torch_attention_probe.py, H100; PERF.md, PR 23).
//
// Tile parameters come from the padded widths (Tc): MB = 2 at 32/32 and
// 32/64, 1 above; 32/32 is capped at 168 registers for three blocks an SM.
// ptxas (H100): 165 registers at 32/32 and 217 at 32/64, no spills;
// shared memory 30,720 B a block at 32/32 and 38,912 B at 32/64. Grid
// ⌈T/ROWS⌉ × nh × B. v is copied by 16-byte vectors where rows are
// aligned, element by element otherwise; unaligned rows (c_qkv, dk or dh
// not a multiple of 8) are staged element by element, synchronously.
// Where the time goes (ablations, issue, the special-function and tensor
// pipes' shares): PERF.md.
//
// fp32 (psa_attention_fwd_kernel): TF32 tensor cores cannot meet the fp32
// limit (1e-5), so fp32 stays on the CUDA cores. One block takes 32 query
// rows and streams the keys in tiles of 64 through a fixed buffer (kᵀ, the
// 32 x 64 scores, the v tile: 4·(32·dk + 65·dk + 32·64 + 64·dh) bytes,
// 37 KB at dk=32, dh=64), so shared memory does not grow with T and any T
// runs. Two passes over the key tiles: the row maximum m and sum
// l online (l rescaled by exp(m_old − m_new) when m grows), then
// p = exp(s − m)/l and out += p·v in fp32 in token order. Scores and the
// softmax use expf and an IEEE division, as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tiles.cuh"

namespace {

// ------------------------------------------------------------ fp32 route

constexpr int ROWS = 32;
constexpr int KEYS = 64;            // keys of a streamed tile
constexpr int THREADS = 256;
constexpr int MAX_DH = 128;
constexpr int MAX_OUT = ROWS * MAX_DH / THREADS;

__host__ __device__ constexpr int smem_floats(int dk, int dh) {
  return ROWS * dk + dk * (KEYS + 1) + ROWS * KEYS + KEYS * dh;
}

// s[r][j] = (q_r · k_j) · scale for the tile's n keys, summed over d in
// ascending order
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

// kᵀ of keys j0..j0+n-1 into kt ([dk][KEYS + 1])
__device__ __forceinline__ void stage_keys(const float* head, float* kt,
                                           int j0, int n, int dk, int c_qkv) {
  for (int idx = threadIdx.x; idx < n * dk; idx += THREADS) {
    const int j = idx / dk, d = idx % dk;
    kt[d * (KEYS + 1) + j] = head[(size_t)(j0 + j) * c_qkv + dk + d];
  }
}

__global__ void __launch_bounds__(THREADS)
psa_attention_fwd_kernel(const float* __restrict__ qkv,
                         float* __restrict__ out, float* __restrict__ vout,
                         int seq, int nh, int dk, int dh, float scale) {
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
  float* kt = qs + ROWS * dk;         // [dk][KEYS + 1]
  float* s = kt + dk * (KEYS + 1);    // [ROWS][KEYS]: scores, then p
  float* vs = s + ROWS * KEYS;        // [KEYS][dh]

  const float* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const float* v = head + 2 * dk;

  for (int idx = tid; idx < rows * dk; idx += THREADS) {
    const int r = idx / dk, d = idx % dk;
    qs[r * dk + d] = head[(size_t)(r0 + r) * c_qkv + d];
  }

  // pass 1: each row's maximum m and sum l of exp(s − m), online over the
  // key tiles; warp w keeps rows w, w + 8, w + 16, w + 24
  float m[ROWS / 8], l[ROWS / 8];
#pragma unroll
  for (int i = 0; i < ROWS / 8; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int j0 = 0; j0 < seq; j0 += KEYS) {
    const int n = min(KEYS, seq - j0);
    __syncthreads();  // the previous tile is no longer read
    stage_keys(head, kt, j0, n, dk, c_qkv);
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

  // pass 2: p = exp(s − m) / l per tile, out[r][e] += Σ_j p[r][j] · v[j][e]
  // in fp32, key by key in token order
  float acc[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) acc[o] = 0.f;
  for (int j0 = 0; j0 < seq; j0 += KEYS) {
    const int n = min(KEYS, seq - j0);
    __syncthreads();
    stage_keys(head, kt, j0, n, dk, c_qkv);
    for (int idx = tid; idx < n * dh; idx += THREADS) {
      const int jj = idx / dh, e = idx % dh;
      vs[jj * dh + e] = v[(size_t)(j0 + jj) * c_qkv + e];
    }
    __syncthreads();
    score_tile(qs, kt, s, rows, n, dk, scale);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS / 8; ++i) {
      const int r = warp + 8 * i;
      if (r >= rows) continue;
      float* row = s + r * KEYS;
      for (int j = lane; j < n; j += 32) row[j] = expf(row[j] - m[i]) / l[i];
    }
    __syncthreads();
#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o) {
      const int idx = tid + o * THREADS;
      if (idx < rows * dh) {
        const int r = idx / dh, e = idx % dh;
        const float* p = s + r * KEYS;
        float a = acc[o];
        for (int jj = 0; jj < n; ++jj) a += p[jj] * vs[jj * dh + e];
        acc[o] = a;
      }
    }
  }

  // write out and the bit-exact copy of v
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) {
    const int idx = tid + o * THREADS;
    if (idx < rows * dh) {
      const int r = idx / dh, e = idx % dh;
      const size_t at = ((size_t)b * seq + r0 + r) * c_out + (size_t)h * dh + e;
      out[at] = acc[o];
      vout[at] = v[(size_t)(r0 + r) * c_qkv + e];
    }
  }
}

// ------------------------------------------------------------- bf16 route
using psa::bf16;
using psa::TILE;

// Tile parameters of the one-pass kernel, from the padded head widths. A
// warp takes MB blocks of 16 query rows and reads each k and v fragment
// from shared memory once for all of them: at MB = 2 a score costs half
// the ldmatrix traffic it costs one 16-row block. MB = 1 where two blocks'
// accumulators would not fit in registers. At 32/32 the registers are
// capped so that three blocks (12 warps) share an SM.
template <int DKP, int DHP>
struct Tc {
  static constexpr int MB = DKP + DHP <= 96 ? 2 : 1;
  static constexpr int MIN_BLOCKS = DKP + DHP <= 64 ? 3 : 1;
  static constexpr int ROWS = 16 * MB * psa::THREADS / 32;  // of a block
  static constexpr int KB = TILE * (DKP + psa::PAD);  // elements of a k tile
  static constexpr int VB = TILE * (DHP + psa::PAD);  // of a v tile
  // bytes: the q rows (MB k-shaped tiles), STAGES k and STAGES v tiles
  static constexpr int SMEM = 2 * (MB * KB + psa::STAGES * (KB + VB));
};

// the bit-exact copy of v for rows r0..r0+ROWS-1 of one head
template <int ROWS>
__device__ __forceinline__ void copy_v(const bf16* v, bf16* vout, int r0,
                                       int seq, int dh, int c_qkv, int c_out,
                                       bool vec) {
  const int rows = min(ROWS, seq - r0);
  if (vec) {
    const int chunks = dh / 8;
    for (int i = threadIdx.x; i < rows * chunks; i += psa::THREADS) {
      const int r = i / chunks, c = (i % chunks) * 8;
      *reinterpret_cast<uint4*>(vout + (size_t)(r0 + r) * c_out + c) =
          *reinterpret_cast<const uint4*>(v + (size_t)(r0 + r) * c_qkv + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * dh; i += psa::THREADS) {
      const int r = i / dh, e = i % dh;
      vout[(size_t)(r0 + r) * c_out + e] = v[(size_t)(r0 + r) * c_qkv + e];
    }
  }
}

// A thread's share of streaming TILE-row tiles of a bf16 matrix with row
// stride ld, whose rows are 16-byte aligned, into [TILE][W + PAD] tiles of
// shared memory: one 16-byte column chunk of every STEP-th row, zeros past
// `rows` and past `width`. Pointer and offset are set once, so a tile
// costs a thread TILE / STEP asynchronous copies and little more.
template <int W>
struct Stream {
  static constexpr int CHUNKS = W / 8;
  static constexpr int STEP = psa::THREADS / CHUNKS;
  const bf16* src;  // this thread's chunk of row 0
  int dst;          // its element offset in a tile
  int row;          // its first row in a tile
  bool inside;      // its chunk lies inside the width

  __device__ Stream(const bf16* base, int ld, int width) {
    row = threadIdx.x / CHUNKS;
    const int c = threadIdx.x % CHUNKS * 8;
    src = base + (size_t)row * ld + c;
    dst = row * (W + psa::PAD) + c;
    inside = c < width;
  }

  // rows row0..row0+TILE-1 into tile
  __device__ __forceinline__ void copy(bf16* tile, int row0, int rows,
                                       int ld) const {
    const bf16* from = src + (size_t)row0 * ld;
#pragma unroll
    for (int k = 0; k < TILE / STEP; ++k) {
      const bool ok = inside && row0 + row + k * STEP < rows;
      psa::cp_async16(tile + dst + k * STEP * (W + psa::PAD),
                      ok ? from + (size_t)k * STEP * ld : src, ok);
    }
  }
};

// Raw scores of 16·MB query rows (A fragments qf) against the 32 keys
// from `key` on of a staged k tile: sc[mb][n] holds keys key + 8n..+7,
// each summed over the 16-column blocks of q and k in ascending order.
// Each k fragment serves every row block.
template <int DKP, int MB>
__device__ __forceinline__ void scores32(float (&sc)[MB][4][4],
                                         const uint32_t (&qf)[MB][DKP / 16][4],
                                         const bf16* kt, int key, int lane) {
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[mb][n][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DKP / 16; ++kk)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      uint32_t kb[4];
      psa::ldsm_x4(kb, psa::frag_b_addr(kt, DKP + psa::PAD, key + 16 * c,
                                        16 * kk, lane));
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        psa::mma(sc[mb][2 * c], qf[mb][kk], kb[0], kb[1]);
        psa::mma(sc[mb][2 * c + 1], qf[mb][kk], kb[2], kb[3]);
      }
    }
}

// how far a row's maximum may pass m before m follows it (log2 units)
constexpr float GROWTH = 8.f;

// The online softmax and P·V over those 32 keys: rows key..key+31 of the
// staged v tile, keys key0..key0+31 of the sequence. Per row block mb and
// row half r (rows g and g + 8): m is the row's running maximum of raw·c,
// or up to GROWTH under it, l this lane's share of the row sum of
// 2^(raw·c − m), acc the unnormalised output. LAST: the sequence's last
// tile, the only one whose keys can pass its end; each 32 keys given hold
// at least one key of the sequence, so their maximum is finite.
template <int DHP, int MB, bool LAST>
__device__ __forceinline__ void attend32(float (&sc)[MB][4][4],
                                         float (&m)[MB][2], float (&l)[MB][2],
                                         float (&acc)[MB][DHP / 8][4],
                                         const bf16* vt, int key, int key0,
                                         int seq, float c_log2, int lane) {
  if (LAST && key0 + 32 > seq) {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (key0 + 8 * n + 2 * (lane & 3) + (i & 1) >= seq) {
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) sc[mb][n][i] = -INFINITY;
        }
  }
  // Row maxima of raw·c. m follows a row's maximum only when it passes m
  // by more than GROWTH (log2 units), so p̃ ≤ 2^GROWTH, far inside fp32's
  // range, and bf16 rounds p̃ to the same relative precision at any
  // scale. So once the first keys have set m, most half tiles skip the
  // rescale.
  float top[MB][2];
  bool grew = false;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(sc[mb][0][2 * r], sc[mb][0][2 * r + 1]);
#pragma unroll
      for (int n = 1; n < 4; ++n)
        mx = fmaxf(mx, fmaxf(sc[mb][n][2 * r], sc[mb][n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      top[mb][r] = __fmul_rn(mx, c_log2);
      grew |= top[mb][r] > m[mb][r] + GROWTH;
    }
  if (__any_sync(0xffffffffu, grew)) {
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[mb][r], top[mb][r]);
        const float alpha = psa::exp2_approx(m[mb][r] - m_new);
        l[mb][r] *= alpha;
#pragma unroll
        for (int n = 0; n < DHP / 8; ++n) {
          acc[mb][n][2 * r] *= alpha;
          acc[mb][n][2 * r + 1] *= alpha;
        }
        m[mb][r] = m_new;
      }
  }
  // p̃ = 2^(raw·c − m) in fp32 (one FMA, one ex2.approx) into l, rounded to
  // bf16 straight into the A fragments of P·V; each v fragment serves
  // every row block
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    uint32_t pa[MB][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
#pragma unroll
      for (int n = 2 * c; n < 2 * c + 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = psa::exp2_approx(
              __fmaf_rn(sc[mb][n][i], c_log2, -m[mb][i >> 1]));
          l[mb][i >> 1] += p;
          sc[mb][n][i] = p;
        }
      psa::pack_a(pa[mb], sc[mb][2 * c], sc[mb][2 * c + 1]);
    }
#pragma unroll
    for (int n = 0; n < DHP / 16; ++n) {
      uint32_t vb[4];
      psa::ldsm_x4_t(vb, psa::frag_a_addr(vt, DHP + psa::PAD, key + 16 * c,
                                          16 * n, lane));
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        psa::mma(acc[mb][2 * n], pa[mb], vb[0], vb[1]);
        psa::mma(acc[mb][2 * n + 1], pa[mb], vb[2], vb[3]);
      }
    }
  }
}

// One key tile of 64 (keys key0..key0+63 of the sequence), 32 keys at a
// time, so that a half tile's scores take 16·MB registers a lane. LAST:
// the sequence's last tile, whose second half may hold no key at all.
template <int DKP, int DHP, int MB, bool LAST>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qf)[MB][DKP / 16][4], float (&m)[MB][2],
    float (&l)[MB][2], float (&acc)[MB][DHP / 8][4], const bf16* kt,
    const bf16* vt, int key0, int seq, float c_log2, int lane) {
  float sc[MB][4][4];
  scores32<DKP, MB>(sc, qf, kt, 0, lane);
  attend32<DHP, MB, LAST>(sc, m, l, acc, vt, 0, key0, seq, c_log2, lane);
  if (LAST && key0 + 32 >= seq) return;
  scores32<DKP, MB>(sc, qf, kt, 32, lane);
  attend32<DHP, MB, LAST>(sc, m, l, acc, vt, 32, key0 + 32, seq, c_log2,
                          lane);
}

template <int DKP, int DHP>
__global__ void __launch_bounds__(psa::THREADS, Tc<DKP, DHP>::MIN_BLOCKS)
psa_attention_fwd_tc(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     bf16* __restrict__ vout, int seq, int nh, int dk, int dh,
                     float scale, int aligned, int vec_v) {
  using P = Tc<DKP, DHP>;
  constexpr int MB = P::MB;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [ROWS][DKP + PAD]
  bf16* ks = qs + MB * P::KB;                   // STAGES k tiles
  bf16* vs = ks + psa::STAGES * P::KB;          // STAGES v tiles

  const int r0 = blockIdx.x * P::ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int per_head = 2 * dk + dh;
  const int c_qkv = nh * per_head;
  const int c_out = nh * dh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (seq + TILE - 1) / TILE;
  const bf16* head = qkv + (size_t)b * seq * c_qkv + (size_t)h * per_head;
  const Stream<DKP> k_stream(head + dk, c_qkv, dk);
  const Stream<DHP> v_stream(head + 2 * dk, c_qkv, dh);

  // key tile s, its k and v, into ring slot s % STAGES
  auto stage = [&](int s) {
    if (s < tiles) {
      const int key0 = s * TILE, slot = s % psa::STAGES;
      bf16* kt = ks + slot * P::KB;
      bf16* vt = vs + slot * P::VB;
      if (aligned) {
        k_stream.copy(kt, key0, seq, c_qkv);
        v_stream.copy(vt, key0, seq, c_qkv);
      } else {
        psa::load_tile<DKP>(kt, head + dk, c_qkv, key0, seq, dk, false);
        psa::load_tile<DHP>(vt, head + 2 * dk, c_qkv, key0, seq, dh, false);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < MB; ++i)
    psa::load_tile<DKP>(qs + i * P::KB, head, c_qkv, r0 + i * TILE, seq, dk,
                        aligned);
  for (int s = 0; s < psa::STAGES - 1; ++s) {
    stage(s);
    psa::cp_async_commit();
  }
  copy_v<P::ROWS>(head + 2 * dk,
                  vout + (size_t)b * seq * c_out + (size_t)h * dh, r0, seq,
                  dh, c_qkv, c_out, vec_v);

  const float c_log2 = scale * 1.4426950408889634f;  // dk^-0.5 · log2(e)
  uint32_t qf[MB][DKP / 16][4];
  float m[MB][2], l[MB][2], acc[MB][DHP / 8][4];  // as attend32 keeps them
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    m[mb][0] = m[mb][1] = -INFINITY;
    l[mb][0] = l[mb][1] = 0.f;
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mb][n][i] = 0.f;
  }

  for (int s = 0; s < tiles; ++s) {
    // tile s has landed and every warp is done with tile s − 1, whose
    // slot takes tile s + STAGES − 1
    psa::cp_async_wait<psa::STAGES - 2>();
    __syncthreads();
    stage(s + psa::STAGES - 1);
    psa::cp_async_commit();
    if (s == 0) {
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
        psa::load_a<DKP>(qf[mb], qs, 16 * (MB * warp + mb), lane);
    }
    const bf16* kt = ks + (s % psa::STAGES) * P::KB;
    const bf16* vt = vs + (s % psa::STAGES) * P::VB;
    if (s + 1 < tiles)
      attend_tile<DKP, DHP, MB, false>(qf, m, l, acc, kt, vt, s * TILE, seq,
                                       c_log2, lane);
    else
      attend_tile<DKP, DHP, MB, true>(qf, m, l, acc, kt, vt, s * TILE, seq,
                                      c_log2, lane);
  }

  // out = acc / l, rounded once
  bf16* o = out + (size_t)b * seq * c_out + (size_t)h * dh;
  const int g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const float inv_l[2] = {1.f / psa::reduce_quad_sum(l[mb][0]),
                            1.f / psa::reduce_quad_sum(l[mb][1])};
#pragma unroll
    for (int n = 0; n < DHP / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 16 * (MB * warp + mb) + g + 8 * half;
        const int col = 8 * n + t2;
        if (row >= seq) continue;
        bf16* dst = o + (size_t)row * c_out + col;
        if (col < dh)
          dst[0] = __float2bfloat16_rn(acc[mb][n][2 * half] * inv_l[half]);
        if (col + 1 < dh)
          dst[1] =
              __float2bfloat16_rn(acc[mb][n][2 * half + 1] * inv_l[half]);
      }
  }
}

template <int DKP, int DHP>
int launch_tc(const void* qkv, void* out, void* v, int batch, int seq, int nh,
              int dk, int dh, float scale, cudaStream_t stream) {
  using P = Tc<DKP, DHP>;
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_fwd_tc<DKP, DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int c_qkv = nh * (2 * dk + dh), c_out = nh * dh;
  const bool rows16 = reinterpret_cast<uintptr_t>(qkv) % 16 == 0 &&
                      c_qkv % 8 == 0 && dk % 8 == 0 && dh % 8 == 0;
  const bool vec_v = rows16 && reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                     c_out % 8 == 0;
  const dim3 grid((seq + P::ROWS - 1) / P::ROWS, nh, batch);
  psa_attention_fwd_tc<DKP, DHP><<<grid, psa::THREADS, P::SMEM, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<bf16*>(v), seq, nh, dk, dh, scale, (int)rows16,
      (int)vec_v);
  return (int)cudaGetLastError();
}

template <int DKP>
int launch_tc_dh(const void* qkv, void* out, void* v, int batch, int seq,
                 int nh, int dk, int dh, float scale, cudaStream_t stream) {
  switch (psa::pad_dh(dh)) {
    case 32:
      return launch_tc<DKP, 32>(qkv, out, v, batch, seq, nh, dk, dh, scale,
                                stream);
    case 64:
      return launch_tc<DKP, 64>(qkv, out, v, batch, seq, nh, dk, dh, scale,
                                stream);
    default:
      return launch_tc<DKP, 128>(qkv, out, v, batch, seq, nh, dk, dh, scale,
                                 stream);
  }
}

int launch_fp32(const void* qkv, void* out, void* v, int batch, int seq,
                int nh, int dk, int dh, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(dk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      psa_attention_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + ROWS - 1) / ROWS, nh, batch);
  psa_attention_fwd_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out),
      static_cast<float*>(v), seq, nh, dk, dh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest key width (dk) and head width (dh) the kernels take.
int psa_attention_max_dk() { return psa::MAX_DK; }
int psa_attention_max_dh() { return MAX_DH; }

// is_bf16: 1 → bfloat16 tensors (tensor cores), 0 → float32 (CUDA cores).
// Returns cudaGetLastError() after the launch (0 on success).
int psa_attention_fwd(const void* qkv, void* out, void* v, int batch, int seq,
                      int nh, int dk, int dh, float scale, int is_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dk > psa::MAX_DK || dh > MAX_DH) return (int)cudaErrorInvalidValue;
  if (!is_bf16)
    return launch_fp32(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
  if (psa::pad_dk(dk) == 32)
    return launch_tc_dh<32>(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
  return launch_tc_dh<64>(qkv, out, v, batch, seq, nh, dk, dh, scale, s);
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
