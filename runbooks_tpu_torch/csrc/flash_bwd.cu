// Flash attention backward for Hopper (sm_90a): dq, and dk/dv, from bf16
// q, k, v, do and the forward's f32 lse; f32 accumulation; gradients
// written in bf16 or f32.
//
// Replaces the Pallas TPU kernels runbooks_tpu/ops/flash_attention.py
// _bwd_dq_kernel (K2) and _bwd_dkv_kernel (K3), both launched by
// flash_attention_bwd. Same contract as the forward (csrc/flash_fwd.cu):
// layout [b, s, h, d]; query head h reads kv head h / n_rep; masking by
// absolute position (kv_pos >= PAD_POS masked, causal kv_pos <= q_pos,
// segments q_seg == kv_seg and kv_seg != 0); p = exp(s * scale - lse) on
// the unmasked pairs (lse <= NEG_INF, a row with no valid key, is guarded to
// 0 and all its p are masked), dp = do v^T, ds = p (dp - delta) scale with
// delta = rowsum(do * out) computed by the caller; the causal block skip by
// storage index in 64-row groups when sq == sk.
//
// Design. The TPU kernels walk a sequential grid axis with the sums in VMEM
// scratch. Here every sum lives in registers of one thread block of four
// warps, and both kernels are built from the forward kernel's parts:
//
// - K2 (dq): one block per (q head, batch row, 64-row q tile), each warp 16
//   query rows. The q tile is the slowest grid axis and is walked from the
//   last, so the heaviest blocks start first. Q and dO arrive by cp.async
//   and are then held as mma A fragments in registers (at d=256 they stay
//   in shared memory and are reloaded per 16-key chunk, as K3 reloads K and
//   V). The block walks the 64-key kv tiles; per 16-key chunk, S = Q K^T
//   and dP = dO V^T run as mma.sync m16n8k16 (bf16 operands, f32
//   accumulate), p and ds are formed in registers (no row max is needed:
//   lse is known), and ds, rounded to bf16, is the A fragment of
//   dQ += dS K.
// - K3 (dk, dv): one block per (kv head, batch row, 64-key kv tile), each
//   warp 16 keys. The kv tile is the slowest grid axis and is walked from
//   the first (the heaviest under the causal mask). K and V stay in shared
//   memory; the block walks the n_rep query heads of its group and, for
//   each, the q tiles. Per 32-query chunk S^T = K Q^T and dP^T = V dO^T
//   give p^T and ds^T, which feed dV += P^T dO and dK += dS^T Q. dk and dv
//   for the whole group stay in f32 registers and are written once at
//   kv-head width: no [b, h, sk, d] buffer and no separate fold. Every
//   block writes its keys, so keys that no query sees come out exactly 0.
//   At d=256 the head_dim is split across two blocks per kv tile (DSPLIT):
//   each forms S^T and dP^T over the whole head_dim and accumulates dK and
//   dV for its 128 columns.
//
// Step by step, what each part does:
//
// 1. Fragments through ldmatrix. Row-major operands (Q, dO, K, V as A of
//    S, dP, S^T, dP^T, or as their B) load with ldmatrix.x4; the
//    transposed B operands (K in dS K, dO in P^T dO, Q in dS^T Q) with
//    ldmatrix.x4.trans. Rows are padded to D + 8 elements (272 bytes at
//    d=128), so each 8-row ldmatrix phase hits 32 distinct banks and every
//    row stays 16-byte aligned for cp.async.
// 2. p = ex2.approx(s * (scale log2 e) - lse log2 e): one FMA and one
//    special-function op per element, the row term formed once per row.
//    Masked elements get p = 0 and ds = 0 exactly.
// 3. Exact tile classes, counted on the card. Before its walk a block
//    summarises its own tile (K2: the q tile's live rows, those below sq
//    and not in segment 0; K3: the kv tile's valid keys, below sk and
//    below PAD_POS) and every tile it could walk (one warp per tile), and
//    classes each (q tile, kv tile) pair by the forward kernel's rules:
//    closed (never loaded: no pair of it is open, so it adds exactly 0),
//    open (no per-element mask), or partial. The plain twin of the rules is
//    fwd_tile_plan(..., bq=BWD_BQ, bk=BWD_BK) in ops/flash_attention.py,
//    held to the reference's masks on the CPU. Inside a tile a warp also
//    skips it when none of its 16 rows (K2) or keys (K3) can see it. Every
//    block adds the pairs it left to compute and the open ones to device
//    counters (K3 once per query head it walks), which
//    flash_bwd_tile_counts reads: the card's classes are held to the twin.
// 4. A two-stage cp.async ring for the streamed operand: in K2 K, V and the
//    keys' positions and segment ids of the next non-closed kv tile; in K3
//    Q, dO and the rows' positions, segment ids, lse and delta of the next
//    non-closed (query head, q tile). 16-byte cp.async.cg for the tiles
//    (rows past the edge zero-filled by the src-size 0 form), 4-byte
//    cp.async.ca for the per-row words; keys past sk are stored at PAD_POS,
//    rows past sq as not live with lse 0 and delta 0. commit_group,
//    wait_group 1: the next tile is in flight while the current computes.
//
// What bounds it. On the pairs P the masks leave open, K2 does 6 d h P
// operations (S, dP, dQ) and K3 8 d h P (S, dP, dV, dK), against O(d) bytes
// per row and key: at training lengths far above the card's ~295
// operations per byte, so both are bound by operations, and the tensor
// cores are the only way to the bf16 peak. mma.sync reaches a fraction of
// it; wgmma with TMA-fed, warp-specialised pipelines is later work.
//
// Registers and shared memory: 128-thread blocks, two per SM at d=64 and
// d=128 (__launch_bounds__(128, 2)). K2 holds Q and dO fragments (64
// registers at d=128) and 64 dq accumulators; K3 holds 128 dk/dv
// accumulators and reloads K and V fragments from shared memory per
// 32-query chunk. The -Xptxas -v report of the H100 build (chip_smoke.py
// prints it): K2 239 registers at d=128 and 156 at d=64, K3 250 and 186,
// no spills. Shared memory per block: K2 Q, dO and two K/V stages, (2 * 64
// + 4 * 64) rows of D + 8 bf16 (104448 bytes at d=128, 55296 at d=64), 1
// KB of key positions and segment ids, 5 bytes per kv tile for the
// classes; K3 K, V and two Q/dO stages (the same 104448 / 55296 bytes), 2
// KB of row words, 5 bytes per q tile. Shared memory, not registers, holds
// it at two blocks (eight warps) per SM.
//
// At d=256 (gemma) the same layout takes 202752 bytes a block, so both
// kernels run one block per SM (MIN_BLOCKS, __launch_bounds__(128, 1)).
// Registers, not shared memory, are what the design has to answer there:
// a thread's dq accumulators alone are 16 rows x 256 / 32 lanes = 128 f32,
// and the Q and dO fragments held at d=128 would add 128 more, so K2
// reloads those fragments from shared memory per 16-key chunk by ldmatrix
// (two x4 loads per 16-deep step). K3's dk and dv for a warp's 16 keys
// over the whole head_dim would be 256 f32 a thread, the register file's
// limit on its own, and mma's 16-row grain keeps a warp from owning fewer
// keys. So at d=256 K3 splits the head_dim across blocks (DSPLIT = 2;
// grid z is kv tiles x 2): each block recomputes S^T and dP^T over the
// full 256 and accumulates dK and dV for its 128 columns, holding the 128
// accumulators of d=128. That is 12 d h P operations where 8 are needed
// (1.5x), and it doubles the grid of a thin MQA layout (gemma-2b's 8/1 at
// 2 x 2048: 64 blocks become 128 on 132 SMs). Only the first half of each
// kv tile counts tiles, so flash_bwd_tile_counts reads the same counts as
// at d=128. The other design, eight warps a block with one warp of each
// pair holding dV and the other dK and P^T / dS^T exchanged through
// shared memory, does no extra work but needs named barriers between warp
// pairs and ~211 KB a block; the split keeps each warp's code that of
// d<=128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 64;          // query rows per q tile (ops: BWD_BQ)
constexpr int BK = 64;          // keys per kv tile (ops: BWD_BK)
constexpr int SKIP_ROWS = 64;   // row grain of the causal block skip (ops: TILE)
constexpr int NWARPS = 4;       // 16 query rows (K2) or keys (K3) per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr int QC = 32;          // queries per inner chunk of K3
// With one skip group per q tile, the block skip closes whole tiles: K2
// stops at its diagonal kv tile and K3 starts at its diagonal q tile.
static_assert(BQ == SKIP_ROWS && BK == SKIP_ROWS, "tiles are skip groups");

// Blocks per SM the register budget is set for: two at d <= 128, one at
// d=256 (its dq accumulators alone take 128 registers a thread).
template <int D>
constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;
// K2 at d=256 reloads the Q and dO fragments per 16-key chunk from shared
// memory instead of holding all of them in registers.
template <int D>
constexpr bool RELOAD_Q = D > 128;
// K3's blocks per kv tile, each accumulating dK and dV for D / DSPLIT
// columns of the head_dim.
template <int D>
constexpr int DSPLIT = D > 128 ? 2 : 1;

// (q tile, kv tile) pairs the launches left to compute ([0] K2, [2] K3,
// once per query head) and the open ones of those ([1], [3]), summed over
// blocks; flash_bwd_tile_counts reads and clears them.
__device__ unsigned long long tile_counts[4];

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;     // [b, h, sq] contiguous
  const float* delta;   // [b, h, sq] contiguous
  void* dq;             // [b, sq, h, d] contiguous, bf16 or f32
  void* dk;             // [b, sk, kvh, d] contiguous, bf16 or f32
  void* dv;
  const int* q_pos;     // [b, sq] contiguous
  const int* kv_pos;    // [b, sk] contiguous
  const int* q_seg;     // [b, sq] or null
  const int* kv_seg;    // [b, sk] or null
  int b, sq, sk, h, kvh;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;   // strides of dout
  float scale;
  int causal;
  int block_skip;
  int out_f32;
  int n_tiles;          // tiles a block classes: kv tiles (K2), q tiles (K3)
};

// The A fragment of the 16 rows from r0 (row stride LD) at columns c0..c0+15:
// lanes 0-15 address the rows at c0, lanes 16-31 the same rows at c0 + 8.
template <int LD>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const __nv_bfloat16* r0,
                                     int c0, int lane) {
  ldmatrix_x4(a, r0 + (lane & 15) * LD + c0 + (lane >> 4) * 8);
}

// The B fragments of the products X Y^T for rows y0..y0+15 of a row-major Y
// (n = those rows, k = columns c0..c0+15): b[0], b[1] for rows y0..y0+7,
// b[2], b[3] for y0+8..y0+15. Lanes 0-7 address rows y0.. at c0, lanes
// 8-15 the same rows at c0 + 8, lanes 16-31 rows y0 + 8.. likewise.
template <int LD>
__device__ __forceinline__ void ld_b(uint32_t (&b)[4], const __nv_bfloat16* y0,
                                     int c0, int lane) {
  ldmatrix_x4(b, y0 + ((lane & 7) + (lane >> 4) * 8) * LD + c0 +
                     ((lane >> 3) & 1) * 8);
}

// The B fragments of the products A X for rows x0..x0+15 of a row-major X
// (k = those rows, n = columns c0..c0+15): b[0], b[1] for columns c0..c0+7,
// b[2], b[3] for c0+8..c0+15. Lanes 0-15 address the rows at c0, lanes
// 16-31 the same rows at c0 + 8.
template <int LD>
__device__ __forceinline__ void ld_b_trans(uint32_t (&b)[4],
                                           const __nv_bfloat16* x0, int c0,
                                           int lane) {
  ldmatrix_x4_trans(b, x0 + (lane & 15) * LD + c0 + (lane >> 4) * 8);
}

// The accumulators of two adjacent n-tiles (a 16x16 block) as an A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x0)[4],
                                         const float (&x1)[4]) {
  a[0] = pack_bf16(x0[0], x0[1]);
  a[1] = pack_bf16(x0[2], x0[3]);
  a[2] = pack_bf16(x1[0], x1[1]);
  a[3] = pack_bf16(x1[2], x1[3]);
}

// Store two adjacent values of a gradient row as bf16 or f32.
__device__ __forceinline__ void store_pair(void* base, long long idx, float x0,
                                           float x1, int out_f32) {
  if (out_f32) {
    *reinterpret_cast<float2*>(static_cast<float*>(base) + idx) = make_float2(x0, x1);
  } else {
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(base) + idx) =
        pack_bf16(x0, x1);
  }
}

// Positions and segment ids of a tile's live rows or valid keys, reduced
// over one warp: their min and max, whether any is live (valid), and
// whether all are.
struct Summary {
  int pmin, pmax, smin, smax;
  bool any, all;
};

__device__ __forceinline__ Summary reduce_summary(int pmin, int pmax, int smin,
                                                  int smax, bool any, bool all) {
  Summary s;
  s.any = __any_sync(FULL, any);
  s.all = __all_sync(FULL, all);
  s.pmin = warp_min(pmin);
  s.pmax = warp_max(pmax);
  s.smin = warp_min(smin);
  s.smax = warp_max(smax);
  return s;
}

// The q tile at q0 of batch row bi: its live rows are those below sq and
// not in segment 0; all means every row below sq is live.
__device__ __forceinline__ Summary summarize_rows(const Params& p, int bi,
                                                  int q0, int lane) {
  const bool use_seg = p.q_seg != nullptr;
  const long long row0 = static_cast<long long>(bi) * p.sq;
  int pmin = INT_MAX, pmax = INT_MIN, smin = INT_MAX, smax = INT_MIN;
  bool any = false, all = true;
  for (int r = lane; r < BQ && q0 + r < p.sq; r += 32) {
    const long long idx = row0 + q0 + r;
    const int qs = use_seg ? p.q_seg[idx] : 1;
    if (qs == 0) {
      all = false;
      continue;
    }
    const int qp = p.q_pos[idx];
    any = true;
    pmin = min(pmin, qp);
    pmax = max(pmax, qp);
    smin = min(smin, qs);
    smax = max(smax, qs);
  }
  return reduce_summary(pmin, pmax, smin, smax, any, all);
}

// The kv tile at k0 of batch row bi: its valid keys are those below sk and
// below PAD_POS; all means every key of the tile is valid.
__device__ __forceinline__ Summary summarize_keys(const Params& p, int bi,
                                                  int k0, int lane) {
  const bool use_seg = p.kv_seg != nullptr;
  const long long key0 = static_cast<long long>(bi) * p.sk;
  int pmin = INT_MAX, pmax = INT_MIN, smin = INT_MAX, smax = INT_MIN;
  bool any = false, all = true;
#pragma unroll
  for (int j = lane; j < BK; j += 32) {
    const int key = k0 + j;
    bool valid = false;
    if (key < p.sk) {
      const int kp = p.kv_pos[key0 + key];
      valid = kp < PAD_POS;
      if (valid) {
        pmin = min(pmin, kp);
        pmax = max(pmax, kp);
        if (use_seg) {
          const int ks = p.kv_seg[key0 + key];
          smin = min(smin, ks);
          smax = max(smax, ks);
        }
      }
    }
    any = any || valid;
    all = all && valid;
  }
  return reduce_summary(pmin, pmax, smin, smax, any, all);
}

// The class of the pair (q tile at q0, kv tile at k0) by the rules of
// ops/flash_attention.fwd_tile_plan, for a pair the block skip leaves.
__device__ __forceinline__ unsigned char tile_class(const Params& p,
                                                    const Summary& q,
                                                    const Summary& k, int q0,
                                                    int k0) {
  const bool use_seg = p.q_seg != nullptr;
  if (!k.any || !q.any) return CLOSED;
  if (p.causal && k.pmin > q.pmax) return CLOSED;
  if (use_seg && ((k.smin == 0 && k.smax == 0) || k.smax < q.smin ||
                  k.smin > q.smax))
    return CLOSED;
  bool open = k.all && q.all;
  if (p.causal) open = open && k.pmax <= q.pmin;
  if (use_seg) open = open && k.smin == k.smax && q.smin == q.smax && k.smin == q.smin;
  if (p.block_skip) open = open && k0 + BK <= (q0 / SKIP_ROWS + 1) * SKIP_ROWS;
  return open ? OPEN : PARTIAL;
}

// Warp 0 adds the tiles from `first` on that the block computed (times
// reps) and the open ones to tile_counts[slot], [slot + 1].
__device__ __forceinline__ void count_tiles(const unsigned char* cls, int first,
                                            int n, unsigned reps, int slot) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned computed = 0, opened = 0;
  for (int i = first + lane; i < n; i += 32) {
    computed += cls[i] != CLOSED;
    opened += cls[i] == OPEN;
  }
  computed = __reduce_add_sync(FULL, computed);
  opened = __reduce_add_sync(FULL, opened);
  if (lane == 0 && computed != 0) {
    atomicAdd(&tile_counts[slot], static_cast<unsigned long long>(computed) * reps);
    atomicAdd(&tile_counts[slot + 1], static_cast<unsigned long long>(opened) * reps);
  }
}

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS<D>)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 8;          // padded row length in shared memory
  constexpr int CHUNKS = D / 8;      // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;     // mma depth steps over head_dim
  constexpr int NT_O = D / 8;        // n-tiles of dQ per warp
  constexpr int KF = RELOAD_Q<D> ? 1 : KSTEPS;   // Q/dO fragments held
  constexpr int STAGE = BK * LD;     // elements of one K or V stage

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + BQ * LD;
  __nv_bfloat16* sK = sdO + BQ * LD;                      // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * STAGE;                     // [2][BK][LD]
  int* sKpos = reinterpret_cast<int*>(sV + 2 * STAGE);    // [2][BK]
  int* sKseg = sKpos + 2 * BK;                            // [2][BK]
  int* sKmin = sKseg + 2 * BK;                            // [n_tiles]
  unsigned char* sClass = reinterpret_cast<unsigned char*>(sKmin + p.n_tiles);

  const int num_q = (p.sq + BQ - 1) / BQ;
  const int q0 = (num_q - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const int hq = blockIdx.x;
  const int bi = blockIdx.y;
  const int hk = hq / (p.h / p.kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;           // row within the 8-row group
  const int t = lane & 3;            // thread within the quad
  const bool use_seg = p.q_seg != nullptr;
  const long long qrow0 = static_cast<long long>(bi) * p.sq;
  const long long krow0 = static_cast<long long>(bi) * p.sk;

  // Class every kv tile the block skip leaves, one warp per tile.
  const Summary qsum = summarize_rows(p, bi, q0, lane);
  const int kv_end = p.block_skip ? min(p.sk, q0 + BQ) : p.sk;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = warp; kt < n_kt; kt += NWARPS) {
    const Summary ksum = summarize_keys(p, bi, kt * BK, lane);
    if (lane == 0) {
      sClass[kt] = tile_class(p, qsum, ksum, q0, kt * BK);
      sKmin[kt] = ksum.pmin;
    }
  }

  // This thread's rows g and g + 8 of the warp; rows past sq and rows in
  // segment 0 are not live. The row term of p is lse log2 e.
  int qpos[2], qseg[2];
  bool live[2];
  float lse2[2], delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 16 + g + rr * 8;
    const bool in = row < p.sq;
    const long long li = (static_cast<long long>(bi) * p.h + hq) * p.sq + row;
    qseg[rr] = in ? (use_seg ? p.q_seg[qrow0 + row] : 1) : 0;
    live[rr] = qseg[rr] != 0;
    qpos[rr] = in ? p.q_pos[qrow0 + row] : 0;
    const float l = in ? p.lse[li] : 0.f;
    lse2[rr] = (l <= NEG_INF ? 0.f : l) * LOG2E;
    delta[rr] = in ? p.delta[li] : 0.f;
  }
  // The warp skips a tile none of its rows can see: no live row, or every
  // valid key after its last live position.
  const bool w_live = __any_sync(FULL, live[0] || live[1]);
  const int w_hi = warp_max(max(live[0] ? qpos[0] : INT_MIN,
                                live[1] ? qpos[1] : INT_MIN));
  const float sl2 = p.scale * LOG2E;
  __syncthreads();   // the classes are in shared memory

  auto next_tile = [&](int kt) {
    ++kt;
    while (kt < n_kt && sClass[kt] == CLOSED) ++kt;
    return kt;
  };
  // One K/V tile and its keys' positions and segment ids into a stage:
  // thread tid copies the 16-byte chunk tid % CHUNKS of rows tid / CHUNKS,
  // + NTHREADS / CHUNKS, ...
  auto load_kv = [&](int kt, int stage) {
    constexpr int ROWS = NTHREADS / CHUNKS;
    const int k0 = kt * BK;
    const int r0 = tid / CHUNKS, c = (tid % CHUNKS) * 8;
    const __nv_bfloat16* kb = p.k + bi * p.k_sb + hk * p.k_sh + c;
    const __nv_bfloat16* vb = p.v + bi * p.v_sb + hk * p.v_sh + c;
    __nv_bfloat16* dK = sK + stage * STAGE + r0 * LD + c;
    __nv_bfloat16* dV = sV + stage * STAGE + r0 * LD + c;
#pragma unroll
    for (int it = 0; it < BK / ROWS; ++it) {
      const int r = r0 + it * ROWS;
      const bool in = k0 + r < p.sk;
      const long long key = in ? k0 + r : p.sk - 1;
      cp_async16(dK + it * ROWS * LD, kb + key * p.k_ss, in);
      cp_async16(dV + it * ROWS * LD, vb + key * p.v_ss, in);
    }
    if (tid < BK) {
      int* dst = sKpos + stage * BK + tid;
      if (k0 + tid < p.sk) cp_async4(dst, p.kv_pos + krow0 + k0 + tid);
      else *dst = PAD_POS;
    } else if (tid < 2 * BK) {
      const int j = tid - BK;
      int* dst = sKseg + stage * BK + j;
      if (use_seg && k0 + j < p.sk) cp_async4(dst, p.kv_seg + krow0 + k0 + j);
      else *dst = 0;
    }
  };

  float dq[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  int kt = next_tile(-1);
  if (kt < n_kt) {
    // Q and dO travel with the first kv tile.
    const __nv_bfloat16* qbase = p.q + bi * p.q_sb + hq * p.q_sh;
    const __nv_bfloat16* obase = p.dout + bi * p.o_sb + hq * p.o_sh;
    for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const bool in = q0 + r < p.sq;
      const long long row = in ? q0 + r : p.sq - 1;
      cp_async16(sQ + r * LD + c, qbase + row * p.q_ss + c, in);
      cp_async16(sdO + r * LD + c, obase + row * p.o_ss + c, in);
    }
    load_kv(kt, 0);
    cp_async_commit();
    int kn = next_tile(kt);
    if (kn < n_kt) load_kv(kn, 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    uint32_t qf[KF][4], dof[KF][4];
    if constexpr (!RELOAD_Q<D>) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        ld_a<LD>(qf[kk], sQ + warp * 16 * LD, kk * 16, lane);
        ld_a<LD>(dof[kk], sdO + warp * 16 * LD, kk * 16, lane);
      }
    }

    int stage = 0;
    while (true) {
      const bool skip = !w_live || (p.causal && sKmin[kt] > w_hi);
      if (!skip) {
        const __nv_bfloat16* tK = sK + stage * STAGE;
        const __nv_bfloat16* tV = sV + stage * STAGE;
        const int* tp = sKpos + stage * BK;
        const int* ts = sKseg + stage * BK;
        const bool open = sClass[kt] == OPEN;
#pragma unroll
        for (int c = 0; c < BK / 16; ++c) {
          // S = Q K^T and dP = dO V^T for this warp's 16 rows x 16 keys.
          float s[2][4], dp[2][4];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
            dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
          }
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            const int f = RELOAD_Q<D> ? 0 : kk;
            if constexpr (RELOAD_Q<D>) {
              ld_a<LD>(qf[0], sQ + warp * 16 * LD, kk * 16, lane);
              ld_a<LD>(dof[0], sdO + warp * 16 * LD, kk * 16, lane);
            }
            uint32_t b[4];
            ld_b<LD>(b, tK + c * 16 * LD, kk * 16, lane);
            mma_16816(s[0], qf[f], b[0], b[1]);
            mma_16816(s[1], qf[f], b[2], b[3]);
            ld_b<LD>(b, tV + c * 16 * LD, kk * 16, lane);
            mma_16816(dp[0], dof[f], b[0], b[1]);
            mma_16816(dp[1], dof[f], b[2], b[3]);
          }
          // Element e sits at row g + 8 (e >> 1), key c*16 + j*8 + 2t + (e & 1);
          // s becomes ds.
          if (open) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int rr = e >> 1;
                const float pv = ex2(fmaf(s[j][e], sl2, -lse2[rr]));
                s[j][e] = pv * (dp[j][e] - delta[rr]) * p.scale;
              }
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int col = c * 16 + j * 8 + 2 * t;
              const int2 kp = *reinterpret_cast<const int2*>(tp + col);
              const int2 ks = *reinterpret_cast<const int2*>(ts + col);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int rr = e >> 1;
                const int kpe = (e & 1) ? kp.y : kp.x;
                const int kse = (e & 1) ? ks.y : ks.x;
                bool ok = live[rr] && kpe < PAD_POS;
                if (p.causal) ok = ok && kpe <= qpos[rr];
                if (use_seg) ok = ok && kse == qseg[rr];
                const float pv = ok ? ex2(fmaf(s[j][e], sl2, -lse2[rr])) : 0.f;
                s[j][e] = ok ? pv * (dp[j][e] - delta[rr]) * p.scale : 0.f;
              }
            }
          }
          // dQ += dS K: one ldmatrix.x4.trans gives the K B fragments of
          // n-tiles n and n + 1.
          uint32_t a[4];
          acc_to_a(a, s[0], s[1]);
#pragma unroll
          for (int n = 0; n < NT_O; n += 2) {
            uint32_t b[4];
            ld_b_trans<LD>(b, tK + c * 16 * LD, n * 8, lane);
            mma_16816(dq[n], a, b[0], b[1]);
            mma_16816(dq[n + 1], a, b[2], b[3]);
          }
        }
      }

      kt = kn;
      if (kt >= n_kt) break;
      __syncthreads();   // every warp is done with this stage: refill it
      kn = next_tile(kt);
      if (kn < n_kt) load_kv(kn, stage);
      cp_async_commit();
      stage ^= 1;
      cp_async_wait<1>();
      __syncthreads();   // tile kt has landed
    }
  }

  // Every row below sq is written; rows that saw no key get exactly 0.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = q0 + warp * 16 + g + rr * 8;
    if (row >= p.sq) continue;
    const long long base = ((qrow0 + row) * p.h + hq) * D;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      store_pair(p.dq, base + n * 8 + 2 * t, dq[n][2 * rr], dq[n][2 * rr + 1], p.out_f32);
  }
  count_tiles(sClass, 0, n_kt, 1, 0);
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS<D>)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;
  constexpr int KSTEPS = D / 16;
  constexpr int DO = D / DSPLIT<D>;  // dK and dV columns this block sums
  constexpr int NT_O = DO / 8;       // n-tiles of dK and dV per warp
  constexpr int NJ = QC / 8;         // n-tiles of S^T per chunk
  constexpr int STAGE = BQ * LD;     // elements of one Q or dO stage

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BK * LD;
  __nv_bfloat16* sQ = sV + BK * LD;                       // [2][BQ][LD]
  __nv_bfloat16* sdO = sQ + 2 * STAGE;                    // [2][BQ][LD]
  int* sQpos = reinterpret_cast<int*>(sdO + 2 * STAGE);   // [2][BQ]
  int* sQseg = sQpos + 2 * BQ;                            // [2][BQ], 0: not live
  float* sLse = reinterpret_cast<float*>(sQseg + 2 * BQ); // [2][BQ]
  float* sDelta = sLse + 2 * BQ;                          // [2][BQ]
  int* sQmax = reinterpret_cast<int*>(sDelta + 2 * BQ);   // [n_tiles]
  unsigned char* sClass = reinterpret_cast<unsigned char*>(sQmax + p.n_tiles);

  const int kt = blockIdx.z / DSPLIT<D>;
  const int c_out = (blockIdx.z % DSPLIT<D>) * DO;   // its first column
  const int k0 = kt * BK;
  const int hk = blockIdx.x;
  const int bi = blockIdx.y;
  const int n_rep = p.h / p.kvh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool use_seg = p.q_seg != nullptr;
  const long long qrow0 = static_cast<long long>(bi) * p.sq;
  const long long krow0 = static_cast<long long>(bi) * p.sk;

  // Class every q tile the block skip leaves (from the diagonal on), one
  // warp per tile.
  const Summary ksum = summarize_keys(p, bi, k0, lane);
  const int num_q = (p.sq + BQ - 1) / BQ;
  const int qt_begin = p.block_skip ? kt : 0;
  for (int qt = qt_begin + warp; qt < num_q; qt += NWARPS) {
    const Summary qsum = summarize_rows(p, bi, qt * BQ, lane);
    if (lane == 0) {
      sClass[qt] = tile_class(p, qsum, ksum, qt * BQ, k0);
      sQmax[qt] = qsum.pmax;
    }
  }

  // This thread's keys warp*16 + g and + 8; keys past sk sit at PAD_POS.
  int kpos[2], kseg[2];
  bool kvalid[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + warp * 16 + g + rr * 8;
    const bool in = key < p.sk;
    kpos[rr] = in ? p.kv_pos[krow0 + key] : PAD_POS;
    kseg[rr] = (in && use_seg) ? p.kv_seg[krow0 + key] : 0;
    kvalid[rr] = kpos[rr] < PAD_POS;
  }
  // The warp skips a q tile none of its keys is seen by: no valid key, or
  // every valid key after the tile's last live position.
  const bool w_valid = __any_sync(FULL, kvalid[0] || kvalid[1]);
  const int w_lo = warp_min(min(kvalid[0] ? kpos[0] : INT_MAX,
                                kvalid[1] ? kpos[1] : INT_MAX));
  const float sl2 = p.scale * LOG2E;
  __syncthreads();   // the classes are in shared memory

  auto next_q = [&](int qt) {
    ++qt;
    while (qt < num_q && sClass[qt] == CLOSED) ++qt;
    return qt;
  };
  // One Q/dO tile of query head hk * n_rep + hr and its rows' positions,
  // segment ids (1 without segments; 0 for rows past sq), lse and delta
  // (0 past sq) into a stage.
  auto load_q = [&](int hr, int qt, int stage) {
    constexpr int ROWS = NTHREADS / CHUNKS;
    const int hq = hk * n_rep + hr;
    const int q0 = qt * BQ;
    const int r0 = tid / CHUNKS, c = (tid % CHUNKS) * 8;
    const __nv_bfloat16* qb = p.q + bi * p.q_sb + hq * p.q_sh + c;
    const __nv_bfloat16* ob = p.dout + bi * p.o_sb + hq * p.o_sh + c;
    __nv_bfloat16* dQ = sQ + stage * STAGE + r0 * LD + c;
    __nv_bfloat16* dO = sdO + stage * STAGE + r0 * LD + c;
#pragma unroll
    for (int it = 0; it < BQ / ROWS; ++it) {
      const int r = r0 + it * ROWS;
      const bool in = q0 + r < p.sq;
      const long long row = in ? q0 + r : p.sq - 1;
      cp_async16(dQ + it * ROWS * LD, qb + row * p.q_ss, in);
      cp_async16(dO + it * ROWS * LD, ob + row * p.o_ss, in);
    }
    const int i = tid < BQ ? tid : tid - BQ;
    const int row = q0 + i;
    const bool in = row < p.sq;
    const long long li = (static_cast<long long>(bi) * p.h + hq) * p.sq + row;
    if (tid < BQ) {
      int* dpos = sQpos + stage * BQ + i;
      float* dl = sLse + stage * BQ + i;
      if (in) {
        cp_async4(dpos, p.q_pos + qrow0 + row);
        cp_async4(dl, p.lse + li);
      } else {
        *dpos = 0;
        *dl = 0.f;
      }
    } else {
      int* dseg = sQseg + stage * BQ + i;
      float* dd = sDelta + stage * BQ + i;
      if (in) {
        if (use_seg) cp_async4(dseg, p.q_seg + qrow0 + row);
        else *dseg = 1;
        cp_async4(dd, p.delta + li);
      } else {
        *dseg = 0;
        *dd = 0.f;
      }
    }
  };

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  // The walk: query heads hr = 0..n_rep-1, each over the non-closed q tiles
  // from the first (qt_first) on.
  const int qt_first = next_q(qt_begin - 1);
  if (qt_first < num_q) {
    // K and V travel with the first q tile.
    const __nv_bfloat16* kbase = p.k + bi * p.k_sb + hk * p.k_sh;
    const __nv_bfloat16* vbase = p.v + bi * p.v_sb + hk * p.v_sh;
    for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const bool in = k0 + r < p.sk;
      const long long key = in ? k0 + r : p.sk - 1;
      cp_async16(sK + r * LD + c, kbase + key * p.k_ss + c, in);
      cp_async16(sV + r * LD + c, vbase + key * p.v_ss + c, in);
    }
    int hr = 0, qt = qt_first;
    load_q(hr, qt, 0);
    cp_async_commit();
    int hn = hr, qn = next_q(qt);
    if (qn >= num_q) {
      ++hn;
      qn = qt_first;
    }
    if (hn < n_rep) load_q(hn, qn, 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    int stage = 0;
    while (true) {
      const bool skip = !w_valid || (p.causal && w_lo > sQmax[qt]);
      if (!skip) {
        const __nv_bfloat16* tQ = sQ + stage * STAGE;
        const __nv_bfloat16* tdO = sdO + stage * STAGE;
        const int* tpos = sQpos + stage * BQ;
        const int* tseg = sQseg + stage * BQ;
        const float* tlse = sLse + stage * BQ;
        const float* tdelta = sDelta + stage * BQ;
        const bool open = sClass[qt] == OPEN;
#pragma unroll
        for (int ch = 0; ch < BQ / QC; ++ch) {
          // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x QC queries.
          float s[NJ][4], dp[NJ][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
            dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
          }
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t ka[4], va[4];
            ld_a<LD>(ka, sK + warp * 16 * LD, kk * 16, lane);
            ld_a<LD>(va, sV + warp * 16 * LD, kk * 16, lane);
#pragma unroll
            for (int jp = 0; jp < NJ / 2; ++jp) {
              uint32_t b[4];
              ld_b<LD>(b, tQ + (ch * QC + jp * 16) * LD, kk * 16, lane);
              mma_16816(s[2 * jp], ka, b[0], b[1]);
              mma_16816(s[2 * jp + 1], ka, b[2], b[3]);
              ld_b<LD>(b, tdO + (ch * QC + jp * 16) * LD, kk * 16, lane);
              mma_16816(dp[2 * jp], va, b[0], b[1]);
              mma_16816(dp[2 * jp + 1], va, b[2], b[3]);
            }
          }
          // Element e sits at key row g + 8 (e >> 1), query
          // ch*QC + j*8 + 2t + (e & 1); s becomes p and dp becomes ds.
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int col = ch * QC + j * 8 + 2 * t;
            const float2 l = *reinterpret_cast<const float2*>(tlse + col);
            const float2 dl = *reinterpret_cast<const float2*>(tdelta + col);
            const float lg[2] = {(l.x <= NEG_INF ? 0.f : l.x) * LOG2E,
                                 (l.y <= NEG_INF ? 0.f : l.y) * LOG2E};
            const float dd[2] = {dl.x, dl.y};
            if (open) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int cc = e & 1;
                const float pv = ex2(fmaf(s[j][e], sl2, -lg[cc]));
                dp[j][e] = pv * (dp[j][e] - dd[cc]) * p.scale;
                s[j][e] = pv;
              }
            } else {
              const int2 qp = *reinterpret_cast<const int2*>(tpos + col);
              const int2 qs = *reinterpret_cast<const int2*>(tseg + col);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int rr = e >> 1, cc = e & 1;
                const int qpe = cc ? qp.y : qp.x;
                const int qse = cc ? qs.y : qs.x;
                bool ok = kvalid[rr] && qse != 0;
                if (p.causal) ok = ok && kpos[rr] <= qpe;
                if (use_seg) ok = ok && kseg[rr] == qse;
                const float pv = ok ? ex2(fmaf(s[j][e], sl2, -lg[cc])) : 0.f;
                dp[j][e] = ok ? pv * (dp[j][e] - dd[cc]) * p.scale : 0.f;
                s[j][e] = pv;
              }
            }
          }
          // dV += P^T dO and dK += dS^T Q, 16 queries at a time: one
          // ldmatrix.x4.trans gives the B fragments of n-tiles n and n + 1.
#pragma unroll
          for (int c2 = 0; c2 < QC / 16; ++c2) {
            uint32_t ap[4], ads[4];
            acc_to_a(ap, s[2 * c2], s[2 * c2 + 1]);
            acc_to_a(ads, dp[2 * c2], dp[2 * c2 + 1]);
            const int r = ch * QC + c2 * 16;
#pragma unroll
            for (int n = 0; n < NT_O; n += 2) {
              uint32_t b[4];
              ld_b_trans<LD>(b, tdO + r * LD, c_out + n * 8, lane);
              mma_16816(dv[n], ap, b[0], b[1]);
              mma_16816(dv[n + 1], ap, b[2], b[3]);
              ld_b_trans<LD>(b, tQ + r * LD, c_out + n * 8, lane);
              mma_16816(dk[n], ads, b[0], b[1]);
              mma_16816(dk[n + 1], ads, b[2], b[3]);
            }
          }
        }
      }

      hr = hn;
      qt = qn;
      if (hr >= n_rep) break;
      __syncthreads();   // every warp is done with this stage: refill it
      qn = next_q(qt);
      if (qn >= num_q) {
        ++hn;
        qn = qt_first;
      }
      if (hn < n_rep) load_q(hn, qn, stage);
      cp_async_commit();
      stage ^= 1;
      cp_async_wait<1>();
      __syncthreads();   // (hr, qt) has landed
    }
  }

  // Every key below sk is written (each block its columns); keys no query
  // sees get exactly 0.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = k0 + warp * 16 + g + rr * 8;
    if (key >= p.sk) continue;
    const long long base = ((krow0 + key) * p.kvh + hk) * D + c_out;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      store_pair(p.dk, base + n * 8 + 2 * t, dk[n][2 * rr], dk[n][2 * rr + 1], p.out_f32);
      store_pair(p.dv, base + n * 8 + 2 * t, dv[n][2 * rr], dv[n][2 * rr + 1], p.out_f32);
    }
  }
  // One block of each kv tile counts its pairs.
  if (c_out == 0) count_tiles(sClass, qt_begin, num_q, n_rep, 2);
}

template <int D>
cudaError_t launch_dq(Params p, cudaStream_t stream) {
  constexpr int LD = D + 8;
  p.n_tiles = (p.sk + BK - 1) / BK;
  const size_t smem = static_cast<size_t>(2 * BQ + 4 * BK) * LD * sizeof(__nv_bfloat16) +
                      4 * BK * sizeof(int) +
                      static_cast<size_t>(p.n_tiles) * (sizeof(int) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.h, p.b, (p.sq + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(Params p, cudaStream_t stream) {
  constexpr int LD = D + 8;
  p.n_tiles = (p.sq + BQ - 1) / BQ;
  const size_t smem = static_cast<size_t>(2 * BK + 4 * BQ) * LD * sizeof(__nv_bfloat16) +
                      8 * BQ * sizeof(int) +
                      static_cast<size_t>(p.n_tiles) * (sizeof(int) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int z = (p.sk + BK - 1) / BK * DSPLIT<D>;
  if (z > 65535) return cudaErrorInvalidValue;
  const dim3 grid(p.kvh, p.b, z);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Fill Params from the plain C arguments; false on arguments no launch takes.
bool make_params(Params& p, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, const void* q_pos,
                 const void* kv_pos, const void* q_seg, const void* kv_seg,
                 int b, int sq, int sk, int h, int kvh,
                 long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_ss, long long o_sh,
                 float scale, int causal, int block_skip, int out_f32) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 ||
      b > 65535 || (sq + BQ - 1) / BQ > 65535 || (sk + BK - 1) / BK > 65535 ||
      (q_seg == nullptr) != (kv_seg == nullptr) || (block_skip && sq != sk))
    return false;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.q_seg = static_cast<const int*>(q_seg);
  p.kv_seg = static_cast<const int*>(kv_seg);
  p.b = b; p.sq = sq; p.sk = sk; p.h = h; p.kvh = kvh;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  p.causal = causal;
  p.block_skip = block_skip;
  p.out_f32 = out_f32;
  p.n_tiles = 0;
  return true;
}

}  // namespace

// Plain C entry points, bound with ctypes. Input strides are in elements;
// the caller guarantees a unit last stride, 16-byte aligned bases and row
// strides that are multiples of 8 elements, and contiguous lse, delta,
// positions, segment ids and outputs. Each returns a cudaError_t.
extern "C" int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* q_pos,
    const void* kv_pos, const void* q_seg, const void* kv_seg,
    int b, int sq, int sk, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int block_skip, int out_f32, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, dq, nullptr, nullptr, q_pos,
                   kv_pos, q_seg, kv_seg, b, sq, sk, h, kvh, q_sb, q_ss, q_sh,
                   k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale,
                   causal, block_skip, out_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_dq<64>(p, s));
    case 128: return static_cast<int>(launch_dq<128>(p, s));
    case 256: return static_cast<int>(launch_dq<256>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, const void* q_pos,
    const void* kv_pos, const void* q_seg, const void* kv_seg,
    int b, int sq, int sk, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int block_skip, int out_f32, void* stream) {
  Params p;
  if (!make_params(p, q, k, v, dout, lse, delta, nullptr, dk, dv, q_pos,
                   kv_pos, q_seg, kv_seg, b, sq, sk, h, kvh, q_sb, q_ss, q_sh,
                   k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale,
                   causal, block_skip, out_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_dkv<64>(p, s));
    case 128: return static_cast<int>(launch_dkv<128>(p, s));
    case 256: return static_cast<int>(launch_dkv<256>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0], out[1]: the (q tile, kv tile) pairs K2's launches since the last
// call left to compute and, of those, the open ones; out[2], out[3] the
// same for K3, once per query head; summed over blocks, once the device is
// idle. Then clears them. Returns a cudaError_t.
extern "C" int flash_bwd_tile_counts(unsigned long long* out) {
  static const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, tile_counts, sizeof(tile_counts));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(tile_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
