// Flash attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the Pallas TPU kernel runbooks_tpu/ops/flash_attention.py
// _fwd_kernel (launched by _flash_fwd). Same contract: layout [b, s, h, d];
// GQA by kv head h / n_rep read through strides, never repeated; masking by
// absolute position (kv_pos >= PAD_POS masked, causal kv_pos <= q_pos,
// segments q_seg == kv_seg and kv_seg != 0); f32 online softmax with the
// NEG_INF guards of the reference; out = acc / l (0 on a fully masked row),
// lse = m + log l in natural-log units (NEG_INF on a fully masked row), lse
// [b, h, sq] f32; the causal block skip by storage index in 64-row groups.
//
// Design: FlashAttention-2 on cp.async and mma.sync. One thread block owns
// one (q head, batch row, 128-row q tile); eight warps own 16 query rows
// each and keep (m, l, acc) in registers. The block walks 64-key kv tiles.
//
// - Tile classes. First the block summarises its q tile (min/max position
//   and segment over its live rows: rows below sq, not in segment 0) and
//   each kv tile (min/max position and segment over its valid keys: keys
//   below sk and below PAD_POS; whether any and all keys are valid), by
//   warp reductions over the int arrays, and classes each kv tile closed,
//   partial or open. The plain twin of these rules is fwd_tile_plan in
//   ops/flash_attention.py, held to the masks on the CPU by
//   tests/test_torch_flash_tile_plan.py. A closed tile is never loaded: a
//   wholly masked tile leaves (m, l, acc) unchanged, so skipping it is
//   exact. An open tile skips the per-element mask. Inside a tile a warp
//   also skips the tile when none of its 16 rows can see it (no live row,
//   the block skip's 64-row grain, every valid key after its last live
//   position). Every block adds the tiles it left to compute and the open
//   ones to two device counters, which flash_fwd_tile_counts reads, so the
//   card's classes can be held to the twin's.
// - A two-stage cp.async ring. K and V (16-byte cp.async.cg per thread;
//   rows past sk zero-filled by the src-size 0 form) and the keys'
//   positions and segment ids (4-byte cp.async.ca; keys past sk stored as
//   PAD_POS, segment 0) of the next non-closed tile are in flight while
//   the current one computes: commit_group, wait_group 1.
// - Fragments through ldmatrix: .x4 for Q and K, .x4.trans for V, one
//   depth step of Q at a time. Rows are padded to D + 8 elements (272 bytes
//   at d=128), so each 8-row ldmatrix phase hits 32 distinct banks and
//   every row stays 16-byte aligned for cp.async.
// - S = Q K^T and O += P V are mma.sync m16n8k16 (bf16 operands, f32
//   accumulate); P goes from the S accumulators to the A fragments of the
//   second product in registers.
// - Softmax in base 2: the row max is taken on the raw scores and each
//   probability is ex2.approx of one FMA, s * (scale log2 e) - m * (scale
//   log2 e); masked scores are -inf, so they give exactly 0. O is rescaled
//   only when a row of the warp has a new max. lse leaves in natural-log
//   units, m * scale + log l (K2/K3 and the plain version read it so). The
//   kernel needs scale > 0.
// - Causal launches issue the heaviest q tiles first: the q tile is the
//   slowest grid axis and is walked from the last.
//
// Registers and shared memory: two 256-thread blocks per SM
// (__launch_bounds__(256, 2), at most 128 registers a thread). A thread
// holds 64 f32 accumulators of O and 32 of S at d=128, so Q is read from
// shared memory at every kv tile (one ldmatrix.x4 per depth step) and the
// rows' positions and segment ids stay in shared memory. The -Xptxas -v
// report of the H100 build (chip_smoke.py prints it): 128 registers and
// 64 bytes of spill stores at d=128, 127 registers and no spills at d=64.
// Holding Q in registers instead needs far more than 128 registers, so one
// block per SM, and was slower at the training shape when tried. Shared
// memory is Q plus two K/V stages, (128 + 4 * 64)
// rows of D + 8 bf16 (104448 bytes at d=128, 55296 at d=64), 1 KB of key
// positions and segment ids, 1 KB of the rows' ones, and 5 bytes per kv
// tile of the row for the tile classes: two blocks fit in the SM's 228 KB
// up to about 118000 keys.
//
// What bounds it. Prefill attention at the serving shapes does
// 4 * sq * sk * h * d operations (on the pairs the masks leave open)
// against (sq + 2 sk) * d bytes per head: far above the card's ~295
// operations per byte, so it is bound by operations, and the tensor cores
// are the only way to the bf16 peak. mma.sync reaches a fraction of it;
// wgmma with TMA-fed, warp-specialised pipelines is what closes the rest
// (later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int BQ = 128;          // query rows per block (ops: FWD_BQ)
constexpr int BK = 64;           // keys per kv tile (ops: FWD_BK)
constexpr int SKIP_ROWS = 64;    // row grain of the causal block skip (ops: TILE)
constexpr int NWARPS = BQ / 16;  // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;

// Kv tiles the launches left to compute ([0]: not closed) and the open ones
// of those ([1]), summed over blocks; flash_fwd_tile_counts reads and clears
// them.
__device__ unsigned long long tile_counts[2];

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  const int* q_pos;     // [b, sq] contiguous
  const int* kv_pos;    // [b, sk] contiguous
  const int* q_seg;     // [b, sq] or null
  const int* kv_seg;    // [b, sk] or null
  int b, sq, sk, h, kvh;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
  int block_skip;
  int n_kv_tiles;       // ceil(sk / BK): the length of the class arrays
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 8;          // padded row length in shared memory
  constexpr int CHUNKS = D / 8;      // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;     // mma depth steps over head_dim
  constexpr int NT_S = BK / 8;       // n-tiles of S per warp
  constexpr int NT_O = D / 8;        // n-tiles of O per warp
  constexpr int STAGE = BK * LD;     // elements of one K or V stage

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;            // [2][BK][LD]
  __nv_bfloat16* sV = sK + 2 * STAGE;          // [2][BK][LD]
  int* sKpos = reinterpret_cast<int*>(sV + 2 * STAGE);   // [2][BK]
  int* sKseg = sKpos + 2 * BK;                 // [2][BK]
  int* sQpos = sKseg + 2 * BK;                 // [BQ]
  int* sQseg = sQpos + BQ;                     // [BQ]
  int* sKmin = sQseg + BQ;                     // [n_kv_tiles]
  unsigned char* sClass = reinterpret_cast<unsigned char*>(sKmin + p.n_kv_tiles);

  const int num_q = (p.sq + BQ - 1) / BQ;
  const int qt = p.causal ? num_q - 1 - static_cast<int>(blockIdx.z)
                          : static_cast<int>(blockIdx.z);
  const int q0 = qt * BQ;
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

  // Summary of the q tile's live rows (every warp computes it whole).
  int qmin = INT_MAX, qmax = INT_MIN, qsmin = INT_MAX, qsmax = INT_MIN;
  bool found = false, dead = false;
  for (int r = lane; r < BQ && q0 + r < p.sq; r += 32) {
    const long long idx = qrow0 + q0 + r;
    const int qs = use_seg ? p.q_seg[idx] : 1;
    if (qs == 0) {
      dead = true;
      continue;
    }
    const int qp = p.q_pos[idx];
    found = true;
    qmin = min(qmin, qp);
    qmax = max(qmax, qp);
    qsmin = min(qsmin, qs);
    qsmax = max(qsmax, qs);
  }
  const bool any_live = __any_sync(FULL, found);
  const bool all_live = !__any_sync(FULL, dead);
  qmin = warp_min(qmin);
  qmax = warp_max(qmax);
  qsmin = warp_min(qsmin);
  qsmax = warp_max(qsmax);

  // Causal block skip by storage index: keys at or past kv_end are left to
  // no row of this tile.
  const int kv_end = p.block_skip ? min(p.sk, q0 + BQ) : p.sk;
  const int n_kt = (kv_end + BK - 1) / BK;

  // Class every kv tile, one warp per tile.
  for (int kt = warp; kt < n_kt; kt += NWARPS) {
    int kmin = INT_MAX, kmax = INT_MIN, ksmin = INT_MAX, ksmax = INT_MIN;
    bool any = false, all = true;
#pragma unroll
    for (int j = lane; j < BK; j += 32) {
      const int key = kt * BK + j;
      bool valid = false;
      if (key < p.sk) {
        const int kp = p.kv_pos[krow0 + key];
        valid = kp < PAD_POS;
        if (valid) {
          kmin = min(kmin, kp);
          kmax = max(kmax, kp);
          if (use_seg) {
            const int ks = p.kv_seg[krow0 + key];
            ksmin = min(ksmin, ks);
            ksmax = max(ksmax, ks);
          }
        }
      }
      any = any || valid;
      all = all && valid;
    }
    any = __any_sync(FULL, any);
    all = __all_sync(FULL, all);
    kmin = warp_min(kmin);
    kmax = warp_max(kmax);
    ksmin = warp_min(ksmin);
    ksmax = warp_max(ksmax);
    if (lane == 0) {
      unsigned char cls = PARTIAL;
      if (!any || !any_live) {
        cls = CLOSED;
      } else if (p.causal && kmin > qmax) {
        cls = CLOSED;
      } else if (use_seg && ((ksmin == 0 && ksmax == 0) || ksmax < qsmin ||
                             ksmin > qsmax)) {
        cls = CLOSED;
      } else {
        bool open = all && all_live;
        if (p.causal) open = open && kmax <= qmin;
        if (use_seg) open = open && ksmin == ksmax && qsmin == qsmax && ksmin == qsmin;
        if (p.block_skip)
          open = open && kt * BK + BK <= (q0 / SKIP_ROWS + 1) * SKIP_ROWS;
        if (open) cls = OPEN;
      }
      sClass[kt] = cls;
      sKmin[kt] = kmin;
    }
  }

  // The q tile's positions and segment ids for the masks, and what this
  // warp's rows can see.
  if (tid < BQ) {
    const bool in = q0 + tid < p.sq;
    sQpos[tid] = in ? p.q_pos[qrow0 + q0 + tid] : 0;
    sQseg[tid] = (in && use_seg) ? p.q_seg[qrow0 + q0 + tid] : 0;
  }
  int w_hi = INT_MIN;
  bool w_live = false;
  if (lane < 16 && q0 + warp * 16 + lane < p.sq) {
    const long long idx = qrow0 + q0 + warp * 16 + lane;
    if (!use_seg || p.q_seg[idx] != 0) {
      w_live = true;
      w_hi = p.q_pos[idx];
    }
  }
  w_live = __any_sync(FULL, w_live);
  w_hi = warp_max(w_hi);
  const int w_kv_end = p.block_skip
      ? ((q0 + warp * 16) / SKIP_ROWS + 1) * SKIP_ROWS : INT_MAX;
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

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};   // running max of the raw scores
  float l[2] = {0.f, 0.f};
  const float sl2 = p.scale * LOG2E;

  int kt = next_tile(-1);
  if (kt < n_kt) {
    const __nv_bfloat16* qbase = p.q + bi * p.q_sb + hq * p.q_sh;
    for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      const bool in = q0 + r < p.sq;
      const long long row = in ? q0 + r : p.sq - 1;
      cp_async16(sQ + r * LD + c, qbase + row * p.q_ss + c, in);
    }
    load_kv(kt, 0);
    cp_async_commit();
    int kn = next_tile(kt);
    if (kn < n_kt) load_kv(kn, 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    int stage = 0;
    while (true) {
      const bool skip = !w_live || kt * BK >= w_kv_end ||
                        (p.causal && sKmin[kt] > w_hi);
      if (!skip) {
        const __nv_bfloat16* tK = sK + stage * STAGE;
        const __nv_bfloat16* tV = sV + stage * STAGE;

        // S = Q K^T for this warp's 16 rows x 64 keys, one depth step at a
        // time. The Q A fragment: lanes 0-15 address rows 0-15 at column
        // 16 kk, lanes 16-31 the same rows at 16 kk + 8. One ldmatrix.x4
        // gives the K B fragments of n-tiles 2 jp and 2 jp + 1: lanes 0-7
        // address keys 16 jp..16 jp + 7 at column 16 kk, lanes 8-15 the same
        // keys at 16 kk + 8, lanes 16-31 keys 16 jp + 8.. likewise.
        float s[NT_S][4];
#pragma unroll
        for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t qa[4];
          ldmatrix_x4(qa, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int jp = 0; jp < NT_S / 2; ++jp) {
            uint32_t b[4];
            ldmatrix_x4(b, tK + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                               ((lane >> 3) & 1) * 8);
            mma_16816(s[2 * jp], qa, b[0], b[1]);
            mma_16816(s[2 * jp + 1], qa, b[2], b[3]);
          }
        }

        // Mask a partial tile; accumulator element e sits at row
        // g + 8 (e >> 1), key column 8 j + 2 t + (e & 1).
        float mc[2] = {NEG_INF, NEG_INF};
        if (sClass[kt] == OPEN) {
#pragma unroll
          for (int j = 0; j < NT_S; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
        } else {
          const int* tp = sKpos + stage * BK;
          const int* ts = sKseg + stage * BK;
          const int qpos[2] = {sQpos[warp * 16 + g], sQpos[warp * 16 + g + 8]};
          const int qseg[2] = {sQseg[warp * 16 + g], sQseg[warp * 16 + g + 8]};
#pragma unroll
          for (int j = 0; j < NT_S; ++j) {
            const int col = j * 8 + 2 * t;
            const int2 kp = *reinterpret_cast<const int2*>(tp + col);
            const int2 ks = *reinterpret_cast<const int2*>(ts + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rr = e >> 1;
              const int kpe = (e & 1) ? kp.y : kp.x;
              const int kse = (e & 1) ? ks.y : ks.x;
              bool ok = kpe < PAD_POS;
              if (p.causal) ok = ok && kpe <= qpos[rr];
              if (use_seg) ok = ok && kse == qseg[rr] && kse != 0;
              s[j][e] = ok ? s[j][e] : -INFINITY;
              mc[rr] = fmaxf(mc[rr], s[j][e]);
            }
          }
        }

        float alpha[2], mb[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float m_new = fmaxf(m[rr], quad_max(mc[rr]));
          // Rows with no valid key yet keep m == NEG_INF; guard the shift.
          const float m_safe = m_new <= NEG_INF ? 0.f : m_new;
          alpha[rr] = m[rr] <= NEG_INF ? 0.f : ex2((m[rr] - m_safe) * sl2);
          m[rr] = m_new;
          mb[rr] = m_safe * sl2;
        }
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const float pv = ex2(fmaf(s[j][e], sl2, -mb[rr]));
            s[j][e] = pv;
            rs[rr] += pv;
          }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) l[rr] = alpha[rr] * l[rr] + quad_sum(rs[rr]);
        // Rescale only when some row of the warp has a new max (multiplying
        // by 1 is exact, so skipping it changes nothing).
        if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
          for (int n = 0; n < NT_O; ++n) {
            o[n][0] *= alpha[0];
            o[n][1] *= alpha[0];
            o[n][2] *= alpha[1];
            o[n][3] *= alpha[1];
          }
        }

        // O += P V: the S accumulators of n-tiles 2c and 2c+1 are exactly
        // the A fragment of a 16-key step. One ldmatrix.x4.trans gives the
        // B fragments of n-tiles n and n + 1: lanes 0-15 address keys
        // 16c..16c+15 at column 8n, lanes 16-31 the same keys at 8n + 8.
#pragma unroll
        for (int c = 0; c < BK / 16; ++c) {
          uint32_t a[4];
          a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
          a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
          a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
          a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
          for (int n = 0; n < NT_O; n += 2) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, tV + (c * 16 + (lane & 15)) * LD + n * 8 + (lane >> 4) * 8);
            mma_16816(o[n], a, b[0], b[1]);
            mma_16816(o[n + 1], a, b[2], b[3]);
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

  // Finalize: fully masked rows (l == 0) give out 0 and lse NEG_INF.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qrow = q0 + warp * 16 + g + rr * 8;
    if (qrow >= p.sq) continue;
    const float l_safe = l[rr] == 0.f ? 1.f : l[rr];
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = p.o + bi * p.o_sb + qrow * p.o_ss + hq * p.o_sh;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const uint32_t packed = pack_bf16(o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = packed;
    }
    if (t == 0) {
      const long long li =
          (static_cast<long long>(bi) * p.h + hq) * p.sq + qrow;
      p.lse[li] = l[rr] == 0.f ? NEG_INF : m[rr] * p.scale + logf(l_safe);
    }
  }

  // This block's share of the tile counts, from the classes it walked by.
  if (warp == 0) {
    unsigned computed = 0, opened = 0;
    for (int i = lane; i < n_kt; i += 32) {
      computed += sClass[i] != CLOSED;
      opened += sClass[i] == OPEN;
    }
    computed = __reduce_add_sync(FULL, computed);
    opened = __reduce_add_sync(FULL, opened);
    if (lane == 0 && computed != 0) {
      atomicAdd(&tile_counts[0], static_cast<unsigned long long>(computed));
      atomicAdd(&tile_counts[1], static_cast<unsigned long long>(opened));
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = static_cast<size_t>(BQ + 4 * BK) * LD * sizeof(__nv_bfloat16) +
                      (4 * BK + 2 * BQ) * sizeof(int) +
                      static_cast<size_t>(p.n_kv_tiles) * (sizeof(int) + 1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.h, p.b, (p.sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Strides are in elements; the
// caller guarantees a unit last stride, 16-byte aligned bases and row
// strides that are multiples of 8 elements. Returns a cudaError_t.
extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* q_pos, const void* kv_pos, const void* q_seg,
    const void* kv_seg, int b, int sq, int sk, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int block_skip, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 ||
      !(scale > 0.f) || b > 65535 || (sq + BQ - 1) / BQ > 65535 ||
      (q_seg == nullptr) != (kv_seg == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
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
  p.n_kv_tiles = (sk + BK - 1) / BK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch<64>(p, s));
    case 128: return static_cast<int>(launch<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[0], out[1]: the kv tiles every launch since the last call left to
// compute and, of those, the open ones, summed over blocks (each q head
// counts its own), once the device is idle; then clears them. Returns a
// cudaError_t.
extern "C" int flash_fwd_tile_counts(unsigned long long* out) {
  static const unsigned long long zero[2] = {0, 0};
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, tile_counts, sizeof(tile_counts));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(tile_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
