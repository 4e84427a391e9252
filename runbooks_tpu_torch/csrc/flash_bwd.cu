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
// delta = rowsum(do * out) computed by the caller.
//
// Design. The TPU kernels walk a sequential grid axis with the sums in VMEM
// scratch. Here every sum lives in registers of one thread block:
//
// - K2 (dq): one block per (batch, q head, 64-row q tile), four warps of 16
//   query rows. Q and dO are held as mma fragments in registers; each 64-key
//   K/V tile is staged in shared memory. Per 16-key chunk S = Q K^T and
//   dP = dO V^T run as mma.sync m16n8k16 (bf16 operands, f32 accumulate), p
//   and ds are formed elementwise (no row max is needed: lse is known), and
//   ds, rounded to bf16, is the A fragment of dQ += dS K. With the causal
//   skip the walk stops at the diagonal tile; blocks are issued heaviest
//   (last q tile) first.
// - K3 (dk, dv): one block per (batch, kv head, 64-key tile), four warps of
//   16 keys. It walks the n_rep query heads of its group and, for each, the
//   q tiles from the diagonal on (all of them without the skip), staging Q,
//   dO, lse and delta in shared memory. S^T = K Q^T and dP^T = V dO^T give
//   p^T and ds^T, which feed dV += P^T dO and dK += dS^T Q. dk and dv for
//   the whole group stay in f32 registers and are written once at kv-head
//   width: no [b, h, sk, d] buffer and no separate fold over the group. Every
//   tile writes its keys, so keys that no query sees come out exactly 0.
//
// Rows past sq and keys past sk are zero-filled in shared memory and masked;
// they are never read from or written to device memory.
//
// What bounds it. Per open query-key pair K2 does 6 d operations and K3 8 d
// against O(d) bytes per row: far above the card's ~295 operations per byte
// at training lengths, so both are bound by operations. mma.sync reaches a
// fraction of the bf16 peak; wgmma with TMA-fed pipelines is later work.
// Loads are 16-byte vectors, not yet overlapped with compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NTHREADS = 128;   // 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;
constexpr int PAD_POS = 1 << 30;

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
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int ld) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16x16 operand whose rows are this warp's 16 rows:
// row g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void ld_a_frag(uint32_t (&a)[4],
                                          const __nv_bfloat16* r0, int ld) {
  a[0] = ld_pair(r0);
  a[1] = ld_pair(r0 + 8 * ld);
  a[2] = ld_pair(r0 + 8);
  a[3] = ld_pair(r0 + 8 * ld + 8);
}

// The accumulators of n-tiles 0 and 1 (a 16x16 block) as an A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// rows x D tile from device memory (row stride ss) into shared memory (row
// length LD), zero-filling rows at or past n_valid.
template <int D>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long ss, int row0, int n_valid,
                                           int rows) {
  constexpr int LD = D + 8;
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * ss + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
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

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_O = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + BQ * LD;
  __nv_bfloat16* sK = sdO + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;
  int* sKpos = reinterpret_cast<int*>(sV + BK * LD);
  int* sKseg = sKpos + BK;

  const int num_q = (p.sq + BQ - 1) / BQ;
  const int q0 = (num_q - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int hq = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hq / (p.h / p.kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool use_seg = p.q_seg != nullptr;

  stage_tile<D>(sQ, p.q + bi * p.q_sb + hq * p.q_sh, p.q_ss, q0, p.sq, BQ);
  stage_tile<D>(sdO, p.dout + bi * p.o_sb + hq * p.o_sh, p.o_ss, q0, p.sq, BQ);

  int qrow[2], qpos[2], qseg[2];
  bool qok[2];
  float lse[2], delta[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qrow[rr] = q0 + warp * 16 + g + rr * 8;
    qok[rr] = qrow[rr] < p.sq;
    const long long idx = static_cast<long long>(bi) * p.sq + qrow[rr];
    const long long li = (static_cast<long long>(bi) * p.h + hq) * p.sq + qrow[rr];
    qpos[rr] = qok[rr] ? p.q_pos[idx] : 0;
    qseg[rr] = (qok[rr] && use_seg) ? p.q_seg[idx] : 0;
    const float l = qok[rr] ? p.lse[li] : 0.f;
    lse[rr] = l <= NEG_INF ? 0.f : l;
    delta[rr] = qok[rr] ? p.delta[li] : 0.f;
  }
  __syncthreads();

  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ld_a_frag(qf[kk], sQ + (warp * 16 + g) * LD + kk * 16 + 2 * t, LD);
    ld_a_frag(dof[kk], sdO + (warp * 16 + g) * LD + kk * 16 + 2 * t, LD);
  }

  float dq[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  // Causal skip (exact for storage-aligned positions, sq == sk): keys past
  // this tile's last query index are never loaded.
  int kv_end = p.sk;
  if (p.block_skip) kv_end = min(p.sk, q0 + BQ);
  const int n_tiles = (kv_end + BK - 1) / BK;
  const __nv_bfloat16* kbase = p.k + bi * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vbase = p.v + bi * p.v_sb + hk * p.v_sh;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous tile
    stage_tile<D>(sK, kbase, p.k_ss, k0, p.sk, BK);
    stage_tile<D>(sV, vbase, p.v_ss, k0, p.sk, BK);
    for (int i = tid; i < BK; i += NTHREADS) {
      const int key = k0 + i;
      const long long idx = static_cast<long long>(bi) * p.sk + key;
      sKpos[i] = key < p.sk ? p.kv_pos[idx] : PAD_POS;
      sKseg[i] = (key < p.sk && use_seg) ? p.kv_seg[idx] : 0;
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        const __nv_bfloat16* krow = sK + (c * 16 + j * 8 + g) * LD + 2 * t;
        const __nv_bfloat16* vrow = sV + (c * 16 + j * 8 + g) * LD + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          mma_16816(s[j], qf[kk], ld_pair(krow + kk * 16), ld_pair(krow + kk * 16 + 8));
          mma_16816(dp[j], dof[kk], ld_pair(vrow + kk * 16), ld_pair(vrow + kk * 16 + 8));
        }
      }
      // Element e sits at query row g + 8 (e >> 1), key c*16 + j*8 + 2t + (e & 1).
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = e >> 1;
          const int col = c * 16 + j * 8 + 2 * t + (e & 1);
          const int kp = sKpos[col];
          bool ok = qok[rr] && kp < PAD_POS;
          if (p.causal) ok = ok && kp <= qpos[rr];
          if (use_seg) {
            const int ks = sKseg[col];
            ok = ok && ks == qseg[rr] && ks != 0;
          }
          const float pv = ok ? expf(s[j][e] * p.scale - lse[rr]) : 0.f;
          s[j][e] = ok ? pv * (dp[j][e] - delta[rr]) * p.scale : 0.f;
        }
      }
      uint32_t a[4];
      acc_to_a(a, s);
      const __nv_bfloat16* kcol = sK + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
        mma_16816(dq[n], a, ld_col_pair(kcol + n * 8, LD),
                  ld_col_pair(kcol + 8 * LD + n * 8, LD));
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!qok[rr]) continue;
    const long long row = ((static_cast<long long>(bi) * p.sq + qrow[rr]) * p.h + hq) * D;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      store_pair(p.dq, row + n * 8 + 2 * t, dq[n][2 * rr], dq[n][2 * rr + 1], p.out_f32);
  }
}

// ---------------------------------------------------------------------------
// K3: dk, dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int LD = D + 8;
  constexpr int KSTEPS = D / 16;
  constexpr int NT_O = D / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BK * LD;
  __nv_bfloat16* sQ = sV + BK * LD;
  __nv_bfloat16* sdO = sQ + BQ * LD;
  int* sQpos = reinterpret_cast<int*>(sdO + BQ * LD);
  int* sQseg = sQpos + BQ;
  int* sQok = sQseg + BQ;
  float* sLse = reinterpret_cast<float*>(sQok + BQ);
  float* sDelta = sLse + BQ;

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int bi = blockIdx.z;
  const int n_rep = p.h / p.kvh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool use_seg = p.q_seg != nullptr;

  stage_tile<D>(sK, p.k + bi * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.sk, BK);
  stage_tile<D>(sV, p.v + bi * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.sk, BK);

  // This thread's two keys: warp*16 + g and warp*16 + g + 8.
  int krow[2], kpos[2], kseg[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    krow[rr] = k0 + warp * 16 + g + rr * 8;
    const bool in = krow[rr] < p.sk;
    const long long idx = static_cast<long long>(bi) * p.sk + krow[rr];
    kpos[rr] = in ? p.kv_pos[idx] : PAD_POS;
    kseg[rr] = (in && use_seg) ? p.kv_seg[idx] : 0;
  }

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  const int num_q = (p.sq + BQ - 1) / BQ;
  // Causal skip: q tiles before the diagonal see none of these keys.
  const int qt_begin = p.block_skip ? min(num_q - 1, k0 / BQ) : 0;

  for (int hr = 0; hr < n_rep; ++hr) {
    const int hq = hk * n_rep + hr;
    const __nv_bfloat16* qbase = p.q + bi * p.q_sb + hq * p.q_sh;
    const __nv_bfloat16* obase = p.dout + bi * p.o_sb + hq * p.o_sh;
    for (int qt = qt_begin; qt < num_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();   // every warp is done with the previous q tile
      stage_tile<D>(sQ, qbase, p.q_ss, q0, p.sq, BQ);
      stage_tile<D>(sdO, obase, p.o_ss, q0, p.sq, BQ);
      for (int i = tid; i < BQ; i += NTHREADS) {
        const int row = q0 + i;
        const bool in = row < p.sq;
        const long long idx = static_cast<long long>(bi) * p.sq + row;
        const long long li = (static_cast<long long>(bi) * p.h + hq) * p.sq + row;
        sQok[i] = in;
        sQpos[i] = in ? p.q_pos[idx] : 0;
        sQseg[i] = (in && use_seg) ? p.q_seg[idx] : 0;
        const float l = in ? p.lse[li] : 0.f;
        sLse[i] = l <= NEG_INF ? 0.f : l;
        sDelta[i] = in ? p.delta[li] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int c = 0; c < BQ / 16; ++c) {
        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 16 queries.
        float s[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        }
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          uint32_t ka[4], va[4];
          ld_a_frag(ka, sK + (warp * 16 + g) * LD + kk * 16 + 2 * t, LD);
          ld_a_frag(va, sV + (warp * 16 + g) * LD + kk * 16 + 2 * t, LD);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const __nv_bfloat16* qr = sQ + (c * 16 + j * 8 + g) * LD + kk * 16 + 2 * t;
            const __nv_bfloat16* dr = sdO + (c * 16 + j * 8 + g) * LD + kk * 16 + 2 * t;
            mma_16816(s[j], ka, ld_pair(qr), ld_pair(qr + 8));
            mma_16816(dp[j], va, ld_pair(dr), ld_pair(dr + 8));
          }
        }
        // Element e sits at key row g + 8 (e >> 1), query c*16 + j*8 + 2t + (e & 1).
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            const int col = c * 16 + j * 8 + 2 * t + (e & 1);
            bool ok = sQok[col] && kpos[rr] < PAD_POS;
            if (p.causal) ok = ok && kpos[rr] <= sQpos[col];
            if (use_seg) ok = ok && kseg[rr] == sQseg[col] && kseg[rr] != 0;
            const float pv = ok ? expf(s[j][e] * p.scale - sLse[col]) : 0.f;
            dp[j][e] = ok ? pv * (dp[j][e] - sDelta[col]) * p.scale : 0.f;
            s[j][e] = pv;
          }
        }
        uint32_t ap[4], ads[4];
        acc_to_a(ap, s);
        acc_to_a(ads, dp);
        const __nv_bfloat16* docol = sdO + (c * 16 + 2 * t) * LD + g;
        const __nv_bfloat16* qcol = sQ + (c * 16 + 2 * t) * LD + g;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          mma_16816(dv[n], ap, ld_col_pair(docol + n * 8, LD),
                    ld_col_pair(docol + 8 * LD + n * 8, LD));
          mma_16816(dk[n], ads, ld_col_pair(qcol + n * 8, LD),
                    ld_col_pair(qcol + 8 * LD + n * 8, LD));
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (krow[rr] >= p.sk) continue;
    const long long row = ((static_cast<long long>(bi) * p.sk + krow[rr]) * p.kvh + hk) * D;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      store_pair(p.dk, row + n * 8 + 2 * t, dk[n][2 * rr], dk[n][2 * rr + 1], p.out_f32);
      store_pair(p.dv, row + n * 8 + 2 * t, dv[n][2 * rr], dv[n][2 * rr + 1], p.out_f32);
    }
  }
}

template <int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = static_cast<size_t>(2 * BQ + 2 * BK) * LD * sizeof(__nv_bfloat16) +
                      2 * BK * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = static_cast<size_t>(2 * BQ + 2 * BK) * LD * sizeof(__nv_bfloat16) +
                      5 * BQ * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + BK - 1) / BK, p.kvh, p.b);
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
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
