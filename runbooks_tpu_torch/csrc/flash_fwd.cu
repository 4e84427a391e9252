// Flash attention forward for Hopper (sm_90a), bf16 in, f32 accumulation.
//
// Replaces the Pallas TPU kernel runbooks_tpu/ops/flash_attention.py
// _fwd_kernel (launched by _flash_fwd). Same contract: layout [b, s, h, d];
// GQA by kv head h / n_rep read through strides, never repeated; masking by
// absolute position (kv_pos >= PAD_POS masked, causal kv_pos <= q_pos,
// segments q_seg == kv_seg and kv_seg != 0); f32 online softmax with the
// NEG_INF guards of the reference; out = acc / l (0 on a fully masked row),
// lse = m + log l (NEG_INF on a fully masked row), lse [b, h, sq] f32.
//
// Design. The TPU kernel walks kv blocks on a sequential grid axis with
// (m, l, acc) in VMEM scratch. Here one thread block owns one
// (batch, q-head, 64-row q tile) and walks the kv tiles in a loop, keeping
// (m, l, acc) in registers. Four warps each own 16 query rows. Q is staged
// through shared memory once and held as mma fragments in registers; each
// 64-key K/V tile is staged in shared memory (rows padded by 8 elements so
// the fragment loads hit 32 distinct banks). S = Q K^T and O += P V run on
// the tensor cores as mma.sync m16n8k16 (bf16 operands, f32 accumulate); P
// goes from the S accumulators to the A fragments of the second product in
// registers. The ragged kv edge (sk need not be a tile multiple) is masked
// here: out-of-range keys are zero-filled and carry position PAD_POS.
//
// What bounds it. Prefill attention at the serving shapes does
// 4 * sq * sk * h * d operations against (sq + 2 sk) * d bytes per head:
// far above the card's ~295 operations per byte, so it is bound by
// operations, and the tensor cores are the only way to the bf16 peak.
// mma.sync reaches a fraction of it; wgmma with TMA-fed, warp-specialised
// pipelines is what closes the rest (later work). Loads are 16-byte
// vectors, but not yet overlapped with compute (no cp.async ring).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per kv tile
constexpr int NTHREADS = 128;   // 4 warps x 16 query rows
constexpr float NEG_INF = -1e30f;
constexpr int PAD_POS = 1 << 30;

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
};

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive bf16 in shared memory as one 32-bit fragment register
// (the lower column in the low half).
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from consecutive rows of one column.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int ld) {
  const uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint16_t hi = *reinterpret_cast<const uint16_t*>(p + ld);
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const Params p) {
  constexpr int LD = D + 8;          // padded row length in shared memory
  constexpr int CHUNKS = D / 8;      // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;     // mma depth steps over head_dim
  constexpr int NT_S = BK / 8;       // n-tiles of S per warp
  constexpr int NT_O = D / 8;        // n-tiles of O per warp

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BQ * LD;
  __nv_bfloat16* sV = sK + BK * LD;
  int* sKpos = reinterpret_cast<int*>(sV + BK * LD);
  int* sKseg = sKpos + BK;

  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = hq / (p.h / p.kvh);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;           // row within the 8-row group
  const int t = lane & 3;            // thread within the quad
  const bool use_seg = p.q_seg != nullptr;

  const __nv_bfloat16* qbase = p.q + bi * p.q_sb + hq * p.q_sh;
  const __nv_bfloat16* kbase = p.k + bi * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vbase = p.v + bi * p.v_sb + hk * p.v_sh;

  for (int i = tid; i < BQ * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.sq)
      val = *reinterpret_cast<const uint4*>(qbase + (q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }

  // This thread's two query rows: warp*16 + g and warp*16 + g + 8.
  int qrow[2], qpos[2], qseg[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    qrow[rr] = q0 + warp * 16 + g + rr * 8;
    const bool in = qrow[rr] < p.sq;
    const long long idx = static_cast<long long>(bi) * p.sq + qrow[rr];
    qpos[rr] = in ? p.q_pos[idx] : 0;
    qseg[rr] = (in && use_seg) ? p.q_seg[idx] : 0;
  }
  __syncthreads();

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* r0 = sQ + (warp * 16 + g) * LD + kk * 16 + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * LD;
    qf[kk][0] = ld_pair(r0);
    qf[kk][1] = ld_pair(r1);
    qf[kk][2] = ld_pair(r0 + 8);
    qf[kk][3] = ld_pair(r1 + 8);
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};

  // Causal block skip (exact for storage-aligned positions, sq == sk):
  // keys past this tile's last query index are never loaded.
  int kv_end = p.sk;
  if (p.block_skip) kv_end = min(p.sk, q0 + BQ);
  const int n_tiles = (kv_end + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();   // every warp is done with the previous tile
    for (int i = tid; i < BK * CHUNKS; i += NTHREADS) {
      const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
      uint4 kvv = make_uint4(0u, 0u, 0u, 0u), vvv = kvv;
      if (k0 + r < p.sk) {
        kvv = *reinterpret_cast<const uint4*>(kbase + (k0 + r) * p.k_ss + c);
        vvv = *reinterpret_cast<const uint4*>(vbase + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kvv;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vvv;
    }
    for (int i = tid; i < BK; i += NTHREADS) {
      const int key = k0 + i;
      const long long idx = static_cast<long long>(bi) * p.sk + key;
      sKpos[i] = key < p.sk ? p.kv_pos[idx] : PAD_POS;
      sKseg[i] = (key < p.sk && use_seg) ? p.kv_seg[idx] : 0;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = sK + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_16816(s[j], qf[kk], ld_pair(krow + kk * 16),
                  ld_pair(krow + kk * 16 + 8));
    }

    // Scale and mask; accumulator element e sits at row g + 8*(e>>1),
    // key column j*8 + 2t + (e&1).
    float mc[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int col = j * 8 + 2 * t + (e & 1);
        const int kp = sKpos[col];
        bool ok = kp < PAD_POS;
        if (p.causal) ok = ok && kp <= qpos[rr];
        if (use_seg) {
          const int ks = sKseg[col];
          ok = ok && ks == qseg[rr] && ks != 0;
        }
        s[j][e] = ok ? s[j][e] * p.scale : NEG_INF;
        mc[rr] = fmaxf(mc[rr], s[j][e]);
      }
    }

    float m_safe[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float m_new = fmaxf(m[rr], quad_max(mc[rr]));
      // Rows with no valid key yet keep m == NEG_INF; guard the exp shift.
      m_safe[rr] = m_new <= NEG_INF ? 0.f : m_new;
      alpha[rr] = m[rr] <= NEG_INF ? 0.f : expf(m[rr] - m_safe[rr]);
      m[rr] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const float pv = s[j][e] <= NEG_INF ? 0.f : expf(s[j][e] - m_safe[rr]);
        s[j][e] = pv;
        rs[rr] += pv;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = alpha[rr] * l[rr] + quad_sum(rs[rr]);
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2c and 2c+1 are exactly the
    // A fragment of a 16-key step.
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      a[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      a[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      a[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
      const __nv_bfloat16* vrow = sV + (c * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n)
        mma_16816(o[n], a, ld_col_pair(vrow + n * 8, LD),
                  ld_col_pair(vrow + 8 * LD + n * 8, LD));
    }
  }

  // Finalize: fully masked rows (l == 0) give out 0 and lse NEG_INF.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (qrow[rr] >= p.sq) continue;
    const float l_safe = l[rr] == 0.f ? 1.f : l[rr];
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = p.o + bi * p.o_sb + qrow[rr] * p.o_ss + hq * p.o_sh;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const uint32_t packed = pack_bf16(o[n][2 * rr] * inv, o[n][2 * rr + 1] * inv);
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) = packed;
    }
    if (t == 0) {
      const long long li =
          (static_cast<long long>(bi) * p.h + hq) * p.sq + qrow[rr];
      p.lse[li] = l[rr] == 0.f ? NEG_INF : m[rr] + logf(l_safe);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 8;
  const size_t smem = static_cast<size_t>(BQ + 2 * BK) * LD * sizeof(__nv_bfloat16) +
                      2 * BK * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + BQ - 1) / BQ, p.h, p.b);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch<64>(p, s));
    case 128: return static_cast<int>(launch<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
