"""Flash attention: the hand-written Hopper kernels (forward
``csrc/flash_fwd.cu``, backward ``csrc/flash_bwd.cu``), their plain PyTorch
versions, and the autograd Function that joins them.

Replaces the Pallas TPU kernels of ``runbooks_tpu/ops/flash_attention.py``:
``_fwd_kernel`` (launched by ``_flash_fwd``), and ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (launched by ``flash_attention_bwd``). Same contract:

- layout [b, s, h, d] at the public function; k/v stay at kv-head width
  and query head i reads kv head i // n_rep (never repeated);
- masking by absolute position: keys at position >= PAD_POS are masked,
  causal means kv_pos <= q_pos, segments mean q_seg == kv_seg and
  kv_seg != 0;
- f32 online softmax; ``out = acc / l`` (0 on a fully masked row) and
  ``lse = m + log l`` (NEG_INF on a fully masked row), lse [b, h, sq] f32;
- causal block skip by grid index, exact when storage index i holds
  position i on both sides; it switches itself off when sq != sk;
- backward from the saved (out, lse): ``p = exp(s - lse)`` on the
  unmasked pairs, ``delta = rowsum(do * out)``, ``ds = p (do v^T - delta)
  scale``; dq = ds k, dk = ds^T q and dv = p^T do, dk/dv summed over each
  kv head's n_rep query heads.

A CPU tensor goes to the plain versions; a CUDA tensor goes to the kernels
or raises. The kernels take bfloat16 q/k/v (and do); the forward kernel
takes head_dim 64, 128 or 256 (FWD_HEAD_DIMS) and a scale > 0 (it takes
the row max on the raw scores), the backward kernels head_dim 64 or 128
(BWD_HEAD_DIMS). ``flash_attention.launches`` counts forward launches,
``flash_attention_bwd.dq_launches`` and ``.dkv_launches`` the backward's;
``fwd_tile_counts`` and ``bwd_tile_counts`` read the kernels' own counts of
the tiles they computed, which ``fwd_tile_plan`` predicts at each kernel's
tile sizes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
PAD_POS = 2 ** 30
# The plain versions walk 64-row q tiles and 64-key kv tiles: the backward
# kernels' tiles, the forward kernel's kv tile, and the grain of the causal
# block skip in all three kernels. The TPU kernel's tile hints do not apply
# here.
TILE = 64
# The forward kernel's q rows per block and keys per kv tile
# (csrc/flash_fwd.cu BQ, BK; the same at every head_dim it takes), and the
# backward kernels' q and kv tiles (csrc/flash_bwd.cu BQ, BK);
# fwd_tile_plan classifies the tiles of both.
FWD_BQ, FWD_BK = 128, 64
BWD_BQ, BWD_BK = 64, 64
TILE_CLOSED, TILE_PARTIAL, TILE_OPEN = 0, 1, 2
# The head dims each kernel is built for (csrc/flash_fwd.cu and
# csrc/flash_bwd.cu instantiate these and no others).
FWD_HEAD_DIMS = (64, 128, 256)
BWD_HEAD_DIMS = (64, 128)

_ll = ctypes.c_longlong
_vp = ctypes.c_void_p
_ARGTYPES = {
    "flash_fwd_bf16": ([_vp] * 9 + [ctypes.c_int] * 6 + [_ll] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, _vp]),
    "flash_bwd_dq_bf16": ([_vp] * 11 + [ctypes.c_int] * 6 + [_ll] * 12
                          + [ctypes.c_float] + [ctypes.c_int] * 3 + [_vp]),
    "flash_bwd_dkv_bf16": ([_vp] * 12 + [ctypes.c_int] * 6 + [_ll] * 12
                           + [ctypes.c_float] + [ctypes.c_int] * 3 + [_vp]),
    "flash_fwd_tile_counts": [_vp],
    "flash_bwd_tile_counts": [_vp],
}
_SOURCE = {"flash_fwd_bf16": "flash_fwd", "flash_fwd_tile_counts": "flash_fwd",
           "flash_bwd_dq_bf16": "flash_bwd", "flash_bwd_dkv_bf16": "flash_bwd",
           "flash_bwd_tile_counts": "flash_bwd"}
GRAD_DTYPES = (torch.bfloat16, torch.float32)


def _kernel(entry: str = "flash_fwd_bf16"):
    from runbooks_tpu_torch.utils import cuda_build

    fn = getattr(cuda_build.load(_SOURCE[entry]), entry)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
    return fn


def _check_inputs(q, k, v, q_positions, kv_positions, q_segment_ids,
                  kv_segment_ids):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [b, s, heads, head_dim]")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    sk = k.shape[1]
    if tuple(q_positions.shape) != (b, sq) \
            or tuple(kv_positions.shape) != (b, sk):
        raise ValueError("positions must be [b, sq] and [b, sk]")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both segment id arrays or neither")
    if q_segment_ids is not None and (
            tuple(q_segment_ids.shape) != (b, sq)
            or tuple(kv_segment_ids.shape) != (b, sk)):
        raise ValueError("segment ids must be [b, sq] and [b, sk]")


def _tile_mask(qp, kp, qs, ks, causal):
    """[b, 1, 1, q, k] mask of one (query block, key tile): keys at PAD_POS
    masked, causal by position, segments equal and non-zero."""
    mask = (kp < PAD_POS)[:, None, :]
    if causal:
        mask = mask & (kp[:, None, :] <= qp[:, :, None])
    if qs is not None:
        mask = mask & (qs[:, :, None] == ks[:, None, :]) & (ks != 0)[:, None, :]
    return mask[:, None, None]


def flash_attention_reference(
    q, k, v, q_positions, kv_positions, q_segment_ids=None,
    kv_segment_ids=None, causal: bool = True, scale: Optional[float] = None,
    block_skip: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: a loop over TILE-wide kv tiles
    with the same f32 online softmax, masks, GQA mapping, block skip and
    lse convention. Returns (out [b, sq, h, d] in q's dtype,
    lse [b, h, sq] f32)."""
    _check_inputs(q, k, v, q_positions, kv_positions, q_segment_ids,
                  kv_segment_ids)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = scale if scale is not None else d ** -0.5
    skip = bool(block_skip and causal and sq == sk)
    use_seg = q_segment_ids is not None

    qg = q.float().reshape(b, sq, kvh, n_rep, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, kvh, n_rep, sq, d), dtype=torch.float32,
                      device=q.device)
    lse = torch.empty((b, kvh, n_rep, sq), dtype=torch.float32,
                      device=q.device)
    num_kv = -(-sk // TILE)
    # Without the skip every query row sees the same kv range, so all rows
    # go at once; with it, q tile i stops at kv tile i, its diagonal.
    q_step = TILE if skip else max(sq, 1)
    for q0 in range(0, sq, q_step):
        q1 = min(q0 + q_step, sq)
        last_kv = min(num_kv - 1, q0 // TILE) if skip else num_kv - 1
        qp = q_positions[:, q0:q1]
        m = torch.full((b, kvh, n_rep, q1 - q0), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l_run = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, n_rep, q1 - q0, d), dtype=torch.float32,
                          device=q.device)
        for kb in range(last_kv + 1):
            k0, k1 = kb * TILE, min((kb + 1) * TILE, sk)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qg[:, q0:q1],
                             kf[:, k0:k1]) * scale
            mask = _tile_mask(qp, kv_positions[:, k0:k1],
                              q_segment_ids[:, q0:q1] if use_seg else None,
                              kv_segment_ids[:, k0:k1] if use_seg else None,
                              causal)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            alpha = torch.where(m <= NEG_INF, 0.0, torch.exp(m - m_safe))
            l_run = alpha * l_run + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p, vf[:, k0:k1])
            m = m_new
        l_safe = torch.where(l_run == 0.0, 1.0, l_run)
        out[:, :, :, q0:q1] = acc / l_safe[..., None]
        lse[:, :, :, q0:q1] = torch.where(l_run == 0.0, NEG_INF,
                                          m + torch.log(l_safe))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def fwd_tile_plan(q_pos, kv_pos, q_seg=None, kv_seg=None, causal=True,
                  block_skip=True, bq=FWD_BQ, bk=FWD_BK) -> torch.Tensor:
    """The kernels' tile classes, [b, n_q_tiles, n_kv_tiles] int8, by the
    rules of the classification passes of csrc/flash_fwd.cu (at the
    default tiles, FWD_BQ x FWD_BK) and csrc/flash_bwd.cu (at BWD_BQ x
    BWD_BK); this is their plain twin. A q tile's rows past sq, and rows in
    segment 0, attend no key; the others are its live rows. A kv tile's
    keys past sk carry PAD_POS; keys below PAD_POS are its valid keys.

    - TILE_CLOSED: never loaded. No live row or no valid key; causal and
      every valid key after every live row's position; segments and the
      valid keys' segment interval disjoint from the live rows', or all
      valid keys in segment 0; or the causal block skip (the storage-index
      rule of the plain version, by TILE-row groups, when block_skip,
      causal and sq == sk) leaves the tile to no row.
    - TILE_OPEN: no per-element mask. Every row below sq is live, every key
      valid, causal and every key at or before every row's position,
      segments and one segment id on both sides, and the block skip leaves
      the whole tile to every row.
    - TILE_PARTIAL: the rest, masked per element.

    A closed tile holds no open pair and an open tile no masked pair, so
    skipping the one and not masking the other is exact."""
    b, sq = q_pos.shape
    sk = kv_pos.shape[1]
    nq, nk = -(-sq // bq), -(-sk // bk)
    dev = q_pos.device
    big = 2 ** 62
    use_seg = q_seg is not None

    def tiled(x, n, t, fill):
        out = torch.full((b, n * t), fill, dtype=torch.int64, device=dev)
        out[:, :x.shape[1]] = x
        return out.view(b, n, t)

    def lo_hi(x, keep):
        return (torch.where(keep, x, big).amin(-1),
                torch.where(keep, x, -big).amax(-1))

    in_q = tiled(torch.ones_like(q_pos), nq, bq, 0).bool()
    qp = tiled(q_pos, nq, bq, 0)
    live = in_q
    if use_seg:
        qs = tiled(q_seg, nq, bq, 0)
        live = live & (qs != 0)
    qmin, qmax = lo_hi(qp, live)
    kp = tiled(kv_pos, nk, bk, PAD_POS)
    valid = kp < PAD_POS
    kmin, kmax = lo_hi(kp, valid)

    closed = ~(live.any(-1)[:, :, None] & valid.any(-1)[:, None, :])
    open_ = ((live == in_q).all(-1)[:, :, None]
             & valid.all(-1)[:, None, :])
    if causal:
        closed |= kmin[:, None, :] > qmax[:, :, None]
        open_ &= kmax[:, None, :] <= qmin[:, :, None]
    if use_seg:
        qsmin, qsmax = lo_hi(qs, live)
        ksmin, ksmax = lo_hi(tiled(kv_seg, nk, bk, 0), valid)
        closed |= ((ksmin == 0) & (ksmax == 0))[:, None, :]
        closed |= ksmax[:, None, :] < qsmin[:, :, None]
        closed |= ksmin[:, None, :] > qsmax[:, :, None]
        open_ &= ((ksmin == ksmax)[:, None, :] & (qsmin == qsmax)[:, :, None]
                  & (ksmin[:, None, :] == qsmin[:, :, None]))
    if block_skip and causal and sq == sk:
        # Row r sees keys below (r // TILE + 1) * TILE.
        q0 = torch.arange(nq, device=dev) * bq
        k0 = torch.arange(nk, device=dev) * bk
        last_row = torch.clamp(q0 + bq, max=sq) - 1
        closed |= k0[None, :] >= ((last_row // TILE + 1) * TILE)[:, None]
        open_ &= k0[None, :] + bk <= ((q0 // TILE + 1) * TILE)[:, None]
    plan = torch.full((b, nq, nk), TILE_PARTIAL, dtype=torch.int8,
                      device=dev)
    plan[open_] = TILE_OPEN
    plan[closed] = TILE_CLOSED
    return plan


def _rows_ok(t: torch.Tensor) -> bool:
    """16-byte vector loads need a unit last stride, 16-byte aligned base
    and row strides that are multiples of 8 elements."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1]))


def _flash_fwd_cuda(q, k, v, q_positions, kv_positions, q_segment_ids,
                    kv_segment_ids, causal, scale, block_skip):
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash kernel takes bfloat16; {name} is "
                            f"{t.dtype}")
        if not _rows_ok(t):
            raise ValueError(f"{name} needs a unit last stride, a 16-byte "
                             "aligned base and 8-element row strides")
    if d not in FWD_HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head_dim in "
                         f"{FWD_HEAD_DIMS}, got {d}")
    if not scale > 0:
        raise ValueError(f"the flash kernel takes a scale > 0, got {scale}")
    use_seg = q_segment_ids is not None
    ints = [t.to(device=q.device, dtype=torch.int32).contiguous()
            for t in (q_positions, kv_positions)]
    if use_seg:
        ints += [t.to(device=q.device, dtype=torch.int32).contiguous()
                 for t in (q_segment_ids, kv_segment_ids)]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    seg_q = ints[2].data_ptr() if use_seg else None
    seg_k = ints[3].data_ptr() if use_seg else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), ints[0].data_ptr(), ints[1].data_ptr(), seg_q, seg_k,
        b, sq, sk, h, kvh, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), int(causal), int(block_skip and causal and sq == sk),
        stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd_bf16 launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out, lse


def fwd_tile_counts() -> Tuple[int, int]:
    """(computed, open): the kv tiles the forward kernel's launches since
    the last call left to compute (not closed) and, of those, the open
    ones, counted on the card by every block (each q head counts its own).
    Waits for the device and clears the counts. fwd_tile_plan predicts
    them: computed = heads * (plan != TILE_CLOSED).sum()."""
    counts = (ctypes.c_ulonglong * 2)()
    err = _kernel("flash_fwd_tile_counts")(ctypes.addressof(counts))
    if err != 0:
        raise RuntimeError(f"flash_fwd_tile_counts failed: CUDA error {err}")
    return int(counts[0]), int(counts[1])


def bwd_tile_counts() -> dict:
    """{"flash_bwd_dq": (computed, open), "flash_bwd_dkv": (computed,
    open)}: the (q tile, kv tile) pairs the backward kernels' launches
    since the last call left to compute (not closed) and, of those, the
    open ones, counted on the card by every block (K2 per query head, K3
    once per query head of its group it walks). Waits for the device and
    clears the counts. For one launch of each, fwd_tile_plan at (BWD_BQ,
    BWD_BK) predicts both: computed = heads * (plan != TILE_CLOSED).sum()."""
    counts = (ctypes.c_ulonglong * 4)()
    err = _kernel("flash_bwd_tile_counts")(ctypes.addressof(counts))
    if err != 0:
        raise RuntimeError(f"flash_bwd_tile_counts failed: CUDA error {err}")
    return {"flash_bwd_dq": (int(counts[0]), int(counts[1])),
            "flash_bwd_dkv": (int(counts[2]), int(counts[3]))}


def flash_attention_fwd(
    q: torch.Tensor,                   # [b, sq, h, d]
    k: torch.Tensor,                   # [b, sk, kv_h, d]
    v: torch.Tensor,
    q_positions: torch.Tensor,         # [b, sq] int
    kv_positions: torch.Tensor,        # [b, sk] int
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
    block_skip: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [b, sq, h, d], lse [b, h, sq] f32): the kernel for a CUDA q,
    the plain version for a CPU q."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, causal, scale, block_skip)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check_inputs(q, k, v, q_positions, kv_positions, q_segment_ids,
                  kv_segment_ids)
    return _flash_fwd_cuda(q, k, v, q_positions, kv_positions,
                           q_segment_ids, kv_segment_ids, causal, scale,
                           block_skip)


def flash_attention_bwd_reference(
    q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids, out,
    lse, do, *, causal: bool = True, scale: Optional[float] = None,
    block_skip: bool = True, grad_dtype: Optional[torch.dtype] = None,
    which: str = "all",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels, in f32: the forward
    reference's TILE-wide loops (with the skip, q tile i meets kv tiles
    0..i), masks and NEG_INF guard on lse. Returns (dq [b, sq, h, d],
    dk, dv [b, sk, kvh, d]) in grad_dtype, else in q's, k's and v's dtype;
    dk/dv are summed over each kv head's query heads in f32. ``which``
    "dq" (K2's output) or "dkv" (K3's) computes only those gradients and
    returns None for the others."""
    _check_inputs(q, k, v, q_positions, kv_positions, q_segment_ids,
                  kv_segment_ids)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    n_rep = h // kvh
    scale = scale if scale is not None else d ** -0.5
    skip = bool(block_skip and causal and sq == sk)
    use_seg = q_segment_ids is not None
    if which not in ("all", "dq", "dkv"):
        raise ValueError(f"which must be all, dq or dkv, not {which!r}")
    want_dq, want_dkv = which != "dkv", which != "dq"

    qg = q.float().reshape(b, sq, kvh, n_rep, d)
    dog = do.float().reshape(b, sq, kvh, n_rep, d)
    kf, vf = k.float(), v.float()
    # delta and lse as [b, kvh, n_rep, sq], the layout of s below.
    delta = (dog * out.float().reshape(b, sq, kvh, n_rep, d)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)
    lse = lse.float().reshape(b, kvh, n_rep, sq)
    lse = torch.where(lse <= NEG_INF, 0.0, lse)
    dq = torch.zeros_like(qg)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    num_kv = -(-sk // TILE)
    q_step = TILE if skip else max(sq, 1)
    for q0 in range(0, sq, q_step):
        q1 = min(q0 + q_step, sq)
        last_kv = min(num_kv - 1, q0 // TILE) if skip else num_kv - 1
        qp = q_positions[:, q0:q1]
        for kb in range(last_kv + 1):
            k0, k1 = kb * TILE, min((kb + 1) * TILE, sk)
            s = torch.einsum("bqgrd,bkgd->bgrqk", qg[:, q0:q1],
                             kf[:, k0:k1]) * scale
            mask = _tile_mask(qp, kv_positions[:, k0:k1],
                              q_segment_ids[:, q0:q1] if use_seg else None,
                              kv_segment_ids[:, k0:k1] if use_seg else None,
                              causal)
            p = torch.where(mask, torch.exp(s - lse[..., q0:q1, None]), 0.0)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", dog[:, q0:q1],
                              vf[:, k0:k1])
            ds = p * (dp - delta[..., q0:q1, None]) * scale
            if want_dq:
                dq[:, q0:q1] += torch.einsum("bgrqk,bkgd->bqgrd", ds,
                                             kf[:, k0:k1])
            if want_dkv:
                dk[:, k0:k1] += torch.einsum("bgrqk,bqgrd->bkgd", ds,
                                             qg[:, q0:q1])
                dv[:, k0:k1] += torch.einsum("bgrqk,bqgrd->bkgd", p,
                                             dog[:, q0:q1])
    dq = dq.reshape(b, sq, h, d).to(grad_dtype or q.dtype)
    dk, dv = dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype)
    return (dq if want_dq else None, dk if want_dkv else None,
            dv if want_dkv else None)


def flash_bwd_kernels(q, k, v, q_positions, kv_positions, q_segment_ids,
                      kv_segment_ids, out, lse, do, *, causal: bool = True,
                      scale: Optional[float] = None, block_skip: bool = True,
                      grad_dtype: Optional[torch.dtype] = None):
    """The two backward kernels on CUDA tensors as separate launches, with
    their operands checked and prepared once: (launch_dq() -> dq,
    launch_dkv() -> (dk, dv)). ``flash_attention_bwd`` runs both; a
    caller that times each kernel alone calls them one by one."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check_inputs(q, k, v, q_positions, kv_positions, q_segment_ids,
                  kv_segment_ids)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if not _rows_ok(do):
        do = do.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the flash backward kernels take bfloat16; "
                            f"{name} is {t.dtype}")
        if not _rows_ok(t):
            raise ValueError(f"{name} needs a unit last stride, a 16-byte "
                             "aligned base and 8-element row strides")
    if d not in BWD_HEAD_DIMS:
        raise ValueError(f"the flash backward kernels take head_dim in "
                         f"{BWD_HEAD_DIMS}, got {d}")
    gd = grad_dtype or q.dtype
    if gd not in GRAD_DTYPES:
        raise TypeError(f"the flash backward kernels write {GRAD_DTYPES}, "
                        f"not {gd}")
    ints = [t.to(device=q.device, dtype=torch.int32).contiguous()
            for t in (q_positions, kv_positions, q_segment_ids,
                      kv_segment_ids) if t is not None]
    # The JAX package computes delta outside its kernels too.
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.to(torch.float32).contiguous()
    tail = (b, sq, sk, h, kvh, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], float(scale), int(causal),
            int(block_skip and causal and sq == sk),
            int(gd == torch.float32))

    def launch(entry, outs):
        # Referencing the prepared operands here keeps them alive for as
        # long as the launchers are.
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs,
                                       *ints)]
        if len(ints) == 2:
            ptrs += [None, None]
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel(entry)(*ptrs, *tail, stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")

    def launch_dq():
        dq = torch.empty((b, sq, h, d), dtype=gd, device=q.device)
        launch("flash_bwd_dq_bf16", (dq,))
        flash_attention_bwd.dq_launches += 1
        return dq

    def launch_dkv():
        dk = torch.empty((b, sk, kvh, d), dtype=gd, device=q.device)
        dv = torch.empty_like(dk)
        launch("flash_bwd_dkv_bf16", (dk, dv))
        flash_attention_bwd.dkv_launches += 1
        return dk, dv

    return launch_dq, launch_dkv


def flash_attention_bwd(
    q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids, out,
    lse, do, *, causal: bool = True, scale: Optional[float] = None,
    block_skip: bool = True, grad_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's (out, lse) and the output gradient
    do: the kernels for a CUDA q, the plain version for a CPU q.
    grad_dtype sets the gradients' dtype (bfloat16 or float32 on CUDA)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, out, lse, do, causal=causal, scale=scale,
            block_skip=block_skip, grad_dtype=grad_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    launch_dq, launch_dkv = flash_bwd_kernels(
        q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
        out, lse, do, causal=causal, scale=scale, block_skip=block_skip,
        grad_dtype=grad_dtype)
    return (launch_dq(), *launch_dkv())


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0


@torch.library.custom_op("rbt::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor,
                 q_segment_ids: Optional[torch.Tensor],
                 kv_segment_ids: Optional[torch.Tensor], causal: bool,
                 scale: float, block_skip: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as one operator, ``torch.ops.rbt.flash_fwd``,
    so that a dispatch mode sees K1 (or its plain version) as a single op
    with outputs (out, lse): selective activation checkpointing saves them
    by name (models/transformer.py, remat_policy "save_attn_out") where
    the reference tags its kernel's residuals with ``checkpoint_name``."""
    return flash_attention_fwd(q, k, v, q_positions, kv_positions,
                               q_segment_ids, kv_segment_ids, causal, scale,
                               block_skip)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, q_positions, kv_positions, q_segment_ids,
                    kv_segment_ids, causal, scale, block_skip):
    b, sq, h, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((b, h, sq), dtype=torch.float32))


def _bwd_op(q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, out, lse, do, causal, scale, block_skip, which):
    """One backward kernel: K2 ("dq") or K3 ("dkv") for a CUDA q, the
    plain version's share for a CPU q."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, out, lse, do, causal=causal, scale=scale,
            block_skip=block_skip, which=which)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    launch_dq, launch_dkv = flash_bwd_kernels(
        q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
        out, lse, do, causal=causal, scale=scale, block_skip=block_skip)
    return (launch_dq(), None, None) if which == "dq" \
        else (None, *launch_dkv())


@torch.library.custom_op("rbt::flash_bwd_dq", mutates_args=())
def flash_bwd_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    q_segment_ids: Optional[torch.Tensor],
                    kv_segment_ids: Optional[torch.Tensor],
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool, scale: float, block_skip: bool
                    ) -> torch.Tensor:
    """K2 as one operator, ``torch.ops.rbt.flash_bwd_dq``: dq [b, sq, h,
    d] in q's dtype, so that a dispatch mode (obs/device.CostMode) sees
    it."""
    return _bwd_op(q, k, v, q_positions, kv_positions, q_segment_ids,
                   kv_segment_ids, out, lse, do, causal, scale, block_skip,
                   "dq")[0]


@flash_bwd_dq_op.register_fake
def _flash_bwd_dq_fake(q, *args):
    return torch.empty_like(q)


@torch.library.custom_op("rbt::flash_bwd_dkv", mutates_args=())
def flash_bwd_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_positions: torch.Tensor, kv_positions: torch.Tensor,
                     q_segment_ids: Optional[torch.Tensor],
                     kv_segment_ids: Optional[torch.Tensor],
                     out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     causal: bool, scale: float, block_skip: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 as one operator, ``torch.ops.rbt.flash_bwd_dkv``: (dk, dv) [b,
    sk, kvh, d] in k's and v's dtype."""
    return _bwd_op(q, k, v, q_positions, kv_positions, q_segment_ids,
                   kv_segment_ids, out, lse, do, causal, scale, block_skip,
                   "dkv")[1:]


@flash_bwd_dkv_op.register_fake
def _flash_bwd_dkv_fake(q, k, v, *args):
    return torch.empty_like(k), torch.empty_like(v)


def _attention_flops(q_shape, k_shape, products: int) -> int:
    """``products`` [sq x sk x d] products per head, 2 FLOPs per
    multiply-add, over the whole rectangle: the count of
    torch.utils.flop_counter's SDPA formulas, which count no mask, so that
    a program counts the same FLOPs on the flash and the plain attention
    (whose two einsums per direction it counts as bmm)."""
    b, sq, h, d = q_shape
    return products * 2 * b * h * sq * k_shape[1] * d


def _register_flop_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    # Forward: q k^T and p v. Backward: SDPA's four products, split by
    # kernel: K2 forms dp = do v^T and dq = ds k, K3 dv = p^T do and
    # dk = ds^T q (their recomputed q k^T is not counted, as SDPA's
    # backward formula does not count it).
    @register_flop_formula(torch.ops.rbt.flash_fwd)
    def _fwd(q, k, *args, out_shape=None, **kwargs):
        return _attention_flops(q, k, 2)

    @register_flop_formula([torch.ops.rbt.flash_bwd_dq,
                            torch.ops.rbt.flash_bwd_dkv])
    def _bwd(q, k, *args, out_shape=None, **kwargs):
        return _attention_flops(q, k, 2)


class _FlashAttention(torch.autograd.Function):
    """Forward K1 (through ``flash_fwd_op``), backward K2 and K3 (through
    ``flash_bwd_dq_op`` and ``flash_bwd_dkv_op``; the plain versions on the
    CPU). Saves (q, k, v, out, lse) as the reference's
    _vjp_fwd does; under activation checkpointing the forward runs again
    in the recompute and saves the recomputed (out, lse), unless the
    checkpoint's policy saved the op's outputs, which the recompute then
    reuses without a launch. Positions and segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, q_segment_ids,
                kv_segment_ids, causal, scale, block_skip):
        out, lse = torch.ops.rbt.flash_fwd(
            q, k, v, q_positions, kv_positions, q_segment_ids,
            kv_segment_ids, causal, scale, block_skip)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions,
                              q_segment_ids, kv_segment_ids, out, lse)
        ctx.args = (causal, scale, block_skip)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, qp, kp, qs, ks, out, lse = ctx.saved_tensors
        causal, scale, block_skip = ctx.args
        args = (q, k, v, qp, kp, qs, ks, out, lse, do, causal,
                scale, block_skip)
        dq = torch.ops.rbt.flash_bwd_dq(*args)
        dk, dv = torch.ops.rbt.flash_bwd_dkv(*args)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, q_positions, kv_positions, q_segment_ids=None,
                    kv_segment_ids=None, causal: bool = True,
                    scale: Optional[float] = None,
                    block_skip: bool = True) -> torch.Tensor:
    """Attention output [b, sq, h, d], with the reference's arguments;
    differentiable in q, k and v through the backward kernels.
    block_skip skips kv blocks past the causal diagonal by storage index;
    it is exact only when q index i and kv index i hold the same position,
    so it switches off when sq != sk and a caller with equal lengths but
    offset positions passes block_skip=False."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, q_positions, kv_positions,
                                 q_segment_ids, kv_segment_ids, causal,
                                 float(scale), block_skip)


flash_attention.launches = 0
_register_flop_formulas()
