"""The kernels' tile classes (``fwd_tile_plan``, the plain twin of the
classification passes of csrc/flash_fwd.cu and csrc/flash_bwd.cu) against
the JAX package's attention mask, at the forward's tiles, the backward's
and a small odd pair.

Inputs come from numpy with a seed. The oracle is the reference's
``make_attention_mask`` with the kernel contract's two further rules: keys
at PAD_POS are masked, and with the causal block skip (block_skip, causal,
sq == sk) row r sees only keys below (r // 64 + 1) * 64, the plain
version's storage-index rule. A closed tile must hold no open pair (the
kernel never loads it) and an open tile no masked pair among its rows
below sq (the kernel does not mask it). For causal masks over aligned
positions the closed tiles are exactly the tiles with no open pair. The
computed-tile counts of chip_smoke.py's K1 cases and of its K2/K3 cases
are pinned: on the card each kernel's own count must equal them times the
heads (chip_smoke.py phases 3 and 5).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from runbooks_tpu.ops.attention import make_attention_mask

import chip_smoke
from runbooks_tpu_torch.ops.flash_attention import (
    BWD_BK,
    BWD_BQ,
    FWD_BK,
    FWD_BQ,
    PAD_POS,
    TILE,
    TILE_CLOSED,
    TILE_OPEN,
    TILE_PARTIAL,
    fwd_tile_plan,
)

torch.set_num_threads(2)

TILES = [(FWD_BQ, FWD_BK), (BWD_BQ, BWD_BK), (32, 16)]


def _oracle(q_pos, kv_pos, q_seg, kv_seg, causal, block_skip):
    """[b, sq, sk] bool: the pairs the kernel contract leaves open."""
    mask = np.asarray(make_attention_mask(
        jnp.asarray(q_pos), jnp.asarray(kv_pos),
        None if q_seg is None else jnp.asarray(q_seg),
        None if kv_seg is None else jnp.asarray(kv_seg), causal))[:, 0]
    mask = mask & (kv_pos < PAD_POS)[:, None, :]
    sq, sk = q_pos.shape[1], kv_pos.shape[1]
    if block_skip and causal and sq == sk:
        limit = (np.arange(sq) // TILE + 1) * TILE
        mask = mask & (np.arange(sk)[None, :] < limit[:, None])[None]
    return mask


def _check(q_pos, kv_pos, q_seg=None, kv_seg=None, causal=True,
           block_skip=True, bq=FWD_BQ, bk=FWD_BK, tight=False):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    plan = fwd_tile_plan(t(q_pos), t(kv_pos), t(q_seg), t(kv_seg), causal,
                         block_skip, bq, bk).numpy()
    mask = _oracle(q_pos, kv_pos, q_seg, kv_seg, causal, block_skip)
    b, sq, sk = mask.shape
    nq, nk = -(-sq // bq), -(-sk // bk)
    assert plan.shape == (b, nq, nk)
    assert set(np.unique(plan)) <= {TILE_CLOSED, TILE_PARTIAL, TILE_OPEN}
    # Rows past sq never count; keys past sk count as masked.
    any_open = np.zeros((b, nq * bq, nk * bk), bool)
    any_open[:, :sq, :sk] = mask
    all_open = np.ones((b, nq * bq, nk * bk), bool)
    all_open[:, :, sk:] = False
    all_open[:, :sq, :sk] = mask
    any_open = any_open.reshape(b, nq, bq, nk, bk).any(axis=(2, 4))
    all_open = all_open.reshape(b, nq, bq, nk, bk).all(axis=(2, 4))
    closed, opened = plan == TILE_CLOSED, plan == TILE_OPEN
    assert not (closed & any_open).any(), "a closed tile holds an open pair"
    assert not (opened & ~all_open).any(), "an open tile holds a masked pair"
    if tight:
        np.testing.assert_array_equal(closed, ~any_open)
    return plan


def _packed(rng, b, s, max_doc, pad_tail=True):
    """Random documents packed into rows: segment ids 1, 2, ... with
    positions restarting per document, and a padding tail in segment 0."""
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int32)
    for r in range(b):
        end = s - int(rng.integers(1, s // 4)) if pad_tail else s
        at, i = 0, 1
        while at < end:
            n = min(int(rng.integers(1, max_doc)), end - at)
            seg[r, at:at + n] = i
            pos[r, at:at + n] = np.arange(n)
            at, i = at + n, i + 1
        pos[r, end:] = np.arange(s - end)
    return seg, pos


def _arange(b, n, start=0):
    return np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                           (b, n)).copy()


@pytest.mark.parametrize("bq,bk", TILES)
def test_packed_segments_restarting_positions(bq, bk):
    rng = np.random.default_rng(0)
    seg, pos = _packed(rng, 3, 700, 300)
    plan = _check(pos, pos, seg, seg, bq=bq, bk=bk)
    # Segments close some tiles that the causal skip alone leaves.
    skip_only = fwd_tile_plan(torch.from_numpy(_arange(3, 700)),
                              torch.from_numpy(_arange(3, 700)), bq=bq,
                              bk=bk).numpy()
    assert (plan == TILE_CLOSED).sum() > (skip_only == TILE_CLOSED).sum()


@pytest.mark.parametrize("bq,bk", TILES)
def test_padding_segment_rows_close_their_tiles(bq, bk):
    # A q tile wholly in segment 0 sees no key.
    s = 4 * bq
    seg = np.ones((1, s), np.int32)
    seg[:, 2 * bq:] = 0
    pos = _arange(1, s)
    plan = _check(pos, pos, seg, seg, bq=bq, bk=bk)
    assert (plan[:, 2:] == TILE_CLOSED).all()


@pytest.mark.parametrize("bq,bk", TILES)
def test_offset_queries_cached_prefill(bq, bk):
    # Queries at positions 100.. against a cache whose slot i holds
    # position i, the block skip off (sq != sk): only the tiles up to the
    # last query's position are computed, and tiles wholly before the first
    # query are open.
    sk = 2049
    q_pos, kv_pos = _arange(2, 16, 100), _arange(2, sk)
    plan = _check(q_pos, kv_pos, block_skip=False, bq=bq, bk=bk, tight=True)
    computed = (plan[0, 0] != TILE_CLOSED).sum()
    assert computed == 115 // bk + 1
    assert (plan[0, 0, :100 // bk] == TILE_OPEN).all()


@pytest.mark.parametrize("bq,bk", TILES)
def test_ragged_kv_with_block_skip(bq, bk):
    s = 200
    pos = _arange(2, s)
    plan = _check(pos, pos, bq=bq, bk=bk, tight=True)
    # The last kv tile holds keys past sk: never open.
    assert (plan[..., -1] != TILE_OPEN).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bq,bk", TILES)
def test_padding_keys_at_pad_pos(causal, bq, bk):
    rng = np.random.default_rng(1)
    sq, sk = 96, 300
    q_pos = _arange(2, sq, 150)
    kv_pos = _arange(2, sk)
    kv_pos[:, 200:] = PAD_POS                     # a padding tail
    kv_pos[0, rng.choice(200, 30, replace=False)] = PAD_POS
    plan = _check(q_pos, kv_pos, causal=causal, block_skip=False, bq=bq,
                  bk=bk)
    assert (plan[..., 200 // bk + 1:] == TILE_CLOSED).all()


@pytest.mark.parametrize("bq,bk", TILES)
def test_noncausal_segments(bq, bk):
    rng = np.random.default_rng(2)
    seg, pos = _packed(rng, 2, 900, 450)
    plan = _check(pos, pos, seg, seg, causal=False, bq=bq, bk=bk)
    assert (plan == TILE_OPEN).any() and (plan == TILE_CLOSED).any()


@pytest.mark.parametrize("sq,sk", [(300, 130), (70, 500)])
@pytest.mark.parametrize("bq,bk", TILES)
def test_sq_differs_from_sk(sq, sk, bq, bk):
    # The block skip switches itself off when sq != sk.
    rng = np.random.default_rng(3)
    q_pos = np.sort(rng.integers(0, 600, (2, sq)), axis=1).astype(np.int32)
    kv_pos = _arange(2, sk, 40)
    _check(q_pos, kv_pos, block_skip=True, bq=bq, bk=bk, tight=True)


@pytest.mark.parametrize("seed", [4, 5, 6])
@pytest.mark.parametrize("bq,bk", TILES)
def test_random_positions_and_segments(seed, bq, bk):
    # Unsorted positions, random segment ids with zeros, PAD_POS keys: the
    # rules hold for any layout, not only the packed one.
    rng = np.random.default_rng(seed)
    b, s = 2, 333
    pos = rng.integers(0, 400, (b, s)).astype(np.int32)
    seg = rng.integers(0, 3, (b, s)).astype(np.int32)
    seg[:, 100:180] = 1
    pos[:, 100:180] = np.arange(80)
    kv_pos = pos.copy()
    kv_pos[:, rng.choice(s, 20, replace=False)] = PAD_POS
    for causal in (True, False):
        _check(pos, kv_pos, seg, seg, causal=causal, bq=bq, bk=bk)
        _check(pos, kv_pos, causal=causal, bq=bq, bk=bk)


@pytest.fixture(scope="module")
def train_batch(tmp_path_factory):
    """The training job's first batch of packed rows."""
    path = tmp_path_factory.mktemp("docs") / "docs.jsonl"
    chip_smoke.write_train_docs(str(path), 0)
    return chip_smoke.first_train_batch(str(path))


@pytest.fixture(scope="module")
def smoke_layouts(train_batch):
    """chip_smoke.py's K1 cases (positions and segment ids only)."""
    return {case[0]: case for case in chip_smoke.fwd_case_layouts(
        torch, torch.device("cpu"), train_batch)}


@pytest.fixture(scope="module")
def smoke_bwd_layouts(train_batch):
    """chip_smoke.py's K2/K3 cases (positions and segment ids only)."""
    return {case[0]: case for case in chip_smoke.bwd_case_layouts(
        torch, torch.device("cpu"), train_batch)}


# (computed, open, total) kv tiles over the batch rows, per head.
SMOKE_TILES = {
    "rows1_sq2048": (272, 240, 528),
    "rows8_sq128": (264, 192, 264),
    "rows1_sq16_at100": (2, 1, 33),
    "mha_d64_skip": (40, 24, 64),
    "segments_masked_rows": (26, 0, 64),
    "segment_inside_tile": (93, 28, 256),
    "a_packed_2x2048": (427, 342, 1024),
    "b_causal_2x2048": (544, 480, 1024),
}


@pytest.mark.parametrize("name", list(SMOKE_TILES))
def test_chip_smoke_cases(smoke_layouts, name):
    (_, _, qp, kp, qs, ks, skip, _) = smoke_layouts[name]
    np_ = lambda a: None if a is None else a.numpy()  # noqa: E731
    _check(np_(qp), np_(kp), np_(qs), np_(ks), block_skip=skip,
           tight=qs is None)
    assert chip_smoke.tile_counts(torch, qp, kp, qs, ks, skip) \
        == SMOKE_TILES[name]


# (computed, open, total) (q tile, kv tile) pairs of K2 and K3 at the
# backward's tiles over the batch rows, per head.
SMOKE_BWD_TILES = {
    "a_packed_2x2048": (822, 727, 2048),
    "b_causal_2x2048": (1056, 992, 2048),
    "c_ragged_2x2000": (1056, 992, 2048),
    "d_d64_rep2_2x1024": (272, 240, 512),
    "e_offset_sk_gt_sq": (164, 148, 256),
    "f_f32_grads_2x2048": (1056, 992, 2048),
}


@pytest.mark.parametrize("name", list(SMOKE_BWD_TILES))
def test_chip_smoke_bwd_cases(smoke_bwd_layouts, name):
    (_, _, qp, kp, seg, skip, _) = smoke_bwd_layouts[name]
    np_ = lambda a: None if a is None else a.numpy()  # noqa: E731
    _check(np_(qp), np_(kp), np_(seg), np_(seg), block_skip=skip,
           bq=BWD_BQ, bk=BWD_BK, tight=seg is None)
    assert chip_smoke.tile_counts(torch, qp, kp, seg, seg, skip,
                                  backward=True) == SMOKE_BWD_TILES[name]


def test_segments_close_backward_pairs_on_the_training_path():
    # At the training microbatch (a) the job's document boundaries leave
    # K2 and K3 822 of the 1056 pairs the causal skip alone leaves (b): 78%.
    a = SMOKE_BWD_TILES["a_packed_2x2048"][0]
    b = SMOKE_BWD_TILES["b_causal_2x2048"][0]
    assert a < b and a / b == pytest.approx(0.778, abs=1e-3)


def test_closed_fractions_on_the_main_paths(smoke_layouts):
    # The training microbatch (a): the causal skip and the job's document
    # boundaries close 58% of the kv tiles, causal alone (b) 47%. Cached
    # prefill of a 2048-token prompt (block skip off): the position skip
    # closes 48%; a 16-token bucket at position 100 walks 2 of 33 tiles.
    def closed(name):
        (_, _, qp, kp, qs, ks, skip, _) = smoke_layouts[name]
        plan = fwd_tile_plan(qp, kp, qs, ks, block_skip=skip)
        return (plan == TILE_CLOSED).float().mean().item()

    assert closed("a_packed_2x2048") == pytest.approx(597 / 1024)
    assert closed("b_causal_2x2048") == pytest.approx(480 / 1024)
    assert closed("rows1_sq2048") == pytest.approx(256 / 528)
    assert closed("rows1_sq16_at100") == pytest.approx(31 / 33)


@pytest.mark.parametrize("source,tiles", [("flash_fwd", (FWD_BQ, FWD_BK)),
                                          ("flash_bwd", (BWD_BQ, BWD_BK))])
def test_plan_constants_are_the_kernels(source, tiles):
    """The twin's tile sizes, skip grain, class codes and PAD_POS are the
    ones each kernel source compiles with (the last two from the header
    both include)."""
    csrc = (Path(chip_smoke.__file__).resolve().parent / "runbooks_tpu_torch"
            / "csrc")
    src = (csrc / f"{source}.cu").read_text()
    assert '#include "flash_common.cuh"' in src
    src += (csrc / "flash_common.cuh").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = ([^;,]+)[;,]", src).group(1)
                   .replace("1 << 30", str(1 << 30)))

    assert (const("BQ"), const("BK"), const("SKIP_ROWS")) == (*tiles, TILE)
    assert (const("CLOSED"), const("PARTIAL"), const("OPEN")) == (
        TILE_CLOSED, TILE_PARTIAL, TILE_OPEN)
    assert const("PAD_POS") == PAD_POS
