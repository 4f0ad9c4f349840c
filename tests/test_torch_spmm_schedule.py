"""Kernel B1's work schedule (``spmm_schedule``) and its cache, on the CPU.

The tile set has block rows of 0, 1, C and C + 1 tiles for C = 4, one of 43
tiles (the ogbn-arxiv hybrid's longest block row), a ragged last block
column and a ragged last block row. The schedule must cover every tile once,
in order, in items of at most C tiles; summing the plain per-tile products
along its items, in item order, is the product ``A @ x``: held against B1's
plain version (to 1e-5: another summation order) and against the JAX
package's ``bcsr_spmm`` (its Pallas body in interpret mode, as its own tests
run it; to 1e-5 at ``highest`` matmul precision). bf16 tiles are held to the
same plain sum exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pygcn_tpu.graph.graph import _build_bcsr as j_build_bcsr
from pygcn_tpu.ops.pallas.bcsr_spmm import bcsr_spmm as j_bcsr_spmm

from pygcn_tpu_torch.apps.time_spmm import long_row_counts, long_row_matrix
from pygcn_tpu_torch.graph.graph import _build_bcsr, drop_zero_tiles
from pygcn_tpu_torch.ops.cuda import bcsr_spmm as b1
from pygcn_tpu_torch.ops.cuda import gat_tile_attn as gta

torch.set_num_threads(1)

C = 4
# tiles per block row; block row 0 has none
ROW_TILES = long_row_counts(C)


def coo(seed=0):
    """A matrix whose block row r has entries in ROW_TILES[r] block columns."""
    return long_row_matrix(C, np.random.default_rng(seed))


N_ROWS, N_COLS = coo().shape  # a ragged last block row and block column


def tiles(drop_padding=True, dtype=torch.float32):
    """The tile set; without ``drop_padding`` block row 0 keeps the
    builder's all-zero padding tile."""
    b = _build_bcsr(coo(), (128, 128))
    if drop_padding:
        b = drop_zero_tiles(b)
    return dataclasses.replace(b, data=b.data.to(dtype))


def per_row(b):
    return np.diff(b.block_row_ptr.numpy())


@pytest.mark.parametrize("max_tiles", [1, 2, C, 8, 64])
@pytest.mark.parametrize("drop_padding", [False, True], ids=["padding_tile", "no_tile"])
def test_schedule_covers_every_tile_once_in_order(drop_padding, max_tiles):
    b = tiles(drop_padding)
    items = b1.spmm_schedule(b, max_tiles).items.numpy()
    begin, end, row = items[:, 0], items[:, 1], items[:, 2]
    # consecutive items continue where the last ended: every tile once, in order
    assert begin[0] == 0 and end[-1] == b.data.shape[0]
    assert (begin[1:] == end[:-1]).all() and (end >= begin).all()
    assert ((end - begin) <= max_tiles).all()
    # each item's tiles lie in its block row, and the rows come in order
    ptr = b.block_row_ptr.numpy()
    assert (ptr[row] <= begin).all() and (end <= ptr[row + 1]).all()
    assert (np.diff(row) >= 0).all() and set(row) == set(range(b.n_block_rows))
    assert (b.block_rows.numpy()[begin[end > begin]] == row[end > begin]).all()


def test_schedule_items_and_split_slots():
    b = tiles()
    assert tuple(per_row(b)) == ROW_TILES
    sched = b1.spmm_schedule(b, C)
    items = sched.items.numpy()
    assert sched.items.dtype == torch.int32 and items.shape[1] == b1.ITEM_INTS
    by_row = {r: items[items[:, 2] == r] for r in range(len(ROW_TILES))}
    # rows of 0, 1, C and 2 tiles: one item each, written directly
    for r in (0, 1, 2, 5):
        (item,) = by_row[r]
        assert item[1] - item[0] == ROW_TILES[r]
        assert tuple(item[3:]) == (-1, -1, 1)
    # C + 1 tiles: items of C and 1; 43 tiles: 10 items of 4 and one of 3
    assert [i[1] - i[0] for i in by_row[3]] == [C, 1]
    assert [i[1] - i[0] for i in by_row[4]] == [C] * 10 + [3]
    assert sched.n_slots == 2 + 11
    slots = np.concatenate([by_row[3][:, 3], by_row[4][:, 3]])
    assert (slots == np.arange(13)).all()  # one slot per split item, in item order
    for r in (3, 4):
        first, parts = by_row[r][:, 4], by_row[r][:, 5]
        assert (first == by_row[r][0, 3]).all() and (parts == len(by_row[r])).all()


def test_schedule_rejects_empty_items():
    with pytest.raises(ValueError, match="max_tiles"):
        b1.spmm_schedule(tiles(), 0)


def test_tile_sets_never_share_a_schedule(monkeypatch):
    """The device schedule is cached on the tile set it was built from; a new
    set (the builder, ``drop_zero_tiles``, ``to``, ``dataclasses.replace``,
    ``transpose_bcsr``) starts with an empty cache and builds its own. The
    arrival counters, one per split item and 64 columns, grow with H."""
    monkeypatch.setattr(b1, "MAX_TILES", C)
    padded = tiles(drop_padding=False)
    s_padded, counters = b1._device_schedule(padded, 128)
    assert counters.numel() == 2 * s_padded.n_slots and not counters.any()
    again = b1._device_schedule(padded, 40)
    assert again[0] is s_padded and again[1] is counters  # built once per set
    grown = b1._device_schedule(padded, 200)
    assert grown[0] is s_padded and grown[1].numel() == 4 * s_padded.n_slots
    bare = drop_zero_tiles(padded)
    others = (bare, padded.to("cpu"), dataclasses.replace(padded), gta.transpose_bcsr(bare))
    for other in others:
        assert other.cache == {}
        assert b1._device_schedule(other, 40)[0] is not s_padded
    # the padding tile moves every later item by one tile
    assert (b1._device_schedule(bare, 40)[0].items[1:, :2]
            == s_padded.items[1:, :2] - 1).all()
    monkeypatch.setattr(b1, "MAX_TILES", 2)
    assert b1._device_schedule(padded, 40)[0] is not s_padded  # keyed by C too


def scheduled_sum(b, x, max_tiles):
    """The per-tile plain products summed along the schedule's items, tile
    by tile within an item and item by item within a block row, as B1 sums."""
    parts = b1.bcsr_spmm_stream_plain(b, x)
    out = torch.zeros(b.n_block_rows * b.tm, x.shape[1])
    for begin, end, row, *_ in b1.spmm_schedule(b, max_tiles).items.tolist():
        block = torch.zeros(b.tm, x.shape[1])
        for t in range(begin, end):
            block += parts[t]
        out[row * b.tm:(row + 1) * b.tm] += block
    return out[:N_ROWS]


@pytest.mark.parametrize("h", [1, 40])
def test_scheduled_sum_matches_plain_and_jax(h):
    m = coo()
    x = np.random.default_rng(h).standard_normal((N_COLS, h)).astype(np.float32)
    b = tiles()
    got = scheduled_sum(b, torch.from_numpy(x), C)
    plain = b1.bcsr_spmm_plain(b, torch.from_numpy(x), n_rows=N_ROWS)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    assert not got[:128].any()  # the block row without tiles
    yj = np.asarray(j_bcsr_spmm(j_build_bcsr(m, (128, 128)), jnp.asarray(x), n_rows=N_ROWS))
    np.testing.assert_allclose(got.numpy(), yj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), m @ x.astype(np.float64), rtol=1e-4, atol=1e-4)


def test_scheduled_sum_bf16_tiles():
    """bf16 tiles: x rounded to bf16, the sum in f32; the scheduled sum is
    the plain version's, whatever C."""
    b = tiles(dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((N_COLS, 8))
                         .astype(np.float32))
    plain = b1.bcsr_spmm_plain(b, x, n_rows=N_ROWS)
    for max_tiles in (2, C, 8):
        torch.testing.assert_close(scheduled_sum(b, x, max_tiles), plain, rtol=1e-5, atol=1e-5)
