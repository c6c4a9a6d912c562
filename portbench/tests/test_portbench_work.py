"""The operation and byte counters against hand counts."""

from __future__ import annotations

from types import SimpleNamespace as NS

import numpy as np

from conftest import FULL
from portbench import work


def _t(shape, data=None):
    return NS(shape=tuple(shape), data=data)


def _graph(tensors, ops):
    for i, op in enumerate(ops):
        op.index = i
    return NS(tensors=tensors, ops=ops)


def test_conv_counts():
    # x [1, 10, 1, 4], w [8, 3, 1, 4], bias [8], stride 1, dilation 2:
    # 6 output rows, each 8 × 3 × 4 MACs; input rows 0..9 all read.
    ts = [_t((1, 10, 1, 4)), _t((8, 3, 1, 4), 1), _t((8,), 1),
          _t((1, 6, 1, 8))]
    op = NS(name="CONV_2D", inputs=[0, 1, 2], outputs=[3],
            options={"stride_h": 1, "dilation_h": 2})
    flop, nbytes = work.conv_work(_graph(ts, [op]), op, 2, 4)
    assert flop == 2 * 2 * 6 * 8 * 3 * 4
    assert nbytes == 4 * (2 * (10 * 4 + 6 * 8) + 8 * 3 * 4 + 8)


def test_depthwise_counts():
    # x [1, 8, 1, 4], w [1, 3, 1, 4], dilation 3: 2 output rows, taps on
    # rows {0, 3, 6, 1, 4, 7}: row 2 and 5 never read.
    ts = [_t((1, 8, 1, 4)), _t((1, 3, 1, 4), 1), _t((4,), 1),
          _t((1, 2, 1, 4))]
    op = NS(name="DEPTHWISE_CONV_2D", inputs=[0, 1, 2], outputs=[3],
            options={"stride_h": 1, "dilation_h": 3})
    flop, nbytes = work.conv_work(_graph(ts, [op]), op, 3, 2)
    assert flop == 2 * 3 * 2 * 4 * 3
    assert nbytes == 2 * (3 * (6 * 4 + 2 * 4) + 3 * 4 + 4)


def test_transpose_conv_counts_the_kept_rows():
    # x [1, 3, 1, 2], w [5, 4, 1, 2] (O, K, 1, I), stride 2: 8 full rows,
    # a STRIDED_SLICE keeps rows 2..5: 2 taps each (8), from input rows
    # {0, 1, 2}.
    ts = [_t((4,), np.array([1, 8, 1, 5])), _t((5, 4, 1, 2), 1),
          _t((1, 3, 1, 2)), _t((5,), 1), _t((1, 8, 1, 5)),
          _t((4,), np.array([0, 2, 0, 0])), _t((4,), np.array([0, 6, 1, 5])),
          _t((4,), np.array([1, 1, 1, 1])), _t((1, 4, 1, 5))]
    tconv = NS(name="TRANSPOSE_CONV", inputs=[0, 1, 2, 3], outputs=[4],
               options={"stride_h": 2})
    crop = NS(name="STRIDED_SLICE", inputs=[4, 5, 6, 7], outputs=[8],
              options={"begin_mask": 13, "end_mask": 13})
    flop, nbytes = work.conv_work(_graph(ts, [tconv, crop]), tconv, 1, 4)
    assert flop == 2 * 8 * 2 * 5
    assert nbytes == 4 * (3 * 2 + 4 * 5 + 5 * 4 * 2 + 5)


def test_full_fixture_tick_work():
    """The tick's operations grow with the batch, and the RVQ search is
    counted at the mix's stages."""
    cfg = {"mode": "float", "model_dir": FULL}
    one, two = work.Work(cfg, 1, 120), work.Work(cfg, 2, 120)
    assert two.tick_flop() == 2 * one.tick_flop()
    assert one.rvq()[0] == 30 * (16 * 2 * 64 + 64)
    bf16 = work.Work({"mode": "bf16", "model_dir": FULL}, 1, 120)
    assert bf16.elem == 2 and bf16.peak == 989e12
