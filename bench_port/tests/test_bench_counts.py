"""The FLOP and byte counts on molecules small enough to count by hand."""

import numpy as np
import pytest

from bench_port.counts import work

# a triangle of side 1.2 A: every atom has degree 2
TRIANGLE = np.array([[0, 0, 0], [1.2, 0, 0], [0.6, 1.0, 0]], np.float32)
SMALL = {"in_channels": 8, "heads": 2, "sbf_dim": 2, "rbf_dim": 1,
         "embedding_size": 2, "edge_feat_dim": 3, "conv_layers": 1,
         "mlp_depth": 2}


def test_stats_of_a_triangle_and_a_pair():
    assert work.mol_stats(TRIANGLE, 5.0) == work.Stats(1, 3, 6, 6, 6, 3)
    pair = TRIANGLE[:2]
    assert work.mol_stats(pair, 5.0) == work.Stats(1, 2, 2, 0, 0, 0)
    far = np.array([[0, 0, 0], [9, 0, 0]], np.float32)
    assert work.mol_stats(far, 5.0) == work.Stats(1, 2, 0, 0, 0, 0)
    s = work.total([work.mol_stats(TRIANGLE, 5.0)] * 2)
    assert s == work.Stats(2, 6, 12, 12, 12, 6)


def test_attention_counts_by_hand():
    s = work.mol_stats(TRIANGLE, 5.0)
    ops, nbytes = work.attn_fwd(s, SMALL)
    # 6 pairs x (8 (2L+5) + 2 heads), 6 keys x 2 L K C
    assert ops == 6 * (8 * 9 + 2) + 6 * 2 * 2 * 1 * 8
    # q 48, k v 96, radial 12, cos 6, e 24, ids 12, W b 24, out 48 words
    assert nbytes == 4 * 270
    bops, bbytes = work.attn_bwd(s, SMALL)
    assert bops == 6 * (8 * (4 * 2 + 17) + 6 * 2) + 6 * 4 * 2 * 1 * 8
    # + g 48, dq dk dv 144, de 24, dW db 24, - out 48
    assert bbytes == nbytes + 4 * (48 + 144 + 24 + 24 - 48)


def test_model_flops_by_hand():
    s = work.Stats(1, 2, 2, 0, 0, 0)
    m = {"in_channels": 4, "heads": 1, "sbf_dim": 1, "rbf_dim": 1,
         "embedding_size": 2, "edge_feat_dim": 3, "conv_layers": 1,
         "mlp_depth": 2}
    # featurization 112, embedding 48, two readouts 192, one conv 752
    assert work.gemm_flops(s, m) == 112 + 48 + 192 + 752
    assert work.step_flops(s, m) == 3 * work.gemm_flops(s, m)


def test_bound_is_the_slower_peak():
    assert work.bound_s(67e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 6.7e12) == pytest.approx(2.0)
