"""The kernels' work counts on toy shapes, by hand."""

import numpy as np
import torch

from perfbench import run
from perfbench.roofline import peaks

RL = run.rooflines()


class _DM:
    """The fields of a program DeviceModel that the counts read."""

    def __init__(self, n, D, finite_parents, dtype=torch.float32):
        self.n_max_gaps = 4
        self.emission = torch.zeros(n, dtype=torch.int32)
        self.init_logp = torch.zeros(n, dtype=dtype)
        self.parent_idx = torch.zeros((n, D), dtype=torch.int32)
        logt = torch.full((n, D), float("-inf"), dtype=dtype)
        for v, p in enumerate(finite_parents):
            logt[v, :p] = -1.0
        self.parent_logt = logt
        self.child_idx = torch.zeros((n, D), dtype=torch.int32)
        self.child_logt = logt.clone()


class _Tabs:
    def __init__(self, L, B, K, dtype=torch.float32):
        self.nodes = torch.zeros((L, B, K), dtype=torch.int32)
        self.m = torch.zeros((L, B, K), dtype=dtype)


def test_a1_counts_every_node_at_every_position_inside_its_read():
    dm = _DM(3, 2, [0, 1, 2])
    dm.init_logp[0] = float("-inf")  # node 0: no parent, no start: padding
    lens = torch.tensor([5, 2])
    rec = RL["a1"].record(dm, None, torch.zeros((2, 5)), lens,
                          _Tabs(5, 2, 4), None, A=4, K=4, W=3)
    ops, nbytes = RL["a1"].work(rec)
    # G = 4: 26 + 6 S per node, S = P + 1 where P > 0: nodes 1 and 2
    assert ops == ((26 + 6 * 2) + (26 + 6 * 3)) * (3 + 2)
    model = 3 * 4 + 3 * 4 + 6 * 4 + 6 * 4
    assert nbytes == (model + 4 * 10 + 4 * 2 + 2 * 4 * 16 + 5 * 2 * 4
                      + 3 * 2 * 4 * 16 + 3 * 2 * 4 + 2 * 4)


def test_r1_r2_count_each_byte_once():
    dm = _DM(10, 2, [1] * 10)
    rec = RL["r1"].record(dm, torch.zeros((3, 7), dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32),
                          torch.zeros((3, 7, 8), dtype=torch.int32))
    ops, nbytes = RL["r1"].work(rec)
    model = 10 * 4 + 10 * 4 + 20 * 4 + 20 * 4
    assert ops == 0
    assert nbytes == model + 21 * 4 + 12 + 4 * 168 + 168 * 16 + 21 * 4 + 12
    rec = RL["r2"].record(dm, torch.zeros((3, 7), dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), _Tabs(7, 3, 8),
                          k=5, max_ratio=None)
    ops, nbytes = RL["r2"].work(rec)
    model = 10 * 4 + 20 * 4 + 20 * 4
    assert nbytes == (model + 21 * 4 + 12 + 168 * 16 + 21 * 4 + 12
                      + 7 * 3 * 5 * 8)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert peaks.bound_s(0, peaks.HBM_BYTES_PER_S) == 1.0
    assert peaks.bound_s(peaks.MUFU_PER_S, 1.0) == 1.0
    assert np.isclose(peaks.MUFU_PER_S, 16 * 132 * 1.98e9)
