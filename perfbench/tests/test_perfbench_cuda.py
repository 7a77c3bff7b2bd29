"""On the card: each cell's control, at the cell's own size, on three
seeds, comes out not correct while the program comes out correct.  Skips
where there is no CUDA device."""

import pytest

from perfbench import checks, control, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["u500x8.k41_run", "n4.k40_map"])
def test_control_at_cell_size(cell, cuda_device):
    c = run.Cell(cell, run.load_json(run.REPO / "BENCHMARK.json"))
    for seed, nums in control.readings(c, [11, 12, 13], cuda_device):
        assert checks.judge(nums["program"], c.limits), (seed, nums)
        assert not checks.judge(nums["control"], c.limits), (seed, nums)
