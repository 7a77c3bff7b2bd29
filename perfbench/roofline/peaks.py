"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full power limit of 700 W): the rooflines are shares of
these, whatever limit the card in a run was set to (the run prints it)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
SMS = 132
BOOST_CLOCK_HZ = 1.98e9
# exp2 / log2 on the special function units: 16 per SM per clock
MUFU_PER_S = 16 * SMS * BOOST_CLOCK_HZ


def bound_s(ops: float, nbytes: float) -> float:
    """The least time for ``ops`` transcendentals and ``nbytes`` of
    memory traffic."""
    return max(ops / MUFU_PER_S, nbytes / HBM_BYTES_PER_S)
