"""The port's native flow binding (dbgphmm_tpu_torch.flow.native): the
return code it leaves for callers when a solve falls back to the Python
solver."""

from dbgphmm_tpu_torch.flow import mincost, native
from dbgphmm_tpu_torch.multi_dbg import MultiDbg
from dbgphmm_tpu_torch.multi_dbg import draft
from dbgphmm_tpu_torch.seq.collection import StyledSequence


class _TimedOut:
    """A native library whose solves run out of their budget (rc 2)."""

    @staticmethod
    def dbg_min_cost_flow_convex(*_args):
        return 2


def test_fallback_after_a_failing_native_solve_resets_last_rc(monkeypatch,
                                                              capsys):
    """A native solve times out (LAST_RC 2); the next solves fall back to
    the Python solver (the library unavailable), which finds no flow: the
    code is the fallback's own (1), so the draft's MSE re-init reports
    "infeasible", not a stale "timeout", and keeps the previous copy
    numbers.  A fallback that solves leaves 0."""
    dbg = MultiDbg.from_styled_seqs(8, [StyledSequence.linear(
        b"TTAGGCTTCGATCGAATGCCTTAGGCTT")])
    freqs = [1.0] * dbg.n_edges_full()
    net = draft.mse_network_from_freqs(dbg, freqs, 1.0)
    monkeypatch.setattr(native, "_load", lambda: _TimedOut)
    assert native.solve(net) is None and native.LAST_RC == 2

    monkeypatch.setattr(native, "_load", lambda: None)
    solved = native.solve(net)
    assert solved is not None and native.LAST_RC == 0
    native.LAST_RC = 2
    monkeypatch.setattr(mincost, "min_cost_flow_convex", lambda _net: None)
    previous = list(dbg.get_copy_nums())
    got = draft.min_squared_error_copy_nums_from_freqs(
        dbg, freqs, 1.0, fallback_copy_nums=previous)
    out = capsys.readouterr().out
    assert got == previous and native.LAST_RC == 1
    assert "mse flow solve failed twice (infeasible)" in out, out
    assert "timeout" not in out
