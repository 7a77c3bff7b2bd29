"""Transition-usage expectations (edge freqs) and init freqs.

PyTorch counterpart of ``dbgphmm_tpu/ops/freqs.py`` (ref:
src/hmmv2/freq.rs:276-389 to_edge_and_init_freqs): the expected number of
times each PHMM transition (adjacency slot ``[n, D]``, aligned with
``DeviceModel.child_idx``) and each Begin -> node transition was used while
emitting the reads.  Consumed by the Q score (``phmm.q``).
"""

from __future__ import annotations

import torch

from .forward import (NEG, DeviceModel, _b_init, _b_step, _p_match_emit,
                      _reverse_codes, forward_tables)


@torch.no_grad()
def trans_and_init_freqs(dm: DeviceModel, codes: torch.Tensor,
                         lens: torch.Tensor, renorm: bool = False):
    """Returns (slot_freqs [B, n, D], init_freqs [B, n], logp [B]), linear
    (ref: freq.rs:332-389, accumulated over i = 0..=n)."""
    B, L = codes.shape
    n = dm.emission.shape[0]
    dt, dev = dm.dtype, dm.device
    lt = dm.lt
    ar = torch.arange(B, device=dev)
    lens_l = lens.long()
    cidx = dm.child_idx.long()
    logt = dm.child_logt

    f_final, f_tabs = forward_tables(dm, codes, lens, renorm=renorm)
    logp = f_final.e + f_final.off

    # i = n: only the *D transitions, B[n] = b_init (d = p_end)
    bst = _b_init(dm, (B,), n, dt)
    scale_n = (f_final.off - logp)[:, None, None]
    bd_l = bst.d[:, cidx]
    fm_k, fi_k, fd_k = (a[:, :, None] for a in (f_final.m, f_final.i, f_final.d))
    slot_freqs = (torch.exp(fm_k + logt + lt.MD + bd_l + scale_n)
                  + torch.exp(fi_k + logt + lt.ID + bd_l + scale_n)
                  + torch.exp(fd_k + logt + lt.DD + bd_l + scale_n))
    init_freqs = (
        torch.exp(f_final.mb[:, None] + dm.init_logp + lt.MD + bst.d + scale_n[:, :, 0])
        + torch.exp(f_final.ib[:, None] + dm.init_logp + lt.ID + bst.d
                    + scale_n[:, :, 0]))

    xs_t = _reverse_codes(codes, lens).t()
    for t in range(L):
        x, valid = xs_t[t], t < lens
        i_merge = lens_l - 1 - t  # the interval index i being accumulated
        bi2 = bst  # B[i+1]
        bst = _b_step(dm, bst, x, valid, renorm, cidx)  # B[i]

        # F[i]: the init table if i == 0, else tables[i-1]
        i_f = (i_merge - 1).clamp(0, L - 1)
        is_init = i_merge == 0
        init1 = is_init[:, None]
        fm = torch.where(init1, NEG, f_tabs.m[i_f, ar])
        fi = torch.where(init1, NEG, f_tabs.i[i_f, ar])
        fd = torch.where(init1, NEG, f_tabs.d[i_f, ar])
        fmb = torch.where(is_init, 0.0, f_tabs.mb[i_f, ar])
        fib = torch.where(is_init, NEG, f_tabs.ib[i_f, ar])
        foff = torch.where(is_init, 0.0, f_tabs.off[i_f, ar])

        p_emit = _p_match_emit(dm, x)
        p_emit_l = p_emit[:, cidx]
        bm2_l = bi2.m[:, cidx]
        bd1_l = bst.d[:, cidx]
        sc_m = (foff + bi2.off - logp)[:, None, None]
        sc_d = (foff + bst.off - logp)[:, None, None]
        fm_k, fi_k, fd_k = fm[:, :, None], fi[:, :, None], fd[:, :, None]
        contrib = (
            torch.exp(fm_k + logt + lt.MM + p_emit_l + bm2_l + sc_m)
            + torch.exp(fi_k + logt + lt.IM + p_emit_l + bm2_l + sc_m)
            + torch.exp(fd_k + logt + lt.DM + p_emit_l + bm2_l + sc_m)
            + torch.exp(fm_k + logt + lt.MD + bd1_l + sc_d)
            + torch.exp(fi_k + logt + lt.ID + bd1_l + sc_d)
            + torch.exp(fd_k + logt + lt.DD + bd1_l + sc_d)
        )
        slot_freqs = slot_freqs + torch.where(valid[:, None, None], contrib, 0.0)

        # Begin -> v transitions
        sm, sd = sc_m[:, :, 0], sc_d[:, :, 0]
        contrib0 = (
            torch.exp(fmb[:, None] + dm.init_logp + lt.MM + p_emit + bi2.m + sm)
            + torch.exp(fib[:, None] + dm.init_logp + lt.IM + p_emit + bi2.m + sm)
            + torch.exp(fmb[:, None] + dm.init_logp + lt.MD + bst.d + sd)
            + torch.exp(fib[:, None] + dm.init_logp + lt.ID + bst.d + sd)
        )
        init_freqs = init_freqs + torch.where(valid[:, None], contrib0, 0.0)
    return slot_freqs, init_freqs, logp
