"""A1, the dense step of the sparse-adaptive forward (``csrc/adaptive.cu``,
launched by ``ops.adaptive.adaptive_dense``).

Operations: at every warm-up position inside its read, every node of the
graph (not the padding) takes the exp / log of one cell-step: 18 + 2G +
(2 + G) S, S = P + 1 for P parents with a finite transition (0 where P =
0), G = n_max_gaps: the recursion's log-sum-exps (M, I, the closure's first
value and G rounds) and the ladd3 that ranks the cell.  Bytes: the model's
arrays, codes and lens read once; the stored rows [W, B, K] (nodes and
three states), their offsets and e, and the carry to A2 written once."""

import torch

HOOK = ("ops.adaptive", "adaptive_dense")
KERNEL = r"\badaptive_dense\b"


def record(dm, lt, codes, lens, out, carry, A, K, W):
    return dict(dm=dm, lens=lens, W=int(W), A=int(A), K=int(K),
                codes=codes.numel(), B=int(lens.numel()),
                stored=out.m.element_size())


def work(rec):
    dm = rec["dm"]
    G = dm.n_max_gaps
    P = torch.isfinite(dm.parent_logt).sum(1)
    S = (P + 1) * (P > 0)
    real = torch.isfinite(dm.init_logp) | (P > 0)
    cost = int(((18 + 2 * G + (2 + G) * S) * real).sum())
    positions = int(rec["lens"].clamp(max=rec["W"]).sum())
    el = dm.init_logp.element_size()
    B, A, K, W = rec["B"], rec["A"], rec["K"], rec["W"]
    model = sum(t.numel() * t.element_size() for t in (
        dm.emission, dm.init_logp, dm.parent_idx, dm.parent_logt))
    nbytes = (model + 4 * rec["codes"] + 4 * B
              + B * A * (4 + 3 * el) + 5 * B * el
              + W * B * K * (4 + 3 * rec["stored"]) + W * B * el + B * el)
    return cost * positions, nbytes
