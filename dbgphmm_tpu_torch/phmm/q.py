"""EM Q-function score (ref: src/hmmv2/q.rs:12-96).

``Q = sum_v A(Begin,v) log p_init(v) + sum_(v,w) A(v,w) log p_trans(v,w)``
where A are expected transition usages from the forward/backward decode.
Used to evaluate copy-number assignments cheaply in EM style.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class QScore:
    init: float
    trans: float
    prior: float = 0.0

    def total(self) -> float:
        return self.init + self.trans + self.prior

    def sub(self, other: "QScore") -> "QScore":
        return QScore(
            self.init - other.init, self.trans - other.trans,
            self.prior - other.prior,
        )

    def __str__(self) -> str:
        return f"{self.total()}(init={self.init} trans={self.trans} prior={self.prior})"


def q_score_exact(model, slot_freqs: np.ndarray, init_freqs: np.ndarray) -> QScore:
    """Contract usage expectations against log probabilities
    (ref: q.rs:62-96 q_score_exact).

    * ``model``: PHMMModel (host arrays)
    * ``slot_freqs`` [n, D]: per-adjacency-slot transition usages (summed
      over reads), aligned with model.child_idx/child_logt
    * ``init_freqs`` [n]: Begin->v usages
    """
    n = model.emission.shape[0]
    # device freqs may be bucket-padded beyond the model's node count
    slot_freqs = slot_freqs[:n, : model.child_idx.shape[1]]
    init_freqs = init_freqs[:n]
    emit = model.emission < 4
    init_ok = emit & np.isfinite(model.init_logp)
    init = float(np.sum(init_freqs[init_ok] * model.init_logp[init_ok]))

    # transitions between emittable nodes with finite trans prob
    child_emit = emit[model.child_idx]
    ok = (
        emit[:, None]
        & child_emit
        & np.isfinite(model.child_logt)
    )
    trans = float(np.sum(np.where(ok, slot_freqs * model.child_logt, 0.0)))
    return QScore(init=init, trans=trans, prior=0.0)
