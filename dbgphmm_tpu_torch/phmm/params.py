"""PHMM parameter set (ref: src/hmmv2/params.rs:16-187).

Nine transition probabilities of the profile HMM derived from
(p_mismatch, p_gap_open, p_gap_ext, p_end), plus the sparse-DP operating
knobs (n_active_nodes, n_warmup, score ratio, max consecutive deletions).
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass, field

# ref: src/hmmv2/table.rs:17-22
MAX_DEL = 4
MAX_ACTIVE_NODES = 400


@dataclass
class PHMMParams:
    p_mismatch: float
    p_gap_open: float
    p_gap_ext: float
    p_end: float
    n_active_nodes: int = 40
    n_warmup: int = 50
    active_node_max_ratio: float = 30.0
    warmup_threshold: int = MAX_ACTIVE_NODES // 2
    n_max_gaps: int = MAX_DEL

    # derived (filled in __post_init__)
    p_match: float = field(init=False)
    p_random: float = field(init=False)
    p_MM: float = field(init=False)
    p_IM: float = field(init=False)
    p_DM: float = field(init=False)
    p_MI: float = field(init=False)
    p_II: float = field(init=False)
    p_DI: float = field(init=False)
    p_MD: float = field(init=False)
    p_ID: float = field(init=False)
    p_DD: float = field(init=False)

    def __post_init__(self):
        # ref: params.rs:84-113
        self.p_match = 1.0 - self.p_mismatch
        self.p_random = 0.25
        self.p_MM = 1.0 - 2.0 * self.p_gap_open - self.p_end
        self.p_IM = 1.0 - self.p_gap_open - self.p_gap_ext - self.p_end
        self.p_DM = self.p_IM
        self.p_MI = self.p_gap_open
        self.p_MD = self.p_gap_open
        self.p_ID = self.p_gap_open
        self.p_DI = self.p_gap_open
        self.p_II = self.p_gap_ext
        self.p_DD = self.p_gap_ext

    # -- constructors (ref: params.rs:116-148) --------------------------------

    @staticmethod
    def uniform(p: float) -> "PHMMParams":
        return PHMMParams(
            p_mismatch=p, p_gap_open=p, p_gap_ext=p, p_end=0.00001,
            n_active_nodes=40, n_warmup=50,
        )

    @staticmethod
    def default() -> "PHMMParams":
        return PHMMParams.uniform(0.01)

    @staticmethod
    def mid_error_2() -> "PHMMParams":
        return PHMMParams.uniform(0.02)

    @staticmethod
    def mid_error() -> "PHMMParams":
        return PHMMParams.uniform(0.05)

    @staticmethod
    def high_error() -> "PHMMParams":
        return PHMMParams.uniform(0.1)

    @staticmethod
    def zero_error() -> "PHMMParams":
        return PHMMParams.uniform(0.0)

    def p_error(self) -> float:
        """p_mut + p_ins + p_del (ref: params.rs:152-154)."""
        return self.p_MI + self.p_MD + self.p_mismatch

    # -- log-space views ------------------------------------------------------

    def _lg(self, p: float) -> float:
        return math.log(p) if p > 0 else float("-inf")

    def log_transitions(self) -> dict:
        """All nine transitions + emissions as log probs, for kernel use."""
        return {
            name: self._lg(getattr(self, name))
            for name in (
                "p_MM", "p_IM", "p_DM", "p_MI", "p_II", "p_DI",
                "p_MD", "p_ID", "p_DD", "p_match", "p_mismatch",
                "p_random", "p_end",
            )
        }

    # -- serde ---------------------------------------------------------------

    def to_json(self) -> str:
        keep = dict(
            p_mismatch=self.p_mismatch, p_gap_open=self.p_gap_open,
            p_gap_ext=self.p_gap_ext, p_end=self.p_end,
            n_active_nodes=self.n_active_nodes, n_warmup=self.n_warmup,
            active_node_max_ratio=self.active_node_max_ratio,
            warmup_threshold=self.warmup_threshold, n_max_gaps=self.n_max_gaps,
        )
        return json.dumps(keep)

    @staticmethod
    def from_json(s: str) -> "PHMMParams":
        return PHMMParams(**json.loads(s))
