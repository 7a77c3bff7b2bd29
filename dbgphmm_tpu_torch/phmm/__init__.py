"""Profile HMM engine (ref: src/hmmv2/).

The PHMM over a sequence graph: states are (node, Match/Ins/Del) plus
Begin/End.  Host side holds the model as flat arrays
(:class:`~dbgphmm_tpu.phmm.model.PHMMModel`); the forward/backward DP runs on
device via :mod:`dbgphmm_tpu.ops`.
"""

from .params import PHMMParams  # noqa: F401
from .model import PHMMModel, seq_graph_to_phmm, linear_phmm  # noqa: F401
