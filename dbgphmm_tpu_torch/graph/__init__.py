"""Host-side graph algorithms (ref: src/graph/ + petgraph/petgraph_algos)."""

from .digraph import DiGraph  # noqa: F401
from .bipartite import Bipartite  # noqa: F401
from .shortest_cycle import shortest_cycle  # noqa: F401
from . import compact, euler, k_shortest, utils  # noqa: F401
