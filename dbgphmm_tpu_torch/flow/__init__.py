"""Integer min-cost circulation with convex edge costs + residual-graph
neighbor enumeration.

Re-implementation (from first principles) of the API surface the reference
consumes from the external ``rustflow`` crate (ref: SURVEY.md section 2.8;
call sites in src/multi_dbg/{draft,neighbors}.rs, src/hashdbg.rs:561).
"""

from .mincost import FlowEdge, min_cost_flow_convex  # noqa: F401
from .residue import (  # noqa: F401
    DOWN,
    UP,
    ResidueEdge,
    enumerate_neighboring_flows,
    find_neighboring_flow_by_edge_change,
    flow_to_residue_convex,
    is_edge_simple,
    residue_graph_cycle_to_flow,
    update_cycle_from_str,
    update_cycle_to_str,
)
