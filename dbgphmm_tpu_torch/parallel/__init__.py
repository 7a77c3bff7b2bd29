"""Multi-device scale-out (ref: SURVEY.md section 2.11).

Counterpart of ``dbgphmm_tpu/parallel``.  The reference's only parallel
axis is a thread pool over reads; here it becomes a ``("cand", "reads")``
mesh of torch devices (:class:`Mesh`): read batches split across devices,
candidate copy-number assignments across a second axis, the graph arrays
replicated, and the per-shard results gathered to the host — across
``torch.distributed`` ranks by an all-gather over gloo
(:mod:`.multihost`).
"""

from .sharding import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_read_axis_size,
    put_read_sharded,
    put_replicated,
    sharded_candidate_log_likelihoods,
    sharded_forward_total,
)
