"""R1, the mapping-constrained forward storing its tables
(``csrc/refine.cu``, launched by ``ops.adaptive.forward_mapped_tables``).

Bytes: the model's arrays (emission, start, parents and their
transitions), codes, lens and the hint's node sets [B, L, A] read once;
nodes and three states [L, B, A], the offsets [L, B] and e [B] written
once.  R1 is bound by these bytes (its exp / log per live slot-step came
to about half of them in the port's own count), so no operation is
counted."""

HOOK = ("ops.adaptive", "forward_mapped_tables")
KERNEL = r"\brefine_forward\b"


def record(dm, codes, lens, map_nodes):
    B, L, A = map_nodes.shape
    el = dm.init_logp.element_size()
    model = sum(t.numel() * t.element_size() for t in (
        dm.emission, dm.init_logp, dm.parent_idx, dm.parent_logt))
    return dict(B=B, L=L, A=A, el=el, model=model, codes=codes.numel())


def work(rec):
    B, L, A, el = rec["B"], rec["L"], rec["A"], rec["el"]
    nbytes = (rec["model"] + 4 * rec["codes"] + 4 * B + 4 * B * L * A
              + L * B * A * (4 + 3 * el) + L * B * el + B * el)
    return 0, nbytes
