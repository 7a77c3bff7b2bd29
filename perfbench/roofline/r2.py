"""R2, the backward-by-forward decode's scan (``csrc/refine.cu``, launched
by ``ops.adaptive.decode_tops``).

Bytes: the model's arrays (emission, children and their transitions),
codes, lens and the stored forward tables (nodes and three states
[L, B, K] in their type, offsets [L, B], e [B]) read once; the per-step
top k (log-probabilities and nodes [L, B, k]) written once.  As R1, bound
by bytes; no operation is counted."""

HOOK = ("ops.adaptive", "decode_tops")
KERNEL = r"\brefine_decode\b"


def record(dm, codes, lens, f, k, max_ratio):
    L, B, K = f.nodes.shape
    el = dm.init_logp.element_size()
    model = sum(t.numel() * t.element_size() for t in (
        dm.emission, dm.child_idx, dm.child_logt))
    return dict(B=B, L=L, K=K, k=int(k), el=el, stored=f.m.element_size(),
                model=model, codes=codes.numel())


def work(rec):
    B, L, K, k, el = rec["B"], rec["L"], rec["K"], rec["k"], rec["el"]
    nbytes = (rec["model"] + 4 * rec["codes"] + 4 * B
              + L * B * K * (4 + 3 * rec["stored"]) + L * B * el + B * el
              + L * B * k * (el + 4))
    return 0, nbytes
