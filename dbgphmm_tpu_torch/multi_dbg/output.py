"""Serialization of MultiDbg and posterior results — DBG / PATHS / MAP / GFA /
POST / INSPECT formats, compatible with the reference's text formats
(ref: src/multi_dbg/output.rs, src/multi_dbg/posterior/output.rs).

These files are the checkpoint/resume story: every k iteration dumps
``.k{k}.dbg/.post/.gfa/.inspect/.mpz`` and inference can restart from any of
them (ref: SURVEY.md section 5 checkpoint/resume).
"""

from __future__ import annotations

import gzip
import math
from pathlib import Path as _P
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..prob import NEG_INF
from ..seq.collection import NULL_BASE
from ..seq.io import open_maybe_gzip
from . import MultiCompactEdge, MultiCompactNode, MultiDbg, MultiFullEdge, MultiFullNode
from ..graph.digraph import DiGraph

VERSION_COMMENT = "dbgphmm_tpu"


def _fmt_copy_nums(cn: Sequence[int]) -> str:
    return "[" + ",".join(str(x) for x in cn) + "]"


def _parse_copy_nums(s: str) -> List[int]:
    s = s.strip().lstrip("[").rstrip("]")
    if not s:
        return []
    return [int(x) for x in s.split(",")]


# -- DBG format (ref: output.rs:155-356) --------------------------------------


def to_dbg_string(dbg: MultiDbg) -> str:
    lines = [f"# {VERSION_COMMENT}", f"K\t{dbg.k}"]
    for v in range(dbg.n_nodes_compact()):
        lines.append(f"N\t{v}\t{dbg.km1mer_compact(v).decode('ascii')}")
    for e in range(dbg.n_edges_compact()):
        s, t = dbg.compact.edge_endpoints(e)
        lines.append(
            "E\t{}\t{}\t{}\t{}\t{}\t{}".format(
                e, s, t,
                dbg.kmer_compact(e).decode("ascii"),
                dbg.copy_num_of_edge_in_compact(e),
                ",".join(str(ef) for ef in dbg.edges_in_full(e)),
            )
        )
    return "\n".join(lines) + "\n"


def to_dbg_file(dbg: MultiDbg, path) -> None:
    with open_maybe_gzip(path, "wt") as f:
        f.write(to_dbg_string(dbg))


def from_dbg_string(s: str) -> MultiDbg:
    """(ref: output.rs:205-341 from_dbg_reader)"""
    k = None
    nodes: List[Tuple[int, bytes]] = []
    edges = []
    n_bases = 0
    for line in s.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if parts[0] == "K":
            k = int(parts[1])
        elif parts[0] == "N":
            idx = int(parts[1])
            assert idx == len(nodes), "node is not sorted"
            nodes.append((idx, parts[2].encode("ascii")))
        elif parts[0] == "E":
            assert k is not None
            idx, sidx, tidx = int(parts[1]), int(parts[2]), int(parts[3])
            kmer = parts[4].encode("ascii")
            seq = kmer[k - 1 :]
            n_bases += len(seq)
            copy_num = int(parts[5])
            edges_in_full = [int(x) for x in parts[6].split(",")]
            assert len(edges_in_full) == len(seq)
            assert idx == len(edges), "edge is not sorted"
            edges.append((idx, sidx, tidx, seq, copy_num, edges_in_full))

    assert k is not None, "no K section"
    full = DiGraph()
    for _idx, km1 in nodes:
        full.add_node(MultiFullNode(all(b == NULL_BASE for b in km1)))
    placed: List[Optional[Tuple[int, int, MultiFullEdge]]] = [None] * n_bases
    for _idx, sidx, tidx, seq, copy_num, eif in edges:
        n = len(seq)
        w_prev = None
        for i in range(n):
            v = sidx if i == 0 else w_prev
            w = tidx if i == n - 1 else full.add_node(MultiFullNode(False))
            placed[eif[i]] = (v, w, MultiFullEdge(seq[i], copy_num))
            w_prev = w
    for i, entry in enumerate(placed):
        assert entry is not None, f"full edge {i} missing"
        v, w, ew = entry
        e = full.add_edge(v, w, ew)
        assert e == i

    compact = DiGraph()
    for _idx, km1 in nodes:
        compact.add_node(
            MultiCompactNode(all(b == NULL_BASE for b in km1), 0)
        )
    for _idx, sidx, tidx, _seq, _cn, eif in edges:
        compact.add_edge(sidx, tidx, MultiCompactEdge(eif))
    # fix node_in_full pointers
    for v in range(compact.n_nodes()):
        w = compact.node(v)
        if compact.out_edges(v):
            ef0 = compact.edge(compact.out_edges(v)[0]).edges_in_full[0]
            w.node_in_full = full.edge_sources[ef0]
        elif compact.in_edges(v):
            ef0 = compact.edge(compact.in_edges(v)[0]).edges_in_full[-1]
            w.node_in_full = full.edge_targets[ef0]
    return MultiDbg(k, full, compact)


def from_dbg_file(path) -> MultiDbg:
    with open_maybe_gzip(path, "rt") as f:
        return from_dbg_string(f.read())


# -- PATHS format (ref: output.rs:360-450) ------------------------------------


def to_paths_string(paths: Sequence[Sequence[int]]) -> str:
    return "".join(
        "P\t" + ",".join(str(e) for e in path) + "\n" for path in paths
    )


def to_paths_file(paths, path) -> None:
    _P(path).write_text(to_paths_string(paths))


def from_paths_string(s: str) -> List[List[int]]:
    out = []
    for line in s.splitlines():
        if line.startswith("P"):
            out.append([int(x) for x in line.split()[1].split(",")])
    return out


def from_paths_file(path) -> List[List[int]]:
    return from_paths_string(_P(path).read_text())


# -- MAP format (ref: output.rs:455-625) --------------------------------------


def to_map_string(dbg: MultiDbg, reads, mappings) -> str:
    lines = [
        f"# {VERSION_COMMENT}",
        f"# k={dbg.k} n_edges_full={dbg.n_edges_full()} "
        f"n_edges_compact={dbg.n_edges_compact()}",
        "# read\tpos\tbase\tnodes_and_probs",
    ]
    for i, read in enumerate(reads):
        lines.append(f"# i={i}")
        nodes_i = mappings.nodes[i]
        logps_i = mappings.logps[i]
        for j, base in enumerate(read):
            valid = nodes_i[j] >= 0
            pairs = ",".join(
                f"{int(n)}:{float(lp)}"
                for n, lp in zip(nodes_i[j][valid], logps_i[j][valid])
            )
            # never emit an empty pairs column: the reference's
            # from_map_reader_raw unwraps it (ADVICE r2) — write a
            # zero-weight sentinel pair instead
            lines.append(f"{i}\t{j}\t{chr(base)}\t{pairs or '0:-inf'}")
    return "\n".join(lines) + "\n"


def to_map_file(dbg: MultiDbg, path, reads, mappings) -> None:
    p = _P(path)
    mode_gzip = p.suffix in (".gz", ".mpz")
    if mode_gzip:
        # level 1: the per-k .mpz dumps are on the inference loop's critical
        # path; default level 9 costs seconds per k for a few % size
        opener = lambda q, m: gzip.open(q, m, compresslevel=1)
    else:
        opener = open
    with opener(p, "wt") as f:
        f.write(to_map_string(dbg, reads, mappings))


def from_map_file(path):
    """Returns Mappings (ref: output.rs from_map_reader)."""
    from .posterior import Mappings

    p = _P(path)
    opener = gzip.open if p.suffix in (".gz", ".mpz") else open
    per_read: Dict[int, Dict[int, List[Tuple[int, float]]]] = {}
    with opener(p, "rt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.rstrip("\n").split("\t")
            i, j = int(parts[0]), int(parts[1])
            pairs = []
            if len(parts) > 3 and parts[3]:
                for item in parts[3].split(","):
                    n, lp = item.split(":")
                    lp = float(lp)
                    if lp == float("-inf"):
                        continue  # zero-weight sentinel (empty row)
                    pairs.append((int(n), lp))
            per_read.setdefault(i, {})[j] = pairs
    nodes, logps = [], []
    # iterate the full index range: a read absent from a (truncated) dump
    # must yield an EMPTY mapping, not silently shift all later reads'
    # mappings onto the wrong reads (ADVICE r2)
    n_total = max(per_read) + 1 if per_read else 0
    for i in range(n_total):
        read_map = per_read.get(i, {})
        L = max(read_map) + 1 if read_map else 0
        A = max((len(v) for v in read_map.values()), default=1)
        narr = np.full((L, max(A, 1)), -1, dtype=np.int32)
        parr = np.full((L, max(A, 1)), NEG_INF)
        for j, pairs in read_map.items():
            for a, (n, lp) in enumerate(pairs):
                narr[j, a] = n
                parr[j, a] = lp
        nodes.append(narr)
        logps.append(parr)
    return Mappings(nodes, logps)


# -- GFA format (ref: output.rs:628-775) --------------------------------------


def to_gfa_string(dbg: MultiDbg, label=None, color=None) -> str:
    if label is None:
        label = lambda e: dbg.seq_compact(e).decode("ascii")
    if color is None:
        color = lambda e: (0, 255, 0)
    lines = []
    for e in range(dbg.n_edges_compact()):
        seq = dbg.seq_compact(e)
        r, g, b = color(e)
        lines.append(
            "S\t{}\t{}\tDP:f:{}\tLN:i:{}\tLB:Z:{}\tCL:Z:#{:02x}{:02x}{:02x}".format(
                e,
                seq.decode("ascii"),
                dbg.copy_num_of_edge_in_compact(e),
                len(seq),
                label(e),
                r, g, b,
            )
        )
    terminal = dbg.terminal_node_compact()
    for v in range(dbg.n_nodes_compact()):
        if terminal is not None and v == terminal:
            continue
        for in_e, _p, _w in dbg.compact.parents(v):
            for out_e, _c, _w2 in dbg.compact.childs(v):
                lines.append(f"L\t{in_e}\t+\t{out_e}\t+\t0M\tID:Z:{v}")
    return "\n".join(lines) + "\n"


def to_gfa_file(dbg: MultiDbg, path) -> None:
    _P(path).write_text(to_gfa_string(dbg))


def to_gfa_post_string(dbg: MultiDbg, posterior, copy_nums_true=None) -> str:
    """GFA with posterior mean + red/blue over/under coloring
    (ref: output.rs:718-775)."""

    def label(e):
        dist = posterior.p_edge(e)
        mean = dist.mean()
        short = dist.to_short_string()
        if copy_nums_true is not None:
            return f"{mean:.2f}x,{copy_nums_true[e]}x({short})"
        return f"{mean:.2f}x,?x({short})"

    def color(e):
        if copy_nums_true is None:
            return (0, 0, 0)
        mean = posterior.p_edge(e).mean()
        true = float(copy_nums_true[e])
        mx, half = 200, 100.0
        if mean > true:
            r = min(int((mean - true) * half), mx)
            return (mx, mx - r, mx - r)
        b = min(int((true - mean) * half), mx)
        return (mx - b, mx - b, mx)

    return to_gfa_string(dbg, label, color)


# -- POST format (ref: posterior/output.rs:22-98) -----------------------------


def to_post_string(posterior) -> str:
    lines = [f"# {VERSION_COMMENT}", f"Z\t{posterior.p}"]
    for sample in sorted(posterior.samples, key=lambda s: -s.score.p()):
        lines.append(
            "C\t{}\t{}\t{}\t{}".format(
                sample.score.p(),
                _fmt_copy_nums(sample.copy_nums),
                sample.score.to_json().replace(" ", ""),
                sample.to_infos_string(),
            )
        )
    return "\n".join(lines) + "\n"


def to_post_file(posterior, path) -> None:
    _P(path).write_text(to_post_string(posterior))


def from_post_string(s: str):
    from .posterior import Posterior, PosteriorSample, Score

    post = Posterior()
    for line in s.splitlines():
        if not line.startswith("C"):
            continue
        parts = line.split("\t")
        copy_nums = _parse_copy_nums(parts[2])
        score = Score.from_json(parts[3])
        post.add(PosteriorSample(copy_nums, score, []))
    return post


def from_post_file(path):
    return from_post_string(_P(path).read_text())


# -- INSPECT format (ref: posterior/output.rs:123-217) ------------------------


def to_inspect_string(dbg: MultiDbg, posterior, copy_nums_true=None) -> str:
    k = dbg.k
    lines = [f"# {VERSION_COMMENT}"]
    stats = {}
    for v in range(dbg.n_nodes_compact()):
        key = (dbg.compact.in_degree(v), dbg.compact.out_degree(v))
        stats[key] = stats.get(key, 0) + 1
    lines.append(f"{k}\tG\tn_edges_full\t{dbg.n_edges_full()}")
    lines.append(f"{k}\tG\tn_edges_compact\t{dbg.n_edges_compact()}")
    lines.append(f"{k}\tG\tn_nodes_full\t{dbg.n_nodes_full()}")
    lines.append(f"{k}\tG\tn_nodes_compact\t{dbg.n_nodes_compact()}")
    lines.append(f"{k}\tG\tn_emittable_edges\t{dbg.n_emittable_edges()}")
    lines.append(f"{k}\tG\tdegree_stats\t{stats}")

    for i, sample in enumerate(sorted(posterior.samples, key=lambda s: -s.score.p())):
        sc = sample.score
        diff = "?"
        if copy_nums_true is not None:
            diff = sum(
                abs(a - b) for a, b in zip(copy_nums_true, sample.copy_nums)
            )
        lines.append(
            f"{k}\tC\t{i}\t{math.exp(sc.p() - posterior.p):.10f}\t"
            f"{sc.likelihood}\t{sc.prior}\t{sc.n_euler_circuits}\t"
            f"{sc.genome_size}\t{diff}\t{sample.to_infos_string()}\t"
            f"{_fmt_copy_nums(sample.copy_nums)}\t{sc.to_json().replace(' ', '')}"
        )

    for e in range(dbg.n_edges_compact()):
        dist = posterior.p_edge(e)
        true_c = copy_nums_true[e] if copy_nums_true is not None else None
        p_true = f"{dist.p_x(true_c):.5f}" if true_c is not None else "?"
        lines.append(
            f"{k}\tE\te{e}\t{true_c if true_c is not None else '?'}\t"
            f"{dist.mean():.5f}\t{p_true}\t"
            f"{dist.p_x(0):.5f}\t{dist.to_short_string()}"
        )
    return "\n".join(lines) + "\n"


def to_inspect_file(dbg: MultiDbg, path, posterior, copy_nums_true=None) -> None:
    _P(path).write_text(to_inspect_string(dbg, posterior, copy_nums_true))


def parse_inspect_string(s: str) -> dict:
    """Parse an INSPECT file into
    ``{k, props: {...}, samples: [...], edges: [...]}``
    (ref: posterior/output.rs:244-291 + scripts/dbgphmm.py parsers)."""
    out = {"k": None, "props": {}, "samples": [], "edges": []}
    for line in s.splitlines():
        if not line or line.startswith("#"):
            continue
        parts = line.split("\t")
        if len(parts) < 3:
            continue
        out["k"] = int(parts[0])
        kind = parts[1]
        if kind == "G":
            out["props"][parts[2]] = parts[3]
        elif kind == "C":
            out["samples"].append(
                dict(
                    rank=int(parts[2]),
                    posterior=float(parts[3]),
                    likelihood=float(parts[4]),
                    prior=float(parts[5]),
                    n_euler_circuits=float(parts[6]),
                    genome_size=int(parts[7]),
                    diff_to_true=None if parts[8] == "?" else int(parts[8]),
                    infos=parts[9],
                    copy_nums=_parse_copy_nums(parts[10]),
                )
            )
        elif kind == "E":
            out["edges"].append(
                dict(
                    edge=parts[2],
                    copy_num_true=None if parts[3] == "?" else int(parts[3]),
                    mean=float(parts[4]),
                    p_true=None if parts[5] == "?" else float(parts[5]),
                    p_zero=float(parts[6]),
                    dist=parts[7],
                )
            )
    return out


def parse_inspect_file(path) -> dict:
    return parse_inspect_string(_P(path).read_text())
