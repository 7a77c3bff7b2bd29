#!/usr/bin/env python
"""Interactive DBG viewer: render a .dbg (or .gfa) file as a standalone HTML
page with a cytoscape.js graph (ref: scripts/dbgviz/ in the reference, 455
LoC JS app — here generated as a self-contained page).

Usage: python dbgphmm_tpu_torch/scripts/dbgviz.py out.final.dbg -o graph.html [--inspect out.final.inspect]

The counterpart of scripts/dbgviz.py over the port's readers
(multi_dbg.output); host only, the same page.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from dbgphmm_tpu_torch.multi_dbg import output as out

TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>dbgphmm_tpu graph</title>
<script src="https://unpkg.com/cytoscape@3/dist/cytoscape.min.js"></script>
<style>
 body {{ margin: 0; font-family: sans-serif; }}
 #cy {{ width: 100vw; height: 94vh; }}
 #bar {{ height: 6vh; padding: 4px 10px; background: #f5f5f5; }}
</style></head>
<body>
<div id="bar">k={k} | {n_nodes} nodes, {n_edges} compact edges | edge label: id:copy_num (len)</div>
<div id="cy"></div>
<script>
const elements = {elements};
cytoscape({{
  container: document.getElementById('cy'),
  elements: elements,
  layout: {{ name: 'cose', animate: false }},
  style: [
    {{ selector: 'node', style: {{ 'width': 12, 'height': 12,
       'background-color': '#888', 'label': 'data(label)', 'font-size': 8 }} }},
    {{ selector: 'node[terminal = 1]', style: {{ 'background-color': '#d33',
       'width': 20, 'height': 20 }} }},
    {{ selector: 'edge', style: {{ 'curve-style': 'bezier',
       'target-arrow-shape': 'triangle', 'width': 'data(width)',
       'line-color': 'data(color)', 'target-arrow-color': 'data(color)',
       'label': 'data(label)', 'font-size': 8 }} }}
  ]
}});
</script></body></html>
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dbg_file")
    ap.add_argument("-o", "--output", default="graph.html")
    ap.add_argument("--inspect", default=None, help="color edges by P(X=0)")
    args = ap.parse_args(argv)

    dbg = out.from_dbg_file(args.dbg_file)
    p_zero = {}
    if args.inspect:
        ins = out.parse_inspect_file(args.inspect)
        for e in ins["edges"]:
            p_zero[int(e["edge"].lstrip("e"))] = e["p_zero"]

    elements = []
    for v in range(dbg.n_nodes_compact()):
        elements.append(
            dict(data=dict(
                id=f"n{v}",
                label=f"v{v}",
                terminal=1 if dbg.compact.node(v).is_terminal else 0,
            ))
        )
    for e in range(dbg.n_edges_compact()):
        s, t = dbg.compact.edge_endpoints(e)
        c = dbg.copy_num_of_edge_in_compact(e)
        pz = p_zero.get(e, 0.0)
        color = "#c33" if pz > 0.5 else ("#3a3" if c > 0 else "#bbb")
        elements.append(
            dict(data=dict(
                id=f"e{e}", source=f"n{s}", target=f"n{t}",
                label=f"e{e}:{c}x ({dbg.n_bases(e)})",
                width=max(1, min(c * 2, 10)),
                color=color,
            ))
        )

    html = TEMPLATE.format(
        k=dbg.k, n_nodes=dbg.n_nodes_compact(), n_edges=dbg.n_edges_compact(),
        elements=json.dumps(elements),
    )
    Path(args.output).write_text(html)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
