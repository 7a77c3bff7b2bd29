"""The CLI's ``mapping``, ``freq`` and ``extend-mapping`` on one dataset, on
the GPU (float32) and on the CPU (float64), held to each other by the
decode gates: read log-likelihoods to 1e-4 relative and >= 99% of read
positions with the same top-1 node; for ``freq``, the summed absolute
difference of the node frequencies at most 1% of their sum; for
``extend-mapping``, its printed likelihoods to 1e-4 relative and its .map
files' top-1 nodes to 99%.

    python dbgphmm_tpu_torch/scripts/device_gates.py run cuda <prefix> <dir>
    python dbgphmm_tpu_torch/scripts/device_gates.py run cpu <prefix> <dir> [command ...]
    python dbgphmm_tpu_torch/scripts/device_gates.py compare <dir>

``<prefix>`` is a dataset as ``sim-draft -k ...`` writes it (``.json``,
``.dbg``, ``.reads.fa``).  ``run`` runs the named commands (all three by
default; ``extend-mapping`` to k+1) in this process and writes
``<dir>/<device>.<command>.*``; on the CPU it uses OMP_NUM_THREADS
threads (default 4), so that the commands can run in parallel
processes.  ``compare`` prints one JSON line per command and exits
non-zero if a gate fails.
"""

import contextlib
import io
import json
import os
import re
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

REL, TOP1, FREQ_L1 = 1e-4, 0.99, 0.01
COMMANDS = ("mapping", "freq", "extend-mapping")


def top1(maps) -> np.ndarray:
    return np.concatenate([a[:, 0] if a.shape[1] else np.full(len(a), -1)
                           for a in maps.nodes])


def run(device: str, prefix: str, out: Path, commands) -> None:
    """Run ``commands`` (of COMMANDS) on ``device``; each writes
    ``<out>/<device>.<command>.json`` and ``.npz``."""
    import torch

    from dbgphmm_tpu_torch import cli
    from dbgphmm_tpu_torch.multi_dbg import output as mdo

    if device == "cpu":
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "4")))
    out.mkdir(parents=True, exist_ok=True)
    dev = ["--device", device]
    for command in commands:
        res, arrays = {}, {}
        t0 = time.perf_counter()
        if command == "mapping":
            maps = cli.main(["mapping", "-d", f"{prefix}.dbg",
                             f"{prefix}.reads.fa", "-o",
                             str(out / f"{device}.mapping.map"), *dev])
            arrays.update(logps=maps.read_logps, top1=top1(maps))
        elif command == "freq":
            path = out / f"{device}.freq"
            cli.main(["freq", "-d", f"{prefix}.dbg", f"{prefix}.reads.fa",
                      "-o", str(path), *dev])
            arrays["freq"] = np.loadtxt(path, usecols=3)
        else:
            k = mdo.from_dbg_file(f"{prefix}.dbg").k + 1
            em = str(out / f"{device}.em")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["extend-mapping", f"{prefix}.json", "-d",
                          f"{prefix}.dbg", "-K", str(k), "-o", em, *dev])
            lines = re.findall(r"^k=(\d+) p_extend=(\S+) p_true=(\S+)",
                               buf.getvalue(), re.M)
            res["p"] = {kk: [float(a), float(b)] for kk, a, b in lines}
            for kk, _a, _b in lines:
                for kind in ("extend", "true"):
                    arrays[f"k{kk}_{kind}_top1"] = top1(
                        mdo.from_map_file(f"{em}.k{kk}.{kind}.map"))
        res["seconds"] = time.perf_counter() - t0
        np.savez(out / f"{device}.{command}.npz", **arrays)
        (out / f"{device}.{command}.json").write_text(json.dumps(res))
        print(json.dumps({"device": device, "command": command, **res}),
              flush=True)


def agree(a: np.ndarray, b: np.ndarray) -> float:
    has = (a >= 0) | (b >= 0)
    return float((a == b)[has].mean())


def rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def compare(out: Path) -> int:
    def load(device, command):
        return (dict(np.load(out / f"{device}.{command}.npz")),
                json.loads((out / f"{device}.{command}.json").read_text()))

    rows = []
    for command in COMMANDS:
        (g, jg), (c, jc) = load("cuda", command), load("cpu", command)
        r = dict(command=command,
                 seconds={"cuda": jg["seconds"], "cpu": jc["seconds"]})
        if command == "mapping":
            r.update(reads=len(c["logps"]),
                     max_rel_logp_diff=rel(g["logps"], c["logps"]),
                     top1_agree=agree(g["top1"], c["top1"]))
            r["ok"] = r["max_rel_logp_diff"] <= REL and r["top1_agree"] >= TOP1
        elif command == "freq":
            d = np.abs(g["freq"] - c["freq"])
            r.update(nodes=len(d), max_abs_diff=float(d.max()),
                     l1_share=float(d.sum() / c["freq"].sum()))
            r["ok"] = r["l1_share"] <= FREQ_L1
        else:
            ks = sorted(jc["p"])
            r.update(ks=ks, p_cuda=jg["p"], p_cpu=jc["p"],
                     max_rel_p_diff=rel([jg["p"][k] for k in ks],
                                        [jc["p"][k] for k in ks]),
                     top1_agree={key: agree(g[key], c[key]) for key in sorted(c)})
            r["ok"] = (bool(ks) and sorted(jg["p"]) == ks
                       and r["max_rel_p_diff"] <= REL
                       and min(r["top1_agree"].values()) >= TOP1)
        rows.append(r)
        print(json.dumps(r))
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["run"]:
        run(sys.argv[2], sys.argv[3], Path(sys.argv[4]),
            sys.argv[5:] or COMMANDS)
    elif sys.argv[1:2] == ["compare"]:
        sys.exit(compare(Path(sys.argv[2])))
    else:
        sys.exit(__doc__)
