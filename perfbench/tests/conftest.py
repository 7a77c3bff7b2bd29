"""Fixtures of the benchmark's CPU tests, and the ``cuda`` marker for tests
that need the card (they look for it inside the test, never at import)."""

import gzip
import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda:0")


TOY_CFG = {
    "name": "toy",
    "source": "a tandem repeat of 4 units of 50 bases, diploid (test only)",
    "dataset": {"genome": "data/toy/genome.txt", "draft": "data/toy/draft.dbg.gz",
                "reads": {"kind": "full_length", "coverage": 3, "p_error": 0.001}},
    "settings": {"p_error": 0.001, "p_infer": 1e-05, "genome_size": 635,
                 "genome_size_sigma": 100, "p0": 0.8, "max_iter": 1},
    "reduced": {}, "assumed": {},
}


def toy_bench(root: Path) -> dict:
    """BENCHMARK.json of a copy of the harness's data under ``root`` with a
    toy configuration and its two cells added as files and entries only."""
    from dbgphmm_tpu_torch.multi_dbg import MultiDbg
    from dbgphmm_tpu_torch.multi_dbg import output
    from dbgphmm_tpu_torch.seq import genome as G

    for sub in ("configs", "traffic", "entries", "limits", "metrics",
                "roofline"):
        shutil.copytree(ROOT / sub, root / sub)
    g = G.tandem_repeat_polyploid_with_unique_homo_ends(50, 4, 0, 0.02, 1, 60,
                                                        2, 0.02, 0)
    (root / "data" / "toy").mkdir(parents=True)
    (root / "data" / "toy" / "genome.txt").write_text(
        "\n".join(str(s) for s in g) + "\n")
    draft = MultiDbg.from_styled_seqs(16, list(g))
    with gzip.open(root / "data" / "toy" / "draft.dbg.gz", "wt") as f:
        f.write(output.to_dbg_string(draft))
    (root / "configs" / "toy.json").write_text(json.dumps(TOY_CFG))
    (root / "traffic" / "k17_run.json").write_text(json.dumps(
        {"entry": "infer", "k_max": 17, "check_candidates": 2, "read_sets": 2}))
    (root / "traffic" / "k16_map.json").write_text(json.dumps(
        {"entry": "map", "check_reads": 3, "read_sets": 2}))
    (root / "limits" / "toy.k17_run.json").write_text(json.dumps(
        {"decode_ll_rel": 1e-9, "refine_ll_rel": 1e-9, "post_gap": 1e-9,
         "score_rel": 1e-9, "host_gap": 1e-9,
         "extend_faults": 0}))
    (root / "limits" / "toy.k16_map.json").write_text(json.dumps(
        {"map_ll_rel": 1e-9, "post_gap": 1e-9}))
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": TOY_CFG["source"],
                             "file": f"{root.name}/configs/toy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"] += [
        {"name": "toy.k17_run", "config": "toy", "traffic": "k17_run",
         "chips": 1, "why": "test"},
        {"name": "toy.k16_map", "config": "toy", "traffic": "k16_map",
         "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            cell = {"stage_s": "toy.k17_run",
                    "reads_mapped_per_s": "toy.k16_map"}.get(m.get("moves", m["name"]))
            if cell:
                m["workloads"].append(cell)
    return bench


@pytest.fixture(scope="session")
def toy(tmp_path_factory):
    """(root, bench) of the toy cells."""
    root = tmp_path_factory.mktemp("bench") / "perfbench"
    root.mkdir()
    return root, toy_bench(root)
