"""Command-line interface of the port: ``infer``, ``sim-infer``, ``euler``,
``inspect``, ``sample`` and ``sample-from-true``.

Flags follow the JAX package's CLI (``dbgphmm_tpu/cli.py``), plus
``--device`` (default ``cuda``).  A CUDA run needs a visible GPU: when
``torch.cuda.is_available()`` is False the command exits non-zero with a
message; only an explicit ``--device cpu`` runs the float64 CPU path.

    python -m dbgphmm_tpu_torch sim-infer data/bench/data.json \\
        -d data/bench/data.dbg -o out/run -K 41 -I 1
    python -m dbgphmm_tpu_torch infer -d draft.dbg -o out -K 10000 \\
        -G 1000000 reads.fa
    python -m dbgphmm_tpu_torch euler -d out.final.dbg assembly.fa
    python -m dbgphmm_tpu_torch inspect -d data/bench/data.dbg \\
        data/bench/data.json -o out/inspect
    python -m dbgphmm_tpu_torch sample -d draft.dbg -o out/s -G 87975 reads.fa
    python -m dbgphmm_tpu_torch sample-from-true data.json -k 40 -o out/t

``inspect``, ``sample`` and ``sample-from-true`` map reads like ``infer``
(seeded regime: graphs of more than 32,768 full edges; a smaller graph
raises ``NotImplementedError``).

Each k-stage prints one line ``# stage {json}`` with its time split
(seeding, refine, scorer setup, scoring, host) and scorings per second.
"""

from __future__ import annotations

import argparse
import json
import time

import torch


def _resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"dbgphmm_tpu_torch: --device {name} requested but "
            "torch.cuda.is_available() is False (no usable CUDA GPU); pass "
            "--device cpu to run the float64 CPU path"
        )
    return dev


def _true_compact_copy_nums(dbg_k, paths):
    """Per-compact-edge true copy numbers from the surviving full-edge paths
    (ref: posterior/output.rs:188-190 'diff to true' column)."""
    if paths is None:
        return None
    alive = [p for p in paths if p is not None]
    if not alive:
        return None
    cn = [0] * dbg_k.n_edges_full()
    for p in alive:
        for e in p:
            cn[e] += 1
    return [cn[dbg_k.edges_in_full(ec)[0]] for ec in range(dbg_k.n_edges_compact())]


def _run_inference(dbg, reads, args, device, paths_true=None, mappings=None):
    from dbgphmm_tpu.phmm.params import PHMMParams

    from .multi_dbg import output as out
    from .multi_dbg.posterior import infer_posterior_by_extension

    prefix = str(args.output_prefix)
    stage_times = []

    def on_iter(dbg_k, posterior, paths, mappings):
        k = dbg_k.k
        out.to_dbg_file(dbg_k, f"{prefix}.k{k}.dbg")
        out.to_map_file(dbg_k, f"{prefix}.k{k}.map.mpz", reads, mappings)
        out.to_post_file(posterior, f"{prefix}.k{k}.post")
        out.to_gfa_file(dbg_k, f"{prefix}.k{k}.gfa")
        out.to_inspect_file(dbg_k, f"{prefix}.k{k}.inspect", posterior,
                            _true_compact_copy_nums(dbg_k, paths))
        print(f"# k={k} dumped {prefix}.k{k}.*")

    dbg_final, posterior, paths, mappings = infer_posterior_by_extension(
        k_max=args.k_max,
        dbg_init=dbg,
        param_infer=PHMMParams.uniform(args.p_infer),
        param_error=PHMMParams.uniform(args.p_error),
        reads=reads,
        genome_size_expected=args.genome_size,
        genome_size_sigma=args.genome_size_sigma,
        device=device,
        max_iter=args.max_iter,
        p0=args.p0,
        on_iter=on_iter,
        paths=paths_true,
        mappings=mappings,
        verbose=True,
        stage_times=stage_times,
    )
    for st in stage_times:
        print(f"# stage {json.dumps(st.as_dict())}")
    out.to_dbg_file(dbg_final, f"{prefix}.final.dbg")
    out.to_gfa_file(dbg_final, f"{prefix}.final.gfa")
    out.to_inspect_file(dbg_final, f"{prefix}.final.inspect", posterior,
                        _true_compact_copy_nums(dbg_final, paths))
    dbg_final.to_fasta_linear(f"{prefix}.final.euler.fa")
    print(f"# wrote {prefix}.final.*")
    return dbg_final, posterior, stage_times


def cmd_infer(args):
    from dbgphmm_tpu.seq.collection import ReadCollection

    from .multi_dbg import output as out

    device = _resolve_device(args.device)
    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    mappings = None
    if args.map_input:
        # restart from a dumped .map/.mpz (ref: bin/infer.rs:44-48 --map)
        mappings = out.from_map_file(args.map_input)
        if mappings.n_reads() != len(reads):
            raise SystemExit(
                f"--map {args.map_input}: {mappings.n_reads()} mapped reads "
                f"but {len(reads)} reads in {args.read_fasta}")
    return _run_inference(dbg, reads, args, device, mappings=mappings)


def cmd_euler(args):
    from .multi_dbg import output as out

    dbg = out.from_dbg_file(args.dbg)
    dbg.to_fasta_linear(args.fasta_out)
    print(f"# wrote {args.fasta_out}")


def cmd_inspect(args):
    """Re-score a DBG's current copy numbers and the true ones (from the
    dataset's genome paths) against the reads (ref: bin/inspect.rs).  The
    two candidates are scored in log space, by K2 on a GPU."""
    from dbgphmm_tpu.e2e import Dataset
    from dbgphmm_tpu.phmm.template import make_template

    from .multi_dbg import output as out
    from .multi_dbg.posterior import (
        generate_mappings,
        make_scorer,
        score_candidates,
    )
    from .ops.forward import pad_reads
    from .ops.sparse import pad_mappings, precompute_positions

    device = _resolve_device(args.device)
    ds = Dataset.from_json_file(args.dataset_json)
    dbg = out.from_dbg_file(args.dbg)
    print(f"k={dbg.k} |E|={dbg.n_edges_full()}")
    params = ds.params
    cn_orig = dbg.get_copy_nums()
    paths_true = dbg.paths_from_styled_seqs(ds.genome)
    if paths_true is None or any(p is None for p in paths_true):
        raise SystemExit("inspect: a k-mer of the genome is missing from the DBG")
    cn_true = _true_compact_copy_nums(dbg, paths_true)
    mappings = generate_mappings(dbg, params, ds.reads, device)
    codes, lens = pad_reads(list(ds.reads))
    width = max(a.shape[1] for a in mappings.nodes)
    tpl = make_template(dbg, params)
    positions = precompute_positions(
        pad_mappings(mappings, codes.shape[1], width), tpl.parent_idx,
        parent_exists=tpl.parent_exists)
    scorer = make_scorer(tpl, positions, codes, lens, tpl.params, device,
                         space="log")
    scores = score_candidates(dbg, [cn_orig, cn_true], ds.genome_size(),
                              args.sigma, scorer)
    for name, cn, sc in (("orig", cn_orig, scores[0]),
                         ("true", cn_true, scores[1])):
        print(f"{name}\t{sc.p():.4f}\t{sc.likelihood:.4f}\t{sc.to_json()}\t{cn}")
    work = dbg.copy()
    work.set_copy_nums(cn_true)
    out.to_map_file(work, f"{args.output_prefix}.true.map", ds.reads, mappings)
    print(f"# wrote {args.output_prefix}.true.map")
    return scores


def _sample_and_write(dbg, params, reads, genome_size, args, device,
                      rescue_only, copy_nums_true=None):
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings, sample_posterior

    mappings = generate_mappings(dbg, params, reads, device)
    post = sample_posterior(
        dbg, params, reads, mappings, genome_size, args.genome_size_sigma,
        device, max_iter=args.max_iter, rescue_only=rescue_only, verbose=True)
    out.to_inspect_file(dbg, f"{args.output_prefix}.inspect", post,
                        copy_nums_true)
    out.to_post_file(post, f"{args.output_prefix}.post")
    return post


def cmd_sample(args):
    """Posterior sampling around a given DBG at fixed k (ref:
    bin/sample.rs)."""
    from dbgphmm_tpu.phmm.params import PHMMParams
    from dbgphmm_tpu.seq.collection import ReadCollection

    from .multi_dbg import output as out

    device = _resolve_device(args.device)
    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    post = _sample_and_write(dbg, PHMMParams.uniform(args.p_error), reads,
                             args.genome_size, args, device,
                             rescue_only=not args.full)
    print(f"# wrote {args.output_prefix}.post/.inspect "
          f"({len(post.samples)} samples, best p={post.max_sample().score.p():.3f})")
    return post


def cmd_sample_from_true(args):
    """Posterior sampling around the TRUE copy numbers of a dataset's
    genome: is the truth a local optimum (ref: bin/sample_from_true.rs)."""
    from dbgphmm_tpu.e2e import Dataset
    from dbgphmm_tpu.multi_dbg import MultiDbg

    device = _resolve_device(args.device)
    ds = Dataset.from_json_file(args.dataset_json)
    dbg = MultiDbg.from_styled_seqs(args.k, list(ds.genome))
    print(f"# true DBG: {dbg}")
    true_cn = dbg.get_copy_nums()
    post = _sample_and_write(dbg, ds.params, ds.reads, ds.genome_size(), args,
                             device, rescue_only=False, copy_nums_true=true_cn)
    print(f"# truth is argmax: {post.max_copy_nums() == true_cn}")
    print(f"# wrote {args.output_prefix}.inspect/.post")
    return post


def cmd_sim_infer(args):
    """Inference against a dataset.json, with the truth diff (ref:
    bin/infer.rs)."""
    from dbgphmm_tpu.e2e import Dataset

    from .multi_dbg import output as out

    device = _resolve_device(args.device)
    ds = Dataset.from_json_file(args.dataset_json)
    dbg = out.from_dbg_file(args.dbg_input)
    partial = dbg.paths_from_styled_seqs_partial(ds.genome)
    n_ok = sum(1 for p in partial if p is not None)
    paths_true = partial if n_ok > 0 else None
    if 0 < n_ok < len(partial):
        print(f"# warning: {len(partial) - n_ok}/{len(partial)} true "
              f"haplotype path(s) missing from the k={dbg.k} graph; tracking "
              f"the {n_ok} still-contained path(s)")
    elif n_ok == 0:
        print(f"# warning: true genome k-mers missing from the k={dbg.k} "
              "graph; truth diff disabled")
    args.genome_size = args.genome_size or ds.genome_size()
    mappings = None
    if args.map_input:
        mappings = out.from_map_file(args.map_input)
        if mappings.n_reads() != len(ds.reads):
            raise SystemExit(
                f"--map {args.map_input}: {mappings.n_reads()} mapped reads"
                f" but {len(ds.reads)} reads in the dataset")
    result = _run_inference(dbg, ds.reads, args, device, paths_true,
                            mappings=mappings)
    haps = sorted(s.seq for s, _c in result[0].get_linear_haplotype_seqs())
    truth = sorted(s.seq for s in ds.genome)
    print(f"# assembled={len(haps)} truth={len(truth)} exact={haps == truth}")
    return result


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbgphmm_tpu_torch",
        description="Bayesian genome assembler, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (default, float32 + the "
                             "CUDA kernels) or cpu (float64, plain PyTorch)")

    inf = sub.add_parser("infer", help="posterior inference k0 -> K")
    inf.add_argument("-d", "--dbg-input", required=True)
    inf.add_argument("--map", dest="map_input", default=None,
                     help="restart from a dumped .map/.mpz mappings file")
    inf.add_argument("-o", "--output-prefix", required=True)
    inf.add_argument("-K", "--k-max", type=int, required=True)
    inf.add_argument("-G", "--genome-size", type=int, required=True)
    inf.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    inf.add_argument("read_fasta")
    inf.add_argument("-p", "--p-error", type=float, default=0.001)
    inf.add_argument("-e", "--p-infer", type=float, default=0.00001)
    inf.add_argument("--p0", type=float, default=0.8)
    inf.add_argument("-I", "--max-iter", type=int, default=50)
    inf.add_argument("-c", "--max-cycle-size", type=int, default=1000)
    device_flag(inf)
    inf.set_defaults(fn=cmd_infer)

    eu = sub.add_parser("euler", help="emit assembly FASTA from DBG")
    eu.add_argument("-d", "--dbg", required=True)
    eu.add_argument("fasta_out")
    eu.set_defaults(fn=cmd_euler)

    si = sub.add_parser("sim-infer", help="inference against dataset.json")
    si.add_argument("dataset_json")
    si.add_argument("-d", "--dbg-input", required=True)
    si.add_argument("-o", "--output-prefix", required=True)
    si.add_argument("-K", "--k-max", type=int, required=True)
    si.add_argument("-G", "--genome-size", type=int, default=None)
    si.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    si.add_argument("-p", "--p-error", type=float, default=0.001)
    si.add_argument("-e", "--p-infer", type=float, default=0.00001)
    si.add_argument("--p0", type=float, default=0.8)
    si.add_argument("-I", "--max-iter", type=int, default=50)
    si.add_argument("--map", dest="map_input", default=None,
                    help="restart mappings from a dumped .map/.mpz")
    device_flag(si)
    si.set_defaults(fn=cmd_sim_infer)

    sp = sub.add_parser("sample", help="posterior sampling at fixed k")
    sp.add_argument("-d", "--dbg-input", required=True)
    sp.add_argument("-o", "--output-prefix", required=True)
    sp.add_argument("-G", "--genome-size", type=int, required=True)
    sp.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    sp.add_argument("-p", "--p-error", type=float, default=0.001)
    sp.add_argument("-I", "--max-iter", type=int, default=50)
    sp.add_argument("--full", action="store_true", help="full neighbor sets")
    sp.add_argument("read_fasta")
    device_flag(sp)
    sp.set_defaults(fn=cmd_sample)

    ins = sub.add_parser(
        "inspect", help="re-score current vs true copy numbers on a dataset")
    ins.add_argument("-d", "--dbg", required=True)
    ins.add_argument("dataset_json")
    ins.add_argument("-s", "--sigma", type=int, default=200)
    ins.add_argument("-o", "--output-prefix", default="inspect")
    device_flag(ins)
    ins.set_defaults(fn=cmd_inspect)

    sft = sub.add_parser("sample-from-true",
                         help="posterior around the true DBG")
    sft.add_argument("dataset_json")
    sft.add_argument("-k", type=int, required=True)
    sft.add_argument("-S", "--genome-size-sigma", type=int, default=100)
    sft.add_argument("-I", "--max-iter", type=int, default=10)
    sft.add_argument("-o", "--output-prefix", required=True)
    device_flag(sft)
    sft.set_defaults(fn=cmd_sample_from_true)
    return p


def main(argv=None):
    """Parse ``argv`` and run the command; returns the command's result
    (infer / sim-infer: (dbg, posterior, per-stage times); inspect: the two
    Scores; sample / sample-from-true: the Posterior)."""
    args = build_parser().parse_args(argv)
    t0 = time.time()
    print(f"# started_at={time.strftime('%Y-%m-%d %H:%M:%S')}")
    print("# version=dbgphmm_tpu_torch")
    print(f"# args={vars(args)}")
    result = args.fn(args)
    print(f"# finished_at={time.strftime('%Y-%m-%d %H:%M:%S')} "
          f"elapsed={time.time()-t0:.1f}s")
    return result
