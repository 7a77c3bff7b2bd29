"""Command-line interface of the port (ref: src/bin/dbgphmm.rs and the
experiment binaries).

Commands and flags follow the JAX package's CLI (``dbgphmm_tpu/cli.py``):
``raw-dbg``, ``draft``, ``infer``, ``euler``, ``sim-draft``, ``sim-infer``,
``sample``, ``mapping``, ``freq``, ``table``, ``edit-dist``,
``modify-dbg``, ``inspect``, ``sample-from-true``, ``extend-mapping`` and
``speed-test`` (:mod:`dbgphmm_tpu_torch.bench`), and they write the same
files.  The commands that run the PHMM take ``--device`` (default
``cuda``): a CUDA run needs a visible GPU, and when
``torch.cuda.is_available()`` is False the command exits non-zero with a
message; only an explicit ``--device cpu`` runs the float64 CPU path (the
JAX CLI's ``--cpu``).  The top-level ``--mesh CxR|N`` shards ``infer``,
``sim-infer`` and ``sample`` over a ("cand", "reads") mesh of
``--device``'s type (:mod:`dbgphmm_tpu_torch.parallel`); a mesh of more
CUDA devices than are visible, or ``--mesh`` on another command, exits
non-zero.  ``--dist ADDR:PORT,N,I`` joins N processes in a gloo group
before the command runs; with ``--mesh`` the mesh spans every rank's
devices, and each rank writes the files of a single run to its own
``-o`` prefix.  SIGUSR1 makes the process dump every thread's stack to
stderr and carry on (``faulthandler``), so that a supervisor
(``dbgphmm_tpu_torch/scripts/sim.sh``) can see where a silent run stands.

    python -m dbgphmm_tpu_torch sim-draft -k 40 --unit-size 500 --n-unit 8 \
        --unit-seed 0 --div-init 0.02 --div-seed 1 --end-length 300 -P 2 \
        --div-hap 0.02 --hap-seed 0 -C 15 -L 10000 -p 0.001 -o u500
    python -m dbgphmm_tpu_torch sim-infer u500.json -d u500.dbg -o out/run \
        -K 41 -I 1
    python -m dbgphmm_tpu_torch infer -d draft.dbg -o out -K 10000 \
        -G 1000000 reads.fa
    python -m dbgphmm_tpu_torch euler -d out.final.dbg assembly.fa
    python -m dbgphmm_tpu_torch inspect -d data/bench/data.dbg \
        data/bench/data.json -o out/inspect
    python -m dbgphmm_tpu_torch table -d draft.dbg reads.fa
    python -m dbgphmm_tpu_torch speed-test
    python -m dbgphmm_tpu_torch --mesh 2x4 sim-infer u500.json -d u500.dbg \
        -o out/run -K 41 -I 1
    CUDA_VISIBLE_DEVICES=1 python -m dbgphmm_tpu_torch \
        --dist host0:12345,2,1 --mesh 1x2 sample -d g.dbg -o r1 -G 1000 r.fa

Mappings are decoded by the graph's size (``multi_dbg.posterior.
generate_mappings``): dense up to 4,000 full edges, sparse-adaptive up to
32,768, seeded beyond.  Each k-stage of ``infer`` / ``sim-infer`` prints
one line ``# stage {json}`` (``tracing.StageTimes.as_dict``) with its time
split in seconds -- ``seed_s``, ``decode_s``, ``refine_s``, ``setup_s``,
``score_s``, ``host_s`` (the rest of ``wall_s``) -- and scorings per
second; the split below them, from the program's spans: seeding's
``seed_index_s``, ``seed_hits_s``, ``seed_chain_s``, ``seed_rows_s``; the
mapping's ``map_prep_s``, ``map_launch_s``, ``map_fetch_s`` (the copy to
the host, waiting for the device included), ``map_gate_s``; the climb's
``neighbors_s``, ``prior_s``, ``move_s``; ``extend_s``, ``reinit_s``; and
``untraced_s``, the wall time no named span covers.  Its counters:
``reads``, ``reads_unseeded``, ``seed_cover``, ``seed_rows_backfilled``,
``reads_gated``, ``fetch_bytes``, ``kept_bytes``, ``climb_iters``,
``candidates``, ``candidates_scored``, ``edges_purged``, ``n_scorings``,
``n_rescued``.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import signal
import sys
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


MESH_COMMANDS = ("infer", "sim-infer", "sample")  # those that take --mesh


def _make_mesh_from_arg(spec, device):
    """--mesh 'CxR' or 'N' -> a ("cand", "reads") mesh of ``device``'s type
    (under --dist, over every rank's devices), or None.  A mesh the
    devices cannot hold exits non-zero."""
    if not spec:
        return None
    from .parallel.sharding import make_mesh

    try:
        c, r = (int(v) for v in spec.split("x", 1)) if "x" in spec else (1, int(spec))
        return make_mesh(c * r, cand_axis=c, device=device)
    except ValueError as e:
        raise SystemExit(f"dbgphmm_tpu_torch: --mesh {spec}: {e}") from None


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
    from .phmm.params import PHMMParams

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
        mesh=_make_mesh_from_arg(args.mesh, device),
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
    from .seq.collection import ReadCollection

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


def cmd_raw_dbg(args):
    """(ref: bin/dbgphmm.rs RawDbg) Reads -> a raw k-mer DBG as GFA."""
    from .hashdbg import HashDbg
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    hd = HashDbg.from_fragment_seqs(args.k, reads)
    hd.remove_rare_kmers(args.min_count)
    hd.remove_deadends(args.min_deadend_count)
    hd.to_gfa_file(args.gfa_output)
    print(f"# wrote {args.gfa_output} ({hd.n()} kmers)")


def cmd_draft(args):
    """(ref: bin/dbgphmm.rs Draft) Reads -> the draft DBG."""
    from .multi_dbg import output as out
    from .multi_dbg.draft import create_draft_from_reads
    from .seq.collection import ReadCollection

    reads = ReadCollection.from_fasta(args.read_fasta)
    print(f"# n_reads={len(reads)}")
    dbg = create_draft_from_reads(
        args.k, reads, args.p_error, args.genome_size,
        n_haplotypes=args.n_haplotypes,
        min_count=args.min_count, min_deadend_count=args.min_deadend_count,
    )
    out.to_dbg_file(dbg, args.dbg_output)
    print(f"# wrote {args.dbg_output} ({dbg})")
    if args.gfa_output:
        out.to_gfa_file(dbg, args.gfa_output)


def cmd_sim_draft(args):
    """(ref: bin/draft.rs) A synthetic dataset (tandem-repeat polyploid
    genome, simulated reads) and, with ``-k``, its draft and true paths."""
    from .e2e import ReadType, generate_dataset
    from .multi_dbg import output as out
    from .multi_dbg.draft import create_draft_from_dataset
    from .phmm.params import PHMMParams
    from .seq import genome as genome_gen

    g = genome_gen.tandem_repeat_polyploid_with_unique_homo_ends(
        args.unit_size, args.n_unit, args.unit_seed, args.div_init,
        args.div_seed, args.end_length, args.ploidy, args.div_hap, args.hap_seed,
    )
    ds = generate_dataset(
        g, args.read_seed, args.coverage, args.read_length,
        ReadType.FRAGMENT_WITH_REVCOMP if args.fragment
        else ReadType.FULL_LENGTH_WITH_REVCOMP,
        PHMMParams.uniform(args.p_error),
    )
    prefix = str(args.output_prefix)
    ds.write_files(prefix)
    print(f"# dataset: {len(ds.reads)} reads {ds.coverage():.1f}x -> {prefix}.json")
    if args.k:
        dbg = create_draft_from_dataset(args.k, ds)
        out.to_dbg_file(dbg, f"{prefix}.dbg")
        try:
            paths = dbg.paths_from_styled_seqs(ds.genome)
            out.to_paths_file(paths, f"{prefix}.paths")
            print(f"# draft contains true genome: wrote {prefix}.paths")
        except Exception as e:
            print(f"# true paths not in draft: {e}")
        print(f"# wrote {prefix}.dbg ({dbg})")
    return ds


def cmd_euler(args):
    from .multi_dbg import output as out

    dbg = out.from_dbg_file(args.dbg)
    dbg.to_fasta_linear(args.fasta_out)
    print(f"# wrote {args.fasta_out}")


def cmd_inspect(args):
    """Re-score a DBG's current copy numbers and the true ones (from the
    dataset's genome paths) against the reads (ref: bin/inspect.rs).  The
    two candidates are scored in log space, by K2 on a GPU."""
    from .e2e import Dataset
    from .phmm.template import make_template

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
                      rescue_only, copy_nums_true=None, mesh=None):
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings, sample_posterior

    mappings = generate_mappings(dbg, params, reads, device, mesh=mesh)
    post = sample_posterior(
        dbg, params, reads, mappings, genome_size, args.genome_size_sigma,
        device, max_iter=args.max_iter, rescue_only=rescue_only, verbose=True,
        mesh=mesh)
    out.to_inspect_file(dbg, f"{args.output_prefix}.inspect", post,
                        copy_nums_true)
    out.to_post_file(post, f"{args.output_prefix}.post")
    return post


def cmd_sample(args):
    """Posterior sampling around a given DBG at fixed k (ref:
    bin/sample.rs)."""
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    from .multi_dbg import output as out

    device = _resolve_device(args.device)
    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    post = _sample_and_write(dbg, PHMMParams.uniform(args.p_error), reads,
                             args.genome_size, args, device,
                             rescue_only=not args.full,
                             mesh=_make_mesh_from_arg(args.mesh, device))
    print(f"# wrote {args.output_prefix}.post/.inspect "
          f"({len(post.samples)} samples, best p={post.max_sample().score.p():.3f})")
    return post


def cmd_sample_from_true(args):
    """Posterior sampling around the TRUE copy numbers of a dataset's
    genome: is the truth a local optimum (ref: bin/sample_from_true.rs)."""
    from .e2e import Dataset
    from .multi_dbg import MultiDbg

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


def cmd_mapping(args):
    """(ref: bin/mapping.rs) Per-read per-base mapping tables."""
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    device = _resolve_device(args.device)
    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    maps = generate_mappings(dbg, PHMMParams.uniform(args.p_error), reads,
                             device, n_active=args.n_active)
    out.to_map_file(dbg, args.map_output, reads, maps)
    print(f"# wrote {args.map_output}")
    return maps


def cmd_freq(args):
    """(ref: bin/freq.rs) Node usage frequencies of the reads on a DBG."""
    from .multi_dbg import output as out
    from .multi_dbg.posterior import generate_mappings
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    device = _resolve_device(args.device)
    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    maps = generate_mappings(dbg, PHMMParams.uniform(args.p_error), reads, device)
    freqs = maps.to_node_freqs(dbg.n_edges_full())
    with open(args.output, "w") as f:
        f.write("# edge_in_full\tkmer\tcopy_num\tfreq\n")
        for e in range(dbg.n_edges_full()):
            f.write(f"{e}\t{dbg.kmer_full(e).decode()}\t{dbg.copy_num(e)}"
                    f"\t{freqs[e]:.4f}\n")
    print(f"# wrote {args.output}")


def cmd_table(args):
    """(ref: bin/table.rs) Per-read log-likelihood table under a DBG: the
    dense forward, in float64 on every device."""
    from .multi_dbg import output as out
    from .ops.forward import forward_scores, pad_reads, to_device
    from .phmm.params import PHMMParams
    from .seq.collection import ReadCollection

    device = _resolve_device(args.device)
    reads = ReadCollection.from_fasta(args.read_fasta)
    dbg = out.from_dbg_file(args.dbg_input)
    dm = to_device(dbg.to_phmm(PHMMParams.uniform(args.p_error)), device,
                   torch.float64)
    codes, lens = pad_reads(list(reads))
    scores = forward_scores(dm, torch.as_tensor(codes, device=device),
                            torch.as_tensor(lens, device=device), renorm=True)
    total = 0.0
    for i, s in enumerate(scores.cpu().tolist()):
        print(f"read {i}\tlen={lens[i]}\tlogP={s:.4f}")
        total += s
    print(f"# total logP(R|X) = {total:.4f}")
    return scores


def cmd_edit_dist(args):
    """(ref: bin/edit_dist.rs) Edit distances between two FASTAs' sorted
    sequences."""
    from .seq.io import parse_fasta
    from .utils import edit_distance

    a = sorted(seq for _n, _d, seq in parse_fasta(args.fasta_a))
    b = sorted(seq for _n, _d, seq in parse_fasta(args.fasta_b))
    print(f"# {len(a)} vs {len(b)} sequences")
    for i, (x, y) in enumerate(zip(a, b)):
        d = edit_distance(x, y)
        print(f"pair {i}\tlen {len(x)} vs {len(y)}\tedit_dist={d}")


def cmd_modify_dbg(args):
    """(ref: bin/modify_dbg.rs) Apply an INSPECT sample's copy numbers."""
    from .multi_dbg import output as out

    dbg = out.from_dbg_file(args.dbg_input)
    sample = out.parse_inspect_file(args.inspect)["samples"][args.sample_id]
    dbg.set_copy_nums(sample["copy_nums"])
    out.to_dbg_file(dbg, args.dbg_output)
    print(f"# applied sample {args.sample_id} -> {args.dbg_output}")


def cmd_extend_mapping(args):
    """(ref: bin/extend_mapping.rs; posterior/test.rs:145-237) At each k:
    carry the mapping across purge / k+1 extension, refine it, compare its
    likelihood with a fresh mapping's (``candidate_log_likelihoods`` over
    each mapping), and dump both as .map files."""
    import numpy as np

    from .e2e import Dataset
    from .multi_dbg import output as out
    from .multi_dbg.posterior import Mappings, generate_mappings
    from .ops.batch import candidate_log_likelihoods
    from .ops.forward import pad_reads
    from .ops.sparse import pad_mappings
    from .phmm.params import PHMMParams

    device = _resolve_device(args.device)
    ds = Dataset.from_json_file(args.dataset_json)
    dbg = out.from_dbg_file(args.dbg_input)
    params = PHMMParams.uniform(args.p_infer)
    reads = ds.reads
    paths = dbg.paths_from_styled_seqs(ds.genome)
    mappings = generate_mappings(dbg, params, reads, device)
    prefix = str(args.output_prefix)
    codes, lens = pad_reads(list(reads))

    def likelihood_with(mps):
        mn = pad_mappings(mps, codes.shape[1], max(a.shape[1] for a in mps.nodes))
        return float(candidate_log_likelihoods([dbg.to_phmm(params)], codes,
                                               lens, device, map_nodes=mn)[0])

    while dbg.k < args.k_max:
        dbg.set_copy_nums(_true_compact_copy_nums(dbg, paths))
        zero_edges = [e for e in range(dbg.n_edges_compact())
                      if dbg.copy_num_of_edge_in_compact(e) == 0]
        t0 = time.time()
        dbg, paths, maps_ext = dbg.purge_and_extend(
            zero_edges, args.k_max, True, paths, list(mappings.nodes))
        t_extend = time.time() - t0
        # refine the upconverted sets before scoring them and carrying them
        # on (ref: posterior/test.rs:184-187); nan weights mark the raw
        # upconversion as not a posterior
        hint = Mappings(list(maps_ext), [np.full(a.shape, np.nan) for a in maps_ext],
                        mappings.read_logps)
        t0 = time.time()
        mappings = generate_mappings(dbg, params, reads, device, hint=hint,
                                     verbose=True)
        t_refine = time.time() - t0
        t0 = time.time()
        mappings_true = generate_mappings(dbg, params, reads, device)
        t_map = time.time() - t0

        out.to_map_file(dbg, f"{prefix}.k{dbg.k}.extend.map", reads, mappings)
        out.to_map_file(dbg, f"{prefix}.k{dbg.k}.true.map", reads, mappings_true)
        out.to_dbg_file(dbg, f"{prefix}.k{dbg.k}.dbg")
        out.to_gfa_file(dbg, f"{prefix}.k{dbg.k}.gfa")
        print(f"k={dbg.k} p_extend={likelihood_with(mappings):.4f} "
              f"p_true={likelihood_with(mappings_true):.4f} "
              f"t_extend={t_extend * 1e3:.0f}ms t_refine={t_refine * 1e3:.0f}ms "
              f"t_map={t_map * 1e3:.0f}ms")


def cmd_sim_infer(args):
    """Inference against a dataset.json, with the truth diff (ref:
    bin/infer.rs)."""
    from .e2e import Dataset

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


def cmd_speed_test(args):
    """(ref: bin/speed_test.rs) The throughput benchmark
    (:func:`dbgphmm_tpu_torch.bench.main`, full shapes)."""
    from . import bench

    return bench.main(device=_resolve_device(args.device))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbgphmm_tpu_torch",
        description="Bayesian genome assembler, PyTorch/CUDA port",
    )
    p.add_argument(
        "--dist", default=None, metavar="ADDR:PORT,N,I",
        help="multi-process launch: rank 0's host:port, the total process"
             " count and this process's rank, joined in a gloo group ("
             "',,' reads torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE"
             " / RANK). Combine with --mesh to span every rank's devices;"
             " pin one GPU per rank with CUDA_VISIBLE_DEVICES. A rank whose"
             " peer failed stops after DBGPHMM_DIST_TIMEOUT_S seconds at"
             " most (default 1800).",
    )
    p.add_argument(
        "--mesh", default=None, metavar="CxR",
        help="shard over a device mesh of --device's type: 'CxR'"
             " (candidates x reads, e.g. 2x4) or a device count N"
             " (reads-sharded 1xN); replaces the reference's -t thread"
             " count (rayon read fan-out). Taken by infer, sim-infer and"
             " sample.",
    )
    sub = p.add_subparsers(dest="command", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (default, float32 + the "
                             "CUDA kernels) or cpu (float64, plain PyTorch)")

    rd = sub.add_parser("raw-dbg", help="construct raw DBG from reads -> GFA")
    rd.add_argument("-k", type=int, required=True)
    rd.add_argument("-m", "--min-count", type=int, default=2)
    rd.add_argument("-M", "--min-deadend-count", type=int, required=True)
    rd.add_argument("read_fasta")
    rd.add_argument("-g", "--gfa-output", required=True)
    rd.set_defaults(fn=cmd_raw_dbg)

    d = sub.add_parser("draft", help="construct draft DBG from reads")
    d.add_argument("-k", type=int, required=True)
    d.add_argument("-m", "--min-count", type=int, default=2)
    d.add_argument("-M", "--min-deadend-count", type=int, required=True)
    d.add_argument("-p", "--p-error", type=float, default=0.001)
    d.add_argument("-G", "--genome-size", type=int, required=True)
    d.add_argument("-P", "--n-haplotypes", type=int, default=None)
    d.add_argument("read_fasta")
    d.add_argument("-d", "--dbg-output", required=True)
    d.add_argument("-g", "--gfa-output", default=None)
    d.set_defaults(fn=cmd_draft)

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

    sd = sub.add_parser("sim-draft", help="generate synthetic dataset (+ draft)")
    sd.add_argument("-k", type=int, default=None)
    sd.add_argument("--unit-size", type=int, default=20)
    sd.add_argument("--n-unit", type=int, default=20)
    sd.add_argument("--unit-seed", type=int, default=0)
    sd.add_argument("--div-init", type=float, default=0.0)
    sd.add_argument("--div-seed", type=int, default=0)
    sd.add_argument("--end-length", type=int, default=100)
    sd.add_argument("--ploidy", "-P", type=int, default=2)
    sd.add_argument("--div-hap", type=float, default=0.02)
    sd.add_argument("--hap-seed", type=int, default=0)
    sd.add_argument("--read-seed", type=int, default=0)
    sd.add_argument("-C", "--coverage", type=int, default=10)
    sd.add_argument("-L", "--read-length", type=int, default=1000)
    sd.add_argument("-p", "--p-error", type=float, default=0.001)
    sd.add_argument("--fragment", action="store_true")
    sd.add_argument("-o", "--output-prefix", required=True)
    sd.set_defaults(fn=cmd_sim_draft)

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

    mp = sub.add_parser("mapping", help="dump per-read mapping tables")
    mp.add_argument("-d", "--dbg-input", required=True)
    mp.add_argument("-p", "--p-error", type=float, default=0.001)
    mp.add_argument("-n", "--n-active", type=int, default=40)
    mp.add_argument("read_fasta")
    mp.add_argument("-o", "--map-output", required=True)
    device_flag(mp)
    mp.set_defaults(fn=cmd_mapping)

    fr = sub.add_parser("freq", help="node usage frequencies")
    fr.add_argument("-d", "--dbg-input", required=True)
    fr.add_argument("-p", "--p-error", type=float, default=0.001)
    fr.add_argument("read_fasta")
    fr.add_argument("-o", "--output", required=True)
    device_flag(fr)
    fr.set_defaults(fn=cmd_freq)

    tb = sub.add_parser("table", help="per-read likelihood table")
    tb.add_argument("-d", "--dbg-input", required=True)
    tb.add_argument("-p", "--p-error", type=float, default=0.001)
    tb.add_argument("read_fasta")
    device_flag(tb)
    tb.set_defaults(fn=cmd_table)

    ed = sub.add_parser("edit-dist", help="edit distance between FASTAs")
    ed.add_argument("fasta_a")
    ed.add_argument("fasta_b")
    ed.set_defaults(fn=cmd_edit_dist)

    md = sub.add_parser("modify-dbg", help="apply INSPECT sample copy numbers")
    md.add_argument("-d", "--dbg-input", required=True)
    md.add_argument("--inspect", required=True)
    md.add_argument("--sample-id", type=int, default=0)
    md.add_argument("-o", "--dbg-output", required=True)
    md.set_defaults(fn=cmd_modify_dbg)

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

    em = sub.add_parser(
        "extend-mapping",
        help="compare mapping upconversion across k vs fresh mapping")
    em.add_argument("dataset_json")
    em.add_argument("-d", "--dbg-input", required=True)
    em.add_argument("-K", "--k-max", type=int, required=True)
    em.add_argument("-p", "--p-infer", type=float, default=0.001)
    em.add_argument("-o", "--output-prefix", required=True)
    device_flag(em)
    em.set_defaults(fn=cmd_extend_mapping)

    st = sub.add_parser("speed-test", help="throughput benchmark")
    device_flag(st)
    st.set_defaults(fn=cmd_speed_test)
    return p


def main(argv=None):
    """Parse ``argv`` and run the command; returns the command's result
    (infer / sim-infer: (dbg, posterior, per-stage times); inspect: the two
    Scores; sample / sample-from-true: the Posterior; sim-draft: the
    Dataset; mapping: the Mappings; table: the per-read scores; speed-test:
    the benchmark's lines)."""
    # SIGUSR1 -> every thread's stack on the process's stderr, and the run
    # goes on: how a supervisor (or a person) sees where a silent run is
    # stuck (sys.__stderr__: a caller may have swapped sys.stderr for a
    # stream without a file descriptor)
    faulthandler.register(signal.SIGUSR1, file=sys.__stderr__, all_threads=True)
    args = build_parser().parse_args(argv)
    if args.mesh and args.command not in MESH_COMMANDS:
        raise SystemExit(f"dbgphmm_tpu_torch: --mesh is taken by "
                         f"{', '.join(MESH_COMMANDS)}, not {args.command}")
    if args.dist:
        from .parallel.multihost import initialize, parse_dist_arg

        initialize(*((None, None, None) if args.dist.strip(",") == ""
                     else parse_dist_arg(args.dist)))
    t0 = time.time()
    print(f"# started_at={time.strftime('%Y-%m-%d %H:%M:%S')}")
    print("# version=dbgphmm_tpu_torch")
    print(f"# args={vars(args)}")
    result = args.fn(args)
    print(f"# finished_at={time.strftime('%Y-%m-%d %H:%M:%S')} "
          f"elapsed={time.time()-t0:.1f}s")
    if args.dist:
        torch.distributed.destroy_process_group()
    return result
