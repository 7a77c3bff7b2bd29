"""The port's span recorder (dbgphmm_tpu_torch.tracing) on the small
diploid of tests/test_torch_posterior.py, in both mapping regimes: the
from-scratch decodes of a small graph, and seeding + refine (the seeded
regime, forced by setting DENSE_COMPUTE_MAX_NODES to 0).

Each run records every span as it closes, so that the old StageTimes
fields can be held to the spans they sum, the spans to their nesting, and
the counters to what the run printed.
"""

import contextlib
import io
import json
import re
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import dbgphmm_tpu_torch.multi_dbg.posterior as TP
from dbgphmm_tpu_torch import multi_dbg, tracing
from dbgphmm_tpu_torch.multi_dbg import neighbors
from dbgphmm_tpu_torch.phmm.params import PHMMParams
from dbgphmm_tpu_torch.seq import collection, genome

REGIMES = ("small", "seeded")
SPAN_NAMES = set(tracing.SELF_FIELDS) | set(tracing.DURATION_FIELDS) | {
    "map", "sample"}


def small_diploid():
    h1 = b"TTAGGCTTCGATCGAATGCC"
    h2 = b"TTAGGCTTGGATCGAATGCC"
    return genome.Genome([collection.StyledSequence.linear(h1),
                          collection.StyledSequence.linear(h2)])


def perfect_reads(g, coverage=12, read_len=16, seed=1):
    rng = np.random.default_rng(seed)
    reads = []
    for s in g:
        for _ in range(int(len(s.seq) * coverage / read_len)):
            st = rng.integers(0, len(s.seq) - read_len + 1)
            reads.append(s.seq[st: st + read_len])
    return collection.ReadCollection(reads)


def infer(regime, monkeypatch, **kw):
    """k=8 -> 10 and the final pass, from a draft a +-1 cycle away from
    the truth (so the k=8 climb moves); (stage times, printed text)."""
    if regime == "seeded":
        monkeypatch.setattr(TP, "DENSE_COMPUTE_MAX_NODES", 0)
    g = small_diploid()
    reads = perfect_reads(g)
    params = PHMMParams.uniform(0.001)
    draft = multi_dbg.MultiDbg.from_styled_seqs(8, list(g))
    draft.set_copy_nums([1, 0, 1, 1])
    stages, out = [], io.StringIO()
    with contextlib.redirect_stdout(out):
        TP.infer_posterior_by_extension(
            k_max=10, dbg_init=draft, param_infer=params, param_error=params,
            reads=reads, genome_size_expected=g.genome_size(),
            genome_size_sigma=5, max_iter=10, p0=0.8, n_haplotypes=2,
            device="cpu", stage_times=stages, verbose=True, **kw)
    return SimpleNamespace(stages=stages, text=out.getvalue(),
                           n_reads=len(reads))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=REGIMES)
def run(request):
    """One inference of the regime with every span recorded as it closes:
    (name, also, collector, start ns, end ns, child ns)."""
    spans = []
    close = tracing._Span.__exit__

    def recorded(self, *exc):
        out = close(self, *exc)
        dur = round(self.s * 1e9)
        spans.append(SimpleNamespace(name=self.name, also=self.also,
                                     times=self.times, t0=self.t0,
                                     t1=self.t0 + dur, child=self.child))
        return out

    # per climb sweep: (its collector, the climb graph's 0x compact edges);
    # per k-shortest search: (its collector, the paths it returned)
    sweeps, searches = [], []
    rescue, paths = TP.to_rescue_neighbors, neighbors.k_shortest_simple_path

    def noted_rescue(dbg, *a, **kw):
        sweeps.append((tracing._times, sum(
            dbg.copy_num_of_edge_in_compact(e) == 0
            for e in range(dbg.n_edges_compact()))))
        return rescue(dbg, *a, **kw)

    def noted_paths(*a, **kw):
        out = paths(*a, **kw)
        searches.append((tracing._times, len(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing._Span, "__exit__", recorded)
        mp.setattr(TP, "to_rescue_neighbors", noted_rescue)
        mp.setattr(neighbors, "k_shortest_simple_path", noted_paths)
        got = infer(request.param, mp)
    got.regime, got.spans = request.param, spans
    got.sweeps, got.searches = sweeps, searches
    return got


def test_old_fields_are_the_sums_of_their_spans(run):
    """wall_s, seed_s, setup_s and score_s are the durations of their
    spans; decode_s and refine_s those of the from-scratch and hinted
    map.prep / map.launch / map.fetch; the parts of the mapping sum to
    decode_s + refine_s; host_s stays the remainder."""
    assert [st.k for st in run.stages] == [8, 10, -1]
    for st in run.stages:
        mine = [sp for sp in run.spans if sp.times is st]

        def total(*names, also=None):
            return sum((sp.t1 - sp.t0) * 1e-9 for sp in mine
                       if sp.name in names
                       and (also is None or sp.also == also))

        approx = lambda v: pytest.approx(v, rel=1e-9, abs=1e-12)
        assert [sp.name for sp in mine].count("stage") == 1
        assert st.wall_s == approx(total("stage"))
        assert st.seed_s == approx(total("map.seed"))
        assert st.setup_s == approx(total("sample.setup"))
        assert st.score_s == approx(total("sample.reads"))
        parts = ("map.prep", "map.launch", "map.fetch")
        assert all(sp.child == 0 for sp in mine if sp.name in parts)
        assert st.decode_s == approx(total(*parts, also="decode_s"))
        assert st.refine_s == approx(total(*parts, also="refine_s"))
        assert st.map_prep_s + st.map_launch_s + st.map_fetch_s == approx(
            st.decode_s + st.refine_s)
        d = st.as_dict()
        assert d["host_s"] == approx(st.wall_s - st.seed_s - st.decode_s
                                     - st.refine_s - st.setup_s - st.score_s)
        if run.regime == "seeded":
            assert st.seed_s > 0 and st.refine_s > 0 and st.decode_s == 0
            parts = (st.seed_index_s, st.seed_hits_s, st.seed_chain_s,
                     st.seed_rows_s)
            assert all(p > 0 for p in parts) and sum(parts) <= st.seed_s
        else:
            assert st.seed_s == 0
    if run.regime == "small":  # from scratch at k=8 and in the final pass
        assert run.stages[0].decode_s > 0 and run.stages[-1].decode_s > 0


def test_spans_nest_and_untraced_time_is_not_negative(run):
    """Every span lies inside the span that was open when it opened, every
    span inside its stage, every map.* inside a map; untraced_s >= 0."""
    spans = sorted(run.spans, key=lambda sp: (sp.t0, -sp.t1))
    stack = []
    for sp in spans:
        while stack and stack[-1].t1 <= sp.t0:
            stack.pop()
        if stack:
            assert sp.t1 <= stack[-1].t1, (sp.name, stack[-1].name)
        else:
            assert sp.name == "stage"
        if sp.name.startswith("map."):
            assert any(o.name == "map" for o in stack), sp.name
        if sp.name == "seed.index":
            assert stack[-1].name == "map.seed"
        stack.append(sp)
    assert {sp.name for sp in spans} == SPAN_NAMES - (
        {"map.seed", "seed.index"} if run.regime == "small" else set())
    for st in run.stages:
        assert st.as_dict()["untraced_s"] >= 0
        assert 0 < st.named_s <= st.wall_s


SETUP = ("setup.template", "setup.positions", "setup.streams")


def test_setup_and_climb_parts_sum_to_their_spans(run):
    """setup_s and neighbors_s are the durations of sample.setup and
    sample.neighbors.  The setup.* fields are their spans' self times and
    sum to setup_s less sample.setup's own time, a few microseconds a span
    (the parts cover all of its work).  neighbors_network_s is its span's
    self time; the paths and cycles timers lie in sample.neighbors' own
    time, and the three sum to neighbors_s less the loops' glue."""
    for st in run.stages:
        mine = [sp for sp in run.spans if sp.times is st]

        def total(*names):
            return sum((sp.t1 - sp.t0) * 1e-9 for sp in mine
                       if sp.name in names)

        def own(*names):
            return sum((sp.t1 - sp.t0 - sp.child) * 1e-9 for sp in mine
                       if sp.name in names)

        approx = lambda v: pytest.approx(v, rel=1e-9, abs=1e-12)
        assert st.setup_s == approx(total("sample.setup"))
        assert st.neighbors_s == approx(total("sample.neighbors"))
        setup = (st.setup_template_s, st.setup_positions_s,
                 st.setup_streams_s)
        assert setup == tuple(approx(own(n)) for n in SETUP)
        rescue = (st.neighbors_network_s, st.neighbors_paths_s,
                  st.neighbors_cycles_s)
        assert st.neighbors_network_s == approx(own("neighbors.network"))
        timed = st.neighbors_paths_s + st.neighbors_cycles_s
        assert 0 <= timed <= own("sample.neighbors")
        assert all(x > 0 for x in setup)
        assert st.setup_s - sum(setup) == approx(own("sample.setup"))
        for parts, whole, parent in ((setup, st.setup_s, "sample.setup"),
                                     (rescue, st.neighbors_s,
                                      "sample.neighbors")):
            rest = whole - sum(parts)
            n = [sp.name for sp in mine].count(parent)
            assert 0 <= rest <= n * 1e-3, (parent, rest, whole)
    assert run.stages[0].neighbors_paths_s > 0  # the k=8 climb rescues
    # the final pass's short and reducer neighbourhoods are cycles
    assert run.stages[-1].neighbors_cycles_s > 0


def test_setup_and_climb_parts_nest_in_their_spans(run):
    """Each setup.* span lies directly inside a sample.setup, each
    neighbors.network directly inside a sample.neighbors: a rescue sweep
    opens it twice (the climb graph's copy numbers, then the MSE
    networks); the final pass's full neighbourhood opens more."""
    spans = sorted(run.spans, key=lambda sp: (sp.t0, -sp.t1))
    stack = []
    for sp in spans:
        while stack and stack[-1].t1 <= sp.t0:
            stack.pop()
        if sp.name in SETUP:
            assert stack[-1].name == "sample.setup"
        if sp.name == "neighbors.network":
            assert stack[-1].name == "sample.neighbors"
        stack.append(sp)
    for st in run.stages:
        names = [sp.name for sp in run.spans if sp.times is st]
        n = names.count("sample.setup")
        assert [names.count(x) for x in SETUP] == [n] * 3
        sweeps = names.count("sample.neighbors")
        if st.k > 0:
            assert names.count("neighbors.network") == 2 * sweeps
        else:
            assert names.count("neighbors.network") > 2 * sweeps


def test_rescue_counters_count_the_climb(run):
    """zero_edges is the climb graph's 0x compact edges summed over the
    stage's sweeps; rescue_paths the paths its k-shortest searches
    returned."""
    assert run.sweeps and run.searches
    for st in run.stages:
        assert st.zero_edges == sum(n for t, n in run.sweeps if t is st)
        assert st.rescue_paths == sum(n for t, n in run.searches if t is st)
    assert run.stages[0].zero_edges > 0 and run.stages[0].rescue_paths > 0


def test_counters_agree_with_the_run(run):
    """Candidates scored after dedup are among those generated, the kept
    bytes among those fetched, every read is mapped once a stage, and a
    move is one `moved to` line."""
    moved = len(re.findall(r"\[posterior\] moved to p=", run.text))
    assert moved >= (run.regime == "seeded")  # the seeded k=8 climb moves
    assert sum(st.climb_iters for st in run.stages) == moved
    for st in run.stages:
        assert 0 < st.candidates_scored <= st.candidates or (
            st.candidates == st.candidates_scored == 0)
        assert 0 < st.kept_bytes <= st.fetch_bytes
        assert st.reads == run.n_reads and st.reads_gated <= st.reads
        assert st.n_scorings >= st.candidates_scored * run.n_reads
        d = st.as_dict()
        if run.regime == "seeded":
            assert st.reads_unseeded == 0 and d["seed_cover"] == 1.0
        else:
            assert st.reads_unseeded == 0 and d["seed_cover"] == 0.0
    assert run.stages[0].candidates > 0
    assert run.stages[-1].edges_purged == 0  # the final pass purges nothing
    if run.regime == "small":  # a decode from scratch keeps the read rows
        assert run.stages[0].kept_bytes < run.stages[0].fetch_bytes


def test_the_stage_line_carries_every_field():
    d = tracing.StageTimes(k=40).as_dict()
    for key in ("seed_s", "decode_s", "refine_s", "setup_s", "score_s",
                "host_s", "wall_s", "n_scorings", "n_rescued",
                "scorings_per_s", "untraced_s", "seed_cover"):
        assert key in d
    fields = set(tracing.SELF_FIELDS.values()) | set(
        tracing.DURATION_FIELDS.values())
    assert fields <= set(d)
    assert {"reads", "reads_unseeded", "reads_gated", "fetch_bytes",
            "kept_bytes", "climb_iters", "candidates", "candidates_scored",
            "edges_purged", "zero_edges", "rescue_paths"} <= set(d)
    assert not {"named_s", "seed_positions", "seed_hit_positions"} & set(d)
    json.dumps(d)


def test_profiler_trace_holds_every_span(monkeypatch, tmp_path):
    """Under torch.profiler every span is a user_annotation of the
    exported chrome trace: each map.* inside a map, each span inside a
    stage, the i-th stage as long as the i-th StageTimes."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = infer("seeded", monkeypatch)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if ev.get("cat") == "user_annotation" and ev.get("ph") == "X"]
    iv = lambda ev: (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
    by = lambda name: sorted(iv(ev) for ev in events if ev["name"] == name)
    assert SPAN_NAMES <= {ev["name"] for ev in events}
    inside = lambda a, outer: any(o[0] - 0.01 <= a[0] and a[1] <= o[1] + 0.01
                                  for o in outer)
    stages, maps = by("stage"), by("map")
    assert len(stages) == len(got.stages) == 3
    for (a, b), st in zip(stages, got.stages):
        assert abs((b - a) * 1e-6 - st.wall_s) < 2e-3 + 0.01 * st.wall_s
    for name in SPAN_NAMES - {"stage"}:
        for a in by(name):
            assert inside(a, stages), name
            if name.startswith("map."):
                assert inside(a, maps), name


def test_without_a_profiler_record_function_is_never_entered(monkeypatch):
    def refuse(*_a, **_kw):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    got = infer("seeded", monkeypatch)
    assert got.stages[0].wall_s > 0 and got.stages[0].seed_s > 0
    # with nothing recording a span is the shared no-op, a timer too
    assert tracing.span("map.prep") is tracing.OFF
    assert tracing.timer("seed_hits_s") is tracing.OFF
    assert tracing.span("sample.reads", clock=True) is not tracing.OFF


def test_a_mapping_pass_splits_its_seeding(monkeypatch):
    """generate_mappings with a collector of its own (the `mapping`
    command's pass): the four seeding parts fit in seed_s, the mapping's
    parts sum to refine_s, and each read is counted once."""
    monkeypatch.setattr(TP, "DENSE_COMPUTE_MAX_NODES", 0)
    g = small_diploid()
    reads = perfect_reads(g)
    dbg = multi_dbg.MultiDbg.from_styled_seqs(8, list(g))
    times = tracing.StageTimes(k=dbg.k)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        t0 = time.perf_counter()
        maps = TP.generate_mappings(dbg, PHMMParams.uniform(0.001), reads,
                                    "cpu", times=times)
        times.wall_s = time.perf_counter() - t0
    d = times.as_dict()
    parts = (times.seed_index_s + times.seed_hits_s + times.seed_chain_s
             + times.seed_rows_s)
    assert 0 < parts <= times.seed_s
    assert times.map_prep_s + times.map_launch_s + times.map_fetch_s == \
        pytest.approx(times.refine_s, rel=1e-9)
    assert times.reads == maps.n_reads() == len(reads)
    assert 0 <= d["untraced_s"] < times.wall_s
    assert re.search(r"\[seed\] \d+ reads seeded in [\d.]+s \(cover "
                     r"480/480 = 1\.0000", out.getvalue())
