#!/bin/bash
#
# The port's production-scale runs on one GPU, each a command of its own
# (run from the root of a checkout; outputs under runs/, copies of what is
# kept under $SCALE_RUNS_OUT, default runs/out):
#
#   scale_runs.sh r1 [SECONDS]  # n5 from k=40 on data/bench with the JAX
#       run's arguments (runs_n5_launch.log: sim-infer -K 10000 -e 0.0003
#       -p 0.0003 -S 5000 -I 50 --p0 0.99) under sim.sh supervise, stopped
#       after SECONDS (default 2400); beside it, on the host, the KIR-class
#       draft of sim.sh run_kir (r2's input)
#   scale_runs.sh r2 [SECONDS]  # one KIR-class stage: sim-infer -K 40 -I 2
#       with r1's other arguments on runs/kir/data.{json,dbg}; the k=40
#       stage's times and the peak device memory print as the stage closes
#       (its checkpoint is written), and the run stops there, before the
#       final full-neighbourhood pass; at most SECONDS (default 1500)
#   scale_runs.sh r3            # validate_large_n_mapping.py on the card
#   scale_runs.sh r4 PREFIX K DATASET  # bench_real_graph.py and
#       k1_launch_report.py on the checkpoint PREFIX.kK.dbg (with its
#       .map.mpz where it exists; else each tool maps the reads itself)
#
# Hold r1 against the JAX run's log with
#   python dbgphmm_tpu_torch/scripts/perk_budget.py <r1 log>
#   python scripts/perk_budget.py runs_n5_launch.log
#   python dbgphmm_tpu_torch/scripts/compare_run_logs.py <r1 log> runs_n5_launch.log

set -u
OUT=${SCALE_RUNS_OUT:-runs/out}
S=dbgphmm_tpu_torch/scripts
N5=runs/n5/dbgphmm/pz0.99_pi0.0003
KIR=runs/kir/dbgphmm/pz0.99_pi0.0003
ARGS=(-e 0.0003 -p 0.0003 -S 5000 -I 50 --p0 0.99)

card() {
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
  python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
}

r1() {
  local RUN_S=${1:-2400} O=$OUT/r1
  mkdir -p $O runs/n5/dbgphmm runs/kir
  card | tee $O/smi.txt
  ( python -m dbgphmm_tpu_torch sim-draft -k 40 -C 15 -L 10000 -p 0.0003 \
      --fragment --unit-size 20000 --n-unit 8 --end-length 2000 \
      --div-hap 0.01 --div-init 0.0002 -P 2 --read-seed 1 \
      -o runs/kir/data > $O/kir_draft.log 2>&1 ) &
  local dpid=$! t0
  t0=$(date +%s)
  # its own process group, so that the time limit stops the run as well
  setsid bash $S/sim.sh supervise $N5 data/bench/data.dbg sim-infer \
    data/bench/data.json -K 10000 "${ARGS[@]}" &
  local spid=$! kp
  ( sleep "$RUN_S"; kill -TERM -- -$spid; sleep 15; kill -KILL -- -$spid ) 2>/dev/null &
  kp=$!
  wait $spid
  echo "# r1: supervise rc=$? after $(( $(date +%s) - t0 )) s" | tee -a $O/smi.txt
  kill $kp 2>/dev/null
  wait $dpid; echo "# kir draft rc=$?" | tee -a $O/smi.txt
  card | tee -a $O/smi.txt
  python - "$O" <<'EOF'
import glob, os, re, shutil, sys
O = sys.argv[1]
budget = 56 << 20
def put(src, sub):
    global budget
    if not os.path.exists(src):
        return
    n = os.path.getsize(src)
    if n > budget:
        print("# r1: skipped", src, n)
        return
    os.makedirs(os.path.join(O, sub), exist_ok=True)
    shutil.copy(src, os.path.join(O, sub))
    budget -= n
P = "runs/n5/dbgphmm/pz0.99_pi0.0003"
put(P + ".log", "n5")
for f in sorted(glob.glob(P + ".k*.dbg") + glob.glob(P + ".k*.inspect")):
    put(f, "n5")
for f in glob.glob("runs/kir/data.*"):
    put(f, "kir")
ks = sorted(int(re.search(r"\.k(\d+)\.inspect$", f).group(1))
            for f in glob.glob(P + ".k*.inspect"))
order = ks[-1:] + [k for k in (44, 45, 43, 46, 42, 41, 40, 47, 48) if k in ks]
for k in dict.fromkeys(order):
    put(f"{P}.k{k}.map.mpz", "n5")
for k in ks:
    put(f"{P}.k{k}.post", "n5")
print("# r1: stages", ks, "left", budget)
EOF
}

r2() {
  local RUN_S=${1:-1500} O=$OUT/r2
  mkdir -p $O runs/kir/dbgphmm
  card | tee $O/smi.txt
  PYTHONUNBUFFERED=1 timeout -k 20 "$RUN_S" python - sim-infer runs/kir/data.json \
    -d runs/kir/data.dbg -o $KIR -K 40 -e 0.0003 -p 0.0003 -S 5000 -I 2 --p0 0.99 \
    > $KIR.log 2>&1 <<'EOF'
import json, os, sys
import torch
from dbgphmm_tpu_torch import cli
from dbgphmm_tpu_torch.multi_dbg import posterior as P

def peak():
    return (torch.cuda.max_memory_allocated() if torch.cuda.is_available()
            else "not measured")

class Printing(list):
    """Prints the first stage's times, and the peak device memory so far,
    as the stage closes, and ends the run."""
    def append(self, st):
        print(f"# stage-closed {json.dumps(st.as_dict())} "
              f"peak_bytes={peak()}", flush=True)
        os._exit(0)

infer = P.infer_posterior_by_extension
P.infer_posterior_by_extension = lambda **kw: infer(
    **dict(kw, stage_times=Printing()))
if torch.cuda.is_available():
    torch.cuda.reset_peak_memory_stats()
cli.main(sys.argv[1:])
EOF
  echo "# r2: rc=$?" | tee -a $O/smi.txt
  cp $KIR.log $O/
  ls -la runs/kir/dbgphmm | tee -a $O/smi.txt
}

r3() {
  mkdir -p $OUT/r3
  card | tee $OUT/r3/validate.log
  python $S/validate_large_n_mapping.py --device cuda 2>&1 | tee -a $OUT/r3/validate.log
}

r4() {  # r4 PREFIX K DATASET (without PREFIX.kK.map.mpz the tools map)
  local P=$1 K=$2 DS=$3 O=$OUT/r4 M=()
  mkdir -p $O
  [ -e $P.k$K.map.mpz ] && M=($P.k$K.map.mpz)
  card | tee -a $O/r4.log
  python $S/bench_real_graph.py $P.k$K.dbg $DS "${M[@]}" --device cuda 2>&1 | tee -a $O/r4.log
  python $S/k1_launch_report.py $P.k$K.dbg $DS "${M[@]}" 2>&1 | tee -a $O/r4.log
}

"$@"
