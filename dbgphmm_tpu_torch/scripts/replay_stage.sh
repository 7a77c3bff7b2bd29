#!/bin/bash
#
# Replay a k-stage of a seeded sim-infer run on the CPU in both packages,
# from one starting graph, and hold the two logs against each other:
#
#   replay_stage.sh DBG MAP|- DATASET OUT STOP_K [N_READS] [MAX_ITER]
#
# DBG (a draft, or a checkpoint's .kK.dbg of either package: the formats
# are shared) with MAP (its .map.mpz; `-`: none, each run maps the reads
# itself) starts both CLIs' sim-infer, as a supervisor restarts a run;
# each run is stopped once its `[infer] k=STOP_K posterior sampled` line is
# printed.  The port runs `python -m dbgphmm_tpu_torch ... --device cpu`
# (float64, K1's twin), the JAX package `python -m dbgphmm_tpu --cpu ...`
# with DBGPHMM_PALLAS=0 (its float64 XLA scorer).  Both take
# runs_n5_launch.log's arguments with -I MAX_ITER (default 50); N_READS
# (default all) keeps the first reads of DATASET and of MAP.  Writes
# OUT/{port,jax}.log and prints compare_run_logs.py's table of the two.

set -u
DBG=$1 MAP=$2 DS=$3 OUT=$4 STOP=$5 NR=${6:-0} IT=${7:-50}
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" PYTHONUNBUFFERED=1
mkdir -p "$OUT"
python - "$DBG" "$MAP" "$DS" "$OUT" "$NR" <<'EOF'
import json, sys
from dbgphmm_tpu_torch.e2e import Dataset
from dbgphmm_tpu_torch.multi_dbg import output as out
from dbgphmm_tpu_torch.multi_dbg.posterior import Mappings

dbg_path, map_path, ds_path, o, n = sys.argv[1:6]
ds = json.load(open(ds_path))
n = int(n) or len(ds["reads"])
ds["reads"] = ds["reads"][:n]
json.dump(ds, open(f"{o}/data.json", "w"))
if map_path != "-":
    maps = out.from_map_file(map_path)
    reads = Dataset.from_json_file(f"{o}/data.json").reads
    out.to_map_file(out.from_dbg_file(dbg_path), f"{o}/start.map.mpz", reads,
                    Mappings(maps.nodes[:n], maps.logps[:n]))
EOF
ARGS=(sim-infer "$OUT/data.json" -d "$DBG" -K 10000 -e 0.0003 -p 0.0003
      -S 5000 -I "$IT" --p0 0.99)
[ "$MAP" != "-" ] && ARGS+=(--map "$OUT/start.map.mpz")

run_until() {  # run_until LOG CMD...: stop CMD once LOG has stage STOP
  local LOG=$1; shift
  "$@" > "$LOG" 2>&1 &
  local pid=$!
  while kill -0 $pid 2>/dev/null; do
    if grep -q "\[infer\] k=$STOP posterior sampled" "$LOG"; then
      kill $pid; break
    fi
    sleep 2
  done
  wait $pid 2>/dev/null
}

run_until "$OUT/port.log" python -m dbgphmm_tpu_torch "${ARGS[@]}" -o "$OUT/port" --device cpu &
p1=$!
run_until "$OUT/jax.log" env DBGPHMM_PALLAS=0 JAX_PLATFORMS=cpu \
  python -m dbgphmm_tpu --cpu "${ARGS[@]}" -o "$OUT/jax" &
p2=$!
wait $p1 $p2
python "$REPO/dbgphmm_tpu_torch/scripts/compare_run_logs.py" "$OUT/port.log" "$OUT/jax.log"
