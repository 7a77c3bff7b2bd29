#!/bin/bash
#
# Simulation harness of the PyTorch/CUDA port: makes the synthetic datasets
# with the port's sim-draft, runs `python -m dbgphmm_tpu_torch sim-infer` on
# them under a supervisor that restarts it from its per-k checkpoints, and
# evaluates the assembly against the true genome.  The external assemblers
# (hifiasm, LJA, verkko) run when they are on PATH and are skipped with a
# note otherwise; nothing is downloaded.
#
# Usage:
#   sim.sh run_u500 <outdir> <K> [CLI args...]   # u500(8), k=40 -> K
#   sim.sh run_n4 <outdir> [H] [H0] [SEED]       # one n4 config
#   sim.sh run_kir <outdir> [H] [H0] [K]
#   sim.sh run_n10 <outdir> [H] [H0]
#   sim.sh run_all <outdir>                      # the n4 sweep
#   sim.sh supervise <prefix> <draft.dbg> <command> [CLI args...]
#
# CLI args are passed through to every attempt (e.g. --device cpu).
# DBGPHMM_STALL_S (default 1200): seconds of log silence before the
# supervisor dumps the run's stacks and restarts it;
# DBGPHMM_STALL_DUMP_S (default 60): seconds it then waits for the dump
# before SIGTERM.

set -u
REPO="$(cd "$(dirname "$0")/../.." && pwd)"
PY="${PYTHON:-python}"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export OMP_NUM_THREADS=1   # host BLAS threading
export PYTHONUNBUFFERED=1  # keep the logs live for long runs

DBG() { $PY -m dbgphmm_tpu_torch "$@"; }

have() { command -v "$1" >/dev/null 2>&1; }

map_to_genome() {
  # minimap2 PAF if available; else the exact edit-distance evaluation
  # stands alone
  local GENOME=$1 ASM=$2
  if have minimap2; then
    minimap2 -c --cs -t4 -x asm20 "$GENOME" "$ASM"
  else
    echo "# minimap2 not found; skipping PAF for $ASM" >&2
  fi
}

evaluate_asm() {
  # exact + edit-distance evaluation against the true genome; always runs
  local GENOME=$1 ASM=$2
  DBG edit-dist "$GENOME" "$ASM"
  map_to_genome "$GENOME" "$ASM" > "$ASM.paf" 2>/dev/null || true
}

run_hifiasm() {
  local KEY=$1
  have hifiasm || { echo "# hifiasm not found; skipping"; return 0; }
  mkdir -p "$KEY/hifiasm"
  hifiasm -o "$KEY/hifiasm/out" -t4 -f0 -i "$KEY/data.reads.fa" \
    2> "$KEY/hifiasm/log"
  awk '/^S/{print ">"$2; print $3}' "$KEY/hifiasm/out.bp.p_ctg.gfa" \
    > "$KEY/hifiasm/out.fa"
  evaluate_asm "$KEY/data.genome.fa" "$KEY/hifiasm/out.fa"
}

run_lja() {
  local KEY=$1
  have lja || { echo "# lja not found; skipping"; return 0; }
  mkdir -p "$KEY/lja"
  lja -o "$KEY/lja" --reads "$KEY/data.reads.fa" > "$KEY/lja/log" 2>&1
  evaluate_asm "$KEY/data.genome.fa" "$KEY/lja/assembly.fasta"
}

run_verkko() {
  local KEY=$1
  have verkko || { echo "# verkko not found; skipping"; return 0; }
  mkdir -p "$KEY/verkko"
  verkko -d "$KEY/verkko" --hifi "$KEY/data.reads.fa" > "$KEY/verkko/log" 2>&1
  evaluate_asm "$KEY/data.genome.fa" "$KEY/verkko/assembly.fasta"
}

deepest_k() {
  # the deepest k whose checkpoint PRE.k<N>.* is complete: its .inspect,
  # the last file a k-stage dumps, exists
  ls "$1".k*.inspect 2>/dev/null \
    | sed 's/.*\.k\([0-9]*\)\.inspect$/\1/' | sort -n | tail -1
}

supervise() {
  # supervise PRE DRAFT COMMAND [ARGS...]: run `python -m dbgphmm_tpu_torch
  # COMMAND ARGS -o PRE -d <start>` in the background, its output appended
  # to PRE.log, where <start> is the deepest complete checkpoint
  # (-d PRE.k<N>.dbg --map PRE.k<N>.map.mpz) or else DRAFT.  A run that
  # exits non-zero is restarted from the deepest checkpoint, worked out
  # again after each attempt; a run whose log has been silent for
  # DBGPHMM_STALL_S seconds gets SIGUSR1 (its CLI dumps every thread's
  # stack into the log), DBGPHMM_STALL_DUMP_S seconds to finish the dump,
  # then SIGTERM (SIGKILL after 10 s more), and is restarted.  Gives up after
  # 12 restarts after a crash or 12 after a stall, each counted on its own.
  local PRE=$1 DRAFT=$2; shift 2
  local LOG="$PRE.log" attempt=0 stalls=0 stall=${DBGPHMM_STALL_S:-1200}
  local dump_wait=${DBGPHMM_STALL_DUMP_S:-60}
  mkdir -p "$(dirname "$PRE")"
  while :; do
    local ARGS=( "$@" -o "$PRE" ) LASTK FROM=draft stalled=0
    LASTK=$(deepest_k "$PRE")
    if [ -n "$LASTK" ]; then
      ARGS+=( -d "$PRE.k$LASTK.dbg" --map "$PRE.k$LASTK.map.mpz" )
      FROM=k$LASTK
    else
      ARGS+=( -d "$DRAFT" )
    fi
    $PY -m dbgphmm_tpu_torch "${ARGS[@]}" >> "$LOG" 2>&1 &
    local wpid=$!
    echo "# supervise: attempt=$attempt pid=$wpid from=$FROM" >> "$LOG"
    while kill -0 "$wpid" 2>/dev/null; do
      sleep 2
      local age=$(( $(date +%s) - $(stat -c %Y "$LOG" 2>/dev/null || date +%s) ))
      if [ "$age" -gt "$stall" ]; then
        echo "# supervise: no log progress for ${age}s; stack-dumping pid $wpid (${dump_wait}s) then restarting" >> "$LOG"
        stalled=1
        kill -USR1 "$wpid" 2>/dev/null
        local waited=0
        while [ "$waited" -lt "$dump_wait" ] && kill -0 "$wpid" 2>/dev/null; do
          sleep 1
          waited=$((waited+1))
        done
        kill "$wpid" 2>/dev/null
        waited=0
        while [ "$waited" -lt 10 ] && kill -0 "$wpid" 2>/dev/null; do
          sleep 1
          waited=$((waited+1))
        done
        kill -9 "$wpid" 2>/dev/null
      fi
    done
    wait "$wpid"
    local rc=$?
    [ "$rc" -eq 0 ] && return 0
    if [ "$stalled" -eq 1 ]; then
      stalls=$((stalls+1))
      if [ "$stalls" -gt 12 ]; then
        echo "# supervise: giving up after $stalls stalls" | tee -a "$LOG"
        return 1
      fi
      echo "# supervise: rc=$rc stall=$stalls restarting from the deepest checkpoint" | tee -a "$LOG"
      continue
    fi
    attempt=$((attempt+1))
    if [ "$attempt" -gt 12 ]; then
      echo "# supervise: giving up after $attempt attempts" | tee -a "$LOG"
      return 1
    fi
    echo "# supervise: rc=$rc attempt=$attempt restarting from the deepest checkpoint" | tee -a "$LOG"
  done
}

run_dbgphmm() {  # run_dbgphmm KEY p [K] [CLI args...]
  local KEY=$1 p=$2 K=${3:-10000}
  shift $(( $# < 3 ? $# : 3 ))
  local pz=0.99
  local PRE="$KEY/dbgphmm/pz${pz}_pi${p}"
  supervise "$PRE" "$KEY/data.dbg" sim-infer "$KEY/data.json" -K "$K" \
    -e "$p" -p "$p" -S 5000 -I 50 --p0 "$pz" "$@" || return 1
  evaluate_asm "$KEY/data.genome.fa" "$PRE.final.euler.fa"
}

run_u500() {  # u500(8): the small-graph flagship, the CLI's defaults
  # a diploid tandem repeat of 8 units of 500 bases (2% divergence between
  # units and between haplotypes) between 300-base unique ends, 15x
  # full-length reads at 0.1% error, k=40 draft; sim-infer k=40 -> K with
  # the CLI's default flags (-I 50 -S 100)
  local KEY=$1 K=$2; shift 2
  mkdir -p "$KEY"
  DBG sim-draft -k 40 --unit-size 500 --n-unit 8 --unit-seed 0 \
    --div-init 0.02 --div-seed 1 --end-length 300 -P 2 --div-hap 0.02 \
    --hap-seed 0 -C 15 -L 10000 -p 0.001 -o "$KEY/data" || return 1
  local PRE="$KEY/dbgphmm/run"
  supervise "$PRE" "$KEY/data.dbg" sim-infer "$KEY/data.json" -K "$K" "$@" \
    || return 1
  evaluate_asm "$KEY/data.genome.fa" "$PRE.final.euler.fa"
}

run_n4() {  # U=10000 N=4 E=2000 P=2, C=10 L=10000
  local KEY=$1 H=${2:-0.01} H0=${3:-0.0002} p=0.0003 SEED=${4:-1}
  mkdir -p "$KEY"
  DBG sim-draft -k 40 -C 10 -L 10000 -p "$p" --fragment \
    --unit-size 10000 --n-unit 4 --end-length 2000 --div-hap "$H" \
    --div-init "$H0" -P 2 --read-seed "$SEED" -o "$KEY/data"
  run_hifiasm "$KEY"
  run_lja "$KEY"
  run_verkko "$KEY"
  run_dbgphmm "$KEY" "$p"
}

run_kir() {  # KIR-class scale: 8 x 20 kb tandem units + 2 kb unique ends,
  # diploid 1% divergence, C=15, p=0.0003, K_MAX=20,000
  local KEY=$1 H=${2:-0.01} H0=${3:-0.0002} p=0.0003 K=${4:-20000}
  mkdir -p "$KEY"
  DBG sim-draft -k 40 -C 15 -L 10000 -p "$p" --fragment \
    --unit-size 20000 --n-unit 8 --end-length 2000 --div-hap "$H" \
    --div-init "$H0" -P 2 --read-seed 1 -o "$KEY/data"
  run_dbgphmm "$KEY" "$p" "$K"
}

run_n10() {  # U=2000 N=10
  local KEY=$1 H=${2:-0.01} H0=${3:-0.0002} p=0.0003
  mkdir -p "$KEY"
  DBG sim-draft -k 40 -C 10 -L 10000 -p "$p" --fragment \
    --unit-size 2000 --n-unit 10 --end-length 2000 --div-hap "$H" \
    --div-init "$H0" -P 2 -o "$KEY/data"
  run_hifiasm "$KEY"; run_lja "$KEY"; run_verkko "$KEY"
  run_dbgphmm "$KEY" "$p"
}

run_all() {  # the n4 sweep
  local OUT=$1
  for H in 0.01 0.001 0.0001; do
    for H0 in 0.0002 0.0001; do
      run_n4 "$OUT/n4_p0.0003/H${H}_H0${H0}" "$H" "$H0"
    done
  done
}

"$@"
