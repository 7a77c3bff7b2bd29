"""The port's production harness on the CPU: the supervisor of
dbgphmm_tpu_torch/scripts/sim.sh restarting a killed run from its deepest
checkpoint, and the CLI's SIGUSR1 stack dump."""

import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
SIM = REPO / "dbgphmm_tpu_torch" / "scripts" / "sim.sh"
# the verify skill's toy drive: k=12 draft, exact at -K 40
TOY = ["sim-draft", "-k", "12", "--unit-size", "10", "--n-unit", "4",
       "--end-length", "30", "-C", "12", "-L", "200", "-o", "sim"]
INFER = ["sim-infer", "sim.json", "-K", "40", "-S", "10", "-I", "10",
         "--device", "cpu"]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                PYTHONUNBUFFERED="1", PYTHON=sys.executable)


@pytest.fixture
def toy(tmp_path):
    subprocess.run([sys.executable, "-m", "dbgphmm_tpu_torch", *TOY],
                   cwd=tmp_path, env=_env(), check=True, capture_output=True,
                   timeout=120)
    return tmp_path


def _wait_for(cond, timeout, what):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < timeout, f"timed out waiting for {what}"
        time.sleep(0.05)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_supervisor_restarts_from_the_deepest_checkpoint(toy):
    """The first attempt is killed (SIGKILL) once it has dumped a k-stage;
    the supervisor restarts it from the deepest complete checkpoint (-d
    PRE.kN.dbg --map PRE.kN.map.mpz) and the second attempt assembles
    exactly."""
    pre = toy / "run" / "out"
    log = toy / "run" / "out.log"
    sup = subprocess.Popen(["bash", str(SIM), "supervise", str(pre), "sim.dbg",
                            *INFER], cwd=toy, env=_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, start_new_session=True)
    try:
        _wait_for(lambda: (toy / "run" / "out.k12.inspect").exists(), 120,
                  "the first checkpoint")
        pid = int(re.search(r"attempt=0 pid=(\d+)", log.read_text()).group(1))
        os.kill(pid, signal.SIGKILL)
        _wait_for(lambda: not _alive(pid), 30, "the killed run")
        deepest = max(int(p.name.split(".k")[1].split(".")[0])
                      for p in (toy / "run").glob("out.k*.inspect"))
        out, _ = sup.communicate(timeout=120)
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
    text = log.read_text()
    assert sup.returncode == 0, text[-3000:]
    assert "# supervise: rc=137 attempt=1 restarting" in out
    first, second = text.split("# supervise: attempt=1 ")
    assert second.startswith(f"pid=") and f"from=k{deepest}\n" in second
    assert "'dbg_input': 'sim.dbg'" in first and "exact=" not in first
    args = re.search(r"# args=(.*)", second).group(1)
    assert f"'dbg_input': '{pre}.k{deepest}.dbg'" in args
    assert f"'map_input': '{pre}.k{deepest}.map.mpz'" in args
    assert "# assembled=2 truth=2 exact=True" in second


def test_sigusr1_dumps_the_stacks_and_the_run_goes_on(toy):
    """SIGUSR1 mid-run: faulthandler writes every thread's stack to
    stderr, and the command still finishes with an exact assembly."""
    proc = subprocess.Popen([sys.executable, "-m", "dbgphmm_tpu_torch", *INFER,
                             "-d", "sim.dbg", "-o", "out"], cwd=toy,
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().startswith("# started_at=")
        proc.send_signal(signal.SIGUSR1)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert "Current thread" in err and 'File "' in err, err[-3000:]
    assert "# assembled=2 truth=2 exact=True" in out


FAKE_RUN = """#!/bin/bash
# a run that logs once and then hangs; its stack dump (SIGUSR1) takes 2 s
echo "# fake started"
trap 'echo "# usr1 $(date +%s.%N)"; sleep 2; echo "# dump done $(date +%s.%N)"' USR1
trap 'echo "# term $(date +%s.%N)"; exit 143' TERM
while :; do sleep 0.2; done
"""


def test_supervisor_counts_stalls_apart_and_waits_for_the_dump(tmp_path):
    """A run whose log goes silent: the supervisor sends SIGUSR1, waits
    DBGPHMM_STALL_DUMP_S seconds (here 4, longer than the 2 s dump) before
    SIGTERM, and restarts it; the stall restarts are counted on their own
    (stall=1, stall=2) and not as crash restarts (every attempt is
    attempt=0).  The supervisor is stopped after its second stall."""
    fake = tmp_path / "fake_python"
    fake.write_text(FAKE_RUN)
    fake.chmod(0o755)
    pre = tmp_path / "run" / "out"
    log = tmp_path / "run" / "out.log"
    env = dict(_env(), PYTHON=str(fake), DBGPHMM_STALL_S="1",
               DBGPHMM_STALL_DUMP_S="4")
    proc = subprocess.Popen(["bash", str(SIM), "supervise", str(pre),
                             "sim.dbg", "sim-infer"], cwd=tmp_path, env=env,
                            text=True, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, start_new_session=True)
    try:
        _wait_for(lambda: log.exists() and "stall=2 restarting" in
                  log.read_text(), 90, "the second stall restart")
    finally:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate(timeout=30)
    text = log.read_text()
    assert "# supervise: rc=143 stall=1 restarting" in out, text
    assert "# supervise: rc=143 stall=2 restarting" in out, text
    assert "giving up" not in text
    starts = re.findall(r"# supervise: attempt=(\d+) pid=\d+ from=draft", text)
    assert len(starts) >= 2 and set(starts) == {"0"}, text
    assert "attempt=1" not in text
    runs = text.split("# supervise: rc=143 stall=2")[0].split("# fake started")
    assert len(runs) == 3, text
    for run in runs[1:]:
        usr1 = float(re.search(r"# usr1 ([\d.]+)", run).group(1))
        done = float(re.search(r"# dump done ([\d.]+)", run).group(1))
        term = float(re.search(r"# term ([\d.]+)", run).group(1))
        assert usr1 < done < term and term - usr1 >= 3.5, run
