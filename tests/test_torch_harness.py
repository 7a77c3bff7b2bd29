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
