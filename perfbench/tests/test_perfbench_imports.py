"""Nothing the benchmark runs loads JAX or the JAX package (compared by
whole top-level names), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from perfbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "dbgphmm_tpu"}


def test_run_imports_no_jax():
    code = ("import sys; import perfbench.run, perfbench.control, "
            "perfbench.checks, perfbench.program, perfbench.trace; "
            "import dbgphmm_tpu_torch.multi_dbg.posterior, "
            "dbgphmm_tpu_torch.multi_dbg.output; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.REPO,
                         capture_output=True, text=True, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "dbgphmm_tpu_torch" in tops and not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "dataclasses", "typing", "numpy",
               "torch", "scipy"}
    for path in (run.ROOT / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # inside the reference package
                    continue
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
