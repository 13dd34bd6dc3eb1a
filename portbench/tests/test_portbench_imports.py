"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the references load nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench_tiny import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_rt"}
REFERENCES = sorted(glob.glob(os.path.join(BENCH_DIR, "reference", "*.py"))) + [
    os.path.join(BENCH_DIR, "plainmath.py")]


def _loaded_after(code):
    """The top-level names in sys.modules after ``code`` runs in a fresh
    interpreter with the harness on the path."""
    pre = (f"import sys; sys.path[:0] = [{ROOT!r}, {BENCH_DIR!r}]\n")
    post = "\nprint(sorted({m.split('.')[0] for m in sys.modules}))"
    p = subprocess.run([sys.executable, "-c", pre + code + post], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr
    return set(ast.literal_eval(p.stdout.strip().splitlines()[-1]))


def test_harness_and_readers_load_no_jax():
    code = ("import harness, devtrace, yardstick, run, control, convergence\n"
            "b = harness.load_bench()\n"
            "[harness.driver(harness.find_cell(b, w['name'])[2]['kind'])\n"
            " for w in b['workloads']]\n"
            "[harness.metric_reader(m['name']) for m in b['per_layer']]\n")
    assert not _loaded_after(code) & FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU run of each cell at a tiny size, the port included."""
    code = (f"import types, portbench_tiny\n"
            f"bd, root = portbench_tiny.make_tiny({str(tmp_path)!r})\n"
            "import harness, io\n"
            "for w in harness.load_bench(root)['workloads']:\n"
            "    a = types.SimpleNamespace(workload=w['name'], seed=3, seconds=0.1, trace=0)\n"
            "    assert harness.run(a, 'cpu', 0.0, out=io.StringIO(), err=io.StringIO(),\n"
            "                       bench_dir=bd, root=root)['correct']\n"
            "assert not harness.forbidden_modules()\n")
    sys_path = os.path.join(BENCH_DIR, "tests")
    loaded = _loaded_after(f"import sys; sys.path.insert(0, {sys_path!r})\n" + code)
    assert "tpu_rt_torch" in loaded
    assert not loaded & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCES, ids=os.path.basename)
def test_reference_loads_nothing_of_the_port(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "os", "xml", "numpy", "torch",
                     "plainmath"}, names
    loaded = _loaded_after(f"import harness; harness.load_module({path!r}, 'ref')")
    assert not loaded & (FORBIDDEN | {"tpu_rt_torch"})
