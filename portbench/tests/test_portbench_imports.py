"""Nothing under portbench/ imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "jsdr_tpu"}


def top_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "jsdr_tpu_torch" not in top_imports(path)
    assert not {"portbench"} & top_imports(path)


def test_a_run_loads_no_jax():
    code = ("import sys; import portbench.run, portbench.harness, "
            "portbench.checklib; from portbench.cells import load_cell, "
            "stage_check, metric_reader\n"
            "import json\n"
            "b = json.load(open('BENCHMARK.json'))\n"
            "[metric_reader(m['name']) for m in b['per_layer']]\n"
            "[stage_check(s['class']) for w in b['workloads'] for s in "
            "load_cell(w['name']).config['stages']]\n"
            "from portbench.harness import build_stages\n"
            "[build_stages(load_cell(w['name']).config, 'cpu') for w in "
            "b['workloads']]\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
