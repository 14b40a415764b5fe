"""Nothing the benchmark loads is JAX or the JAX package, and the
reference loads nothing of the program.

Names are compared by their top-level part (before the first dot) as a
whole string: ``alignn_tpu_torch`` begins with ``alignn_tpu`` and is
allowed.
"""

import ast
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "alignn_tpu"}
PROGRAM = "alignn_tpu_torch"


def sources(sub: str = ""):
    top = os.path.join(BENCH, sub)
    for dirpath, _dirs, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_whole_name_comparison():
    assert "alignn_tpu_torch.ops".split(".")[0] not in FORBIDDEN
    assert "alignn_tpu.ops".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in top_level_imports(path)


PROBE = r"""
import sys
sys.path[:0] = [{bench!r}, {root!r}]
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""


def loaded_top_levels(body: str) -> set:
    code = PROBE.format(bench=BENCH, root=ROOT, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    tops = loaded_top_levels(
        "from reference import graph, model, md, train")
    assert PROGRAM not in tops
    assert not tops & FORBIDDEN


def test_harness_and_entries_load_no_jax():
    """Every module of the harness, the entries (which load the program),
    the traffic generators and the metric readers, imported in one fresh
    process."""
    tops = loaded_top_levels(
        "import run\n"
        "from harness import cell, flops, peaks, readers, spec, taps, "
        "trace, weights\n"
        "from entries import md, train\n"
        "from traffic import prototypes, si_supercell\n"
        "import alignn_tpu_torch.ff.md_jit, alignn_tpu_torch.train.trainer\n"
        "for m in spec.benchmark()['per_layer']:\n"
        "    spec.reader(m['name'])\n")
    assert PROGRAM in tops
    assert not tops & FORBIDDEN
