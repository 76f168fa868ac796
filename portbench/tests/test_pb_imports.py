"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program. Top-level module names are compared whole:
``video_annotator_tpu_torch`` is the program, ``video_annotator_tpu`` the
JAX package."""

import ast
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "video_annotator_tpu"}
SOURCES = sorted(p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = ("reference", "camera", "trajfile", "k1_bound")


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_source_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_sources_import_nothing_of_the_program(name):
    names = top_level_imports(harness.HERE / f"{name}.py")
    assert names <= {"__future__", "dataclasses", "math", "numpy", "torch", "portbench",
                     "fractions"}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
                          "sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=harness.ROOT, check=True)
    return set(out.stdout.split())


def test_what_a_run_loads_holds_no_jax():
    names = loaded_after(
        "import sys; sys.path.insert(0, 'portbench')\n"
        "import run\n"
        "from portbench import harness, readings\n"
        "bench = harness.load_json('BENCHMARK.json')\n"
        "for m in bench['end_to_end'] + bench['per_layer']: harness.reader(m['name'])\n"
        "from video_annotator_tpu_torch.pipeline.render import render\n"
        "from video_annotator_tpu_torch.pipeline import streaming\n"
        "harness.span_profiler(); harness.render_options(['a.y4m', 'b.y4m'])\n")
    assert "video_annotator_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded_after("from portbench import reference, camera, trajfile, k1_bound, generator")
    assert not names & (FORBIDDEN | {"video_annotator_tpu_torch"})
