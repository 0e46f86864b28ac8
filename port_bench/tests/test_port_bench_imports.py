"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level name: the port's package name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "video_similarity_search_tpu"}
PROGRAM = "video_similarity_search_tpu_torch"


def modules():
    for d, _, files in os.walk(HERE):
        rel = os.path.relpath(d, HERE)
        if rel != "." and any(part.startswith(".") or part == "store"
                              for part in rel.split(os.sep)):
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), HERE)


def imported(path: str) -> set:
    with open(os.path.join(HERE, path)) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_scan_sees_the_modules():
    found = list(modules())
    assert "run.py" in found and os.path.join("reference", "models.py") \
        in found


@pytest.mark.parametrize("path", list(modules()))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN, path


@pytest.mark.parametrize("path", [p for p in modules()
                                  if p.startswith("reference" + os.sep)])
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported(path), path


def test_top_level_names_compared_whole():
    """The port's name begins with the JAX package's; a prefix test would
    refuse it."""
    assert PROGRAM.split(".")[0] not in FORBIDDEN
    assert PROGRAM.startswith("video_similarity_search_tpu")
