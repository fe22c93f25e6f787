"""The benchmark's import boundary, by whole top-level module names.

Nothing under ``kvsimbench/`` imports JAX or the JAX package ``repro``, or
the older ``benchmarks`` folder; the plain reference under
``kvsimbench/reference/`` imports nothing of the program (``repro_torch``)
either, nor anything of the benchmark outside itself.  A prefix test would
be wrong: ``repro_torch`` begins with ``repro``.
"""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
REFERENCE = HERE / "reference"


def modules():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def imported(source: str):
    """``(top-level name, relative level)`` of every import in ``source``."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def test_walks_every_module():
    names = {p.relative_to(HERE).as_posix() for p in modules()}
    assert {"run.py", "check.py", "reference/scheduler.py",
            "metrics/sched_roofline_pct.py"} <= names


@pytest.mark.parametrize("path", modules(), ids=lambda p: p.relative_to(
    HERE).as_posix())
def test_no_forbidden_import(path):
    tops = {name for name, level in imported(path.read_text()) if level == 0}
    assert not tops & FORBIDDEN, f"{path} imports {tops & FORBIDDEN}"
    if REFERENCE in path.parents:
        assert "repro_torch" not in tops, f"{path} imports the program"
        assert "kvsimbench" not in tops
        depth = len(path.relative_to(REFERENCE).parts)   # 1: reference/x.py
        for name, level in imported(path.read_text()):
            assert level <= depth, (
                f"{path} imports from outside reference/ ({'.' * level}"
                f"{name})")


def test_whole_name_comparison():
    """``repro_torch`` passes where ``repro`` does not."""
    ok = {n for n, _ in imported("import repro_torch.core\n"
                                 "from repro_torch import zoo\n")}
    bad = {n for n, _ in imported("import repro.core\nfrom jax import numpy")}
    assert ok == {"repro_torch"} and not ok & FORBIDDEN
    assert bad & FORBIDDEN == {"repro", "jax"}


@pytest.mark.parametrize("path", sorted(
    p for p in HERE.rglob("*") if p.is_file() and p.suffix in
    (".py", ".json", ".md")), ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_fixed_scratch_path(path):
    if path.name == Path(__file__).name:
        return
    text = path.read_text()
    assert "/tmp/" not in text and "/dev/shm" not in text, path
