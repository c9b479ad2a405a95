"""No module of the benchmark imports JAX or the JAX package, and the
plain references import nothing of the program; top-level names compared
whole."""

import ast
from pathlib import Path

from benchmark import harness

HERE = Path(harness.HERE)


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = set(imported_tops(path)) & set(harness.FORBIDDEN_MODULES)
        assert not bad, (path, bad)


def test_references_import_nothing_of_the_program():
    files = sorted((HERE / "reference").glob("*.py"))
    assert {p.stem for p in files} >= {"tvl1", "masks"}
    for path in files:
        assert "tee_optical_flow_torch" not in set(imported_tops(path)), path
