"""What the harness may import: nothing of JAX or of the JAX package
(top-level names compared whole: the port, avrecode_tpu_torch, is the
program and allowed), and the reference nothing of the program either."""
import ast
import os
import sys

import pytest

import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "avrecode_tpu"}


def _modules(sub: str = "") -> list[str]:
    out = []
    for root, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__", ".cache")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", _modules(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not (_top_level_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", _modules("reference"), ids=lambda p: os.path.relpath(p, BENCH))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "avrecode_tpu_torch" not in _top_level_imports(path)
    with open(path) as f:
        assert "avrecode_tpu" not in f.read()


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "avrecode_tpu_torch_fake_probe", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "avrecode_tpu.device", sys)
    assert run.forbidden_modules() == ["avrecode_tpu"]
