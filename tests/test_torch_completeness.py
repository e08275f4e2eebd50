"""The port's closing gate: every module of the JAX package
(acceleratedvolrenderer_tpu/) has a port file at the same path in
acceleratedvolrenderer_tpu_torch/, and every public top-level name the
reference defines there (a function, a class, or an assigned name not
starting with "_") is defined in its port file too.

Both trees are parsed with `ast`; neither is imported.  The only
exceptions: the two Pallas modules, whose counterparts are named after
what they compute (ops/pallas_march.py -> ops/march.py,
ops/pallas_gather.py -> ops/gather.py), and the JAX-named majorant build
(build_majorant_grid_jax -> build_majorant_grid_torch).  Names a module
only imports are not counted: they are the module's dependencies, not its
interface.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "acceleratedvolrenderer_tpu"
PORT = ROOT / "acceleratedvolrenderer_tpu_torch"
MODULE_MAP = {"ops/pallas_march.py": "ops/march.py",
              "ops/pallas_gather.py": "ops/gather.py"}
NAME_MAP = {("ops/grid.py", "build_majorant_grid_jax"):
            "build_majorant_grid_torch"}
REF_MODULES = sorted(p.relative_to(REF).as_posix() for p in REF.rglob("*.py"))


def public_names(path: Path):
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                names |= {e.id for e in elts if isinstance(e, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_reference_tree_found():
    assert len(REF_MODULES) > 50
    assert "parallel/mesh.py" in REF_MODULES


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_ported(rel):
    """The port file exists and defines every public name."""
    port = PORT / MODULE_MAP.get(rel, rel)
    assert port.is_file(), f"no port of {rel} at {port.relative_to(ROOT)}"
    have = public_names(port)
    missing = sorted(NAME_MAP.get((rel, n), n) for n in public_names(REF / rel)
                     if NAME_MAP.get((rel, n), n) not in have)
    assert not missing, f"{rel}: the port lacks {missing}"
