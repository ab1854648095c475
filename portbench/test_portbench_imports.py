"""No module of the benchmark imports JAX or the JAX package, and the plain
references and the scene generators import nothing of the program either
(top-level names compared whole: the program's name begins with the JAX
package's)."""

import ast
import os

import pytest

from portbench.conftest import HERE

NEVER = {"jax", "jaxlib", "flax", "platinum_tpu", "bench", "chip_smoke",
         "tools", "tests"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    seen = set()
    for path in _sources():
        tops = set(_imports(path))
        assert not tops & NEVER, (path, tops & NEVER)
        seen |= tops
    assert "platinum_tpu_torch" in seen      # the harness does drive the port


def _importing_the_program(paths):
    """The files among `paths` that import the program, JAX or the JAX
    package."""
    return [p for p in paths
            if set(_imports(p)) & (NEVER | {"platinum_tpu_torch"})]


def test_the_reference_imports_nothing_of_the_program():
    """Every reference module, every generator file (generators/ and the
    test cell's) and what they share: the yardstick."""
    paths = (list(_sources("reference")) + list(_sources("generators"))
             + list(_sources("testcell"))
             + [os.path.join(HERE, f) for f in ("compare.py", "scenes.py",
                                                "control.py")])
    assert any(p.endswith(os.path.join("generators", "studio.py"))
               for p in paths)
    assert _importing_the_program(paths) == []


@pytest.mark.parametrize("line", [
    "import platinum_tpu_torch.app.scenes",
    "from platinum_tpu_torch.core import primitives",
    "import numpy as np, jax",
])
def test_a_generator_importing_the_program_is_found(tmp_path, line):
    path = tmp_path / "scratch_generator.py"
    path.write_text(f"{line}\n\n\ndef make():\n    return {{}}\n")
    assert _importing_the_program([str(path)]) == [str(path)]


def test_the_check_compares_whole_top_level_names():
    from portbench.harness import FORBIDDEN
    import sys
    import types

    sys.modules["platinum_tpu_torch_lookalike"] = types.ModuleType("x")
    try:
        from portbench.harness import forbidden_modules
        assert "platinum_tpu_torch_lookalike" not in forbidden_modules()
        assert "platinum_tpu_torch" not in FORBIDDEN
    finally:
        del sys.modules["platinum_tpu_torch_lookalike"]
