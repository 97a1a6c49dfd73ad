"""What the benchmark may import: never JAX or the JAX package (top-level
names compared whole), and the reference nothing of the port."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "ml_music_style_transfer_tpu"}
PORT = "ml_music_style_transfer_tpu_torch"


def sources(sub=""):
    out = []
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        out += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(out)


def imported(path):
    """(top-level name, level) of every import in ``path``."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = {name for name, level in imported(path) if level == 0}
    assert not names & FORBIDDEN, f"{path} imports {names & FORBIDDEN}"


def test_the_port_name_is_not_taken_for_the_jax_package():
    # compared whole: the port's name begins with the JAX package's
    assert PORT.split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"), ids=os.path.basename)
def test_reference_imports_nothing_of_the_port_or_the_harness(path):
    for name, level in imported(path):
        assert name != PORT, f"{path} imports the port"
        assert level <= 1, f"{path} reaches outside reference/"
        assert level == 1 or name != "benchmark", f"{path} imports the harness"
