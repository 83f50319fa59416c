"""Nothing of the harness imports JAX or the JAX package ``repro``, by
whole top-level module name (the port, ``repro_torch``, begins with
``repro``), and the yardstick imports nothing of the port."""
import _setup  # noqa: F401
import ast

import pytest

from portbench import harness

PB = _setup.ROOT / "portbench"
FILES = sorted(p for p in PB.rglob("*.py"))
#: the yardstick: what decides ``correct`` and what the metrics are
#: measured against, which must not lean on the program
YARDSTICK = ["reference.py", "work.py", "graphs.py", "devtrace.py",
             "readers.py", "generators/rmat.py", "generators/urand.py"]


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(PB))
                                             for p in FILES])
def test_no_jax_and_no_jax_package(path):
    assert not set(top_level_imports(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(name):
    assert "repro_torch" not in set(top_level_imports(PB / name))


def test_forbidden_modules_compares_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.api": 1, "reprox": 1,
            "repro": 1, "repro.core.bfs": 1, "jax": 1, "jaxlib.xla": 1,
            "flax": 1, "jaxtyping": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == [
        "flax", "jax", "jaxlib.xla", "repro", "repro.core.bfs"]


def test_the_count_path_loads_no_jax():
    """A fresh process that runs the port's count as the harness does
    holds no forbidden module afterwards."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "from repro_torch.api import TCOptions, TriangleEngine\n"
        "from repro_torch.graph import generators as gen\n"
        "TriangleEngine(device='cpu').count(gen.karate(), route='local',"
        " options=TCOptions(per_vertex=True))\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(_setup.ROOT), str(_setup.ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
