"""chip_smoke.py and the port stand alone: no line of them names JAX or
the JAX package, and both import with the JAX package and JAX made
unimportable, leaving neither in sys.modules."""

import ast
import glob
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SIDE = ("jax", "jaxlib", "video_llava_tpu")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


def test_smoke_and_port_import_nothing_of_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")] + glob.glob(
        os.path.join(REPO, "video_llava_tpu_torch", "**", "*.py"),
        recursive=True)
    assert len(files) > 20
    for path in files:
        assert [n for n in _imports(path)
                if n.split(".")[0] in JAX_SIDE] == [], path
    modules = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__") for p in files)
    code = ("import importlib, sys\n"
            f"for m in {JAX_SIDE!r}: sys.modules[m] = None\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"left = [m for m in sys.modules if m.split('.')[0] in "
            f"{JAX_SIDE!r} and sys.modules[m] is not None]\n"
            "assert not left, left\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
