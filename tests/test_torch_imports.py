"""Guard: the port and chip_smoke.py import nothing of JAX or of the JAX
package, by source scan and by importing every module in a fresh
interpreter, which also builds and loads no kernel."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "e4t_diffusion_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "e4t_diffusion_tpu")


def _port_files():
    files = [os.path.join(root, f)
             for root, _, names in os.walk(PKG) for f in names
             if f.endswith(".py")]
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def _module_name(path):
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    bad = [m for m in _imported(tree)
           if str(m).split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = [_module_name(p) for p in _port_files()
               if p.startswith(PKG)]
    code = (
        "import sys, importlib\n"
        "before = set(sys.modules)\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        f"print(sorted(new & set({FORBIDDEN!r})))\n"
        "from e4t_diffusion_torch.ops import _build\n"
        "print(sorted(_build._loaded), 'triton' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # no JAX; and no kernel library built or loaded, nor triton imported,
    # until a wrapper first launches on a CUDA tensor
    assert proc.stdout.split("\n")[:2] == ["[]", "[] False"]
