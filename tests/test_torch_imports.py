"""Guard: the port and chip_smoke.py import nothing of JAX or of the JAX
package, by source scan and by importing every module in a fresh
interpreter, which also builds and loads no kernel; and no module of the
package imports or loads chip_smoke.py (its shared helpers live in
``e4t_diffusion_torch/timing.py`` and ``seeded.py``)."""
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


def _reads_chip_smoke(tree):
    """Imports of ``chip_smoke`` and calls with a ``chip_smoke`` string
    among their arguments (a load by path, ``import_module``, a copy)."""
    for node in ast.walk(tree):
        if any(name.split(".")[0] == "chip_smoke"
               for name in _imported(ast.Module([node], []))
               if isinstance(node, (ast.Import, ast.ImportFrom))):
            yield node.lineno
        elif isinstance(node, ast.Call) and any(
                isinstance(c, ast.Constant) and isinstance(c.value, str)
                and "chip_smoke" in c.value
                for arg in [*node.args, *(k.value for k in node.keywords)]
                for c in ast.walk(arg)):
            yield node.lineno


@pytest.mark.parametrize("path", [p for p in _port_files()
                                  if p.startswith(PKG)],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_package_reads_no_chip_smoke(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    lines = list(_reads_chip_smoke(tree))
    assert not lines, f"{path} reads chip_smoke.py at lines {lines}"


def test_the_chip_smoke_scan_sees_a_load_by_path():
    """The scan above finds each way the timers used to read it."""
    for src in ('spec = importlib.util.spec_from_file_location(\n'
                '    "chip_smoke", os.path.join(HERE, "chip_smoke.py"))',
                "from chip_smoke import _bound",
                "import chip_smoke as smoke",
                'shutil.copy(os.path.join(repo, "chip_smoke.py"), root)'):
        assert list(_reads_chip_smoke(ast.parse(src))), src
    assert not list(_reads_chip_smoke(ast.parse(
        '"""chip_smoke.py holds the kernel against it."""')))


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


def test_timing_imports_nothing_of_the_package():
    """The timers load ``timing.py`` by path beside the package of the
    checkout they time, which may be one without ``utils/flops.py``: at
    import it takes nothing from the package, and its peaks are
    ``utils/flops.py``'s."""
    from e4t_diffusion_torch import timing
    from e4t_diffusion_torch.utils import flops

    path = os.path.join(PKG, "timing.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    top = [m for node in tree.body
           if isinstance(node, (ast.Import, ast.ImportFrom))
           for m in _imported(ast.Module([node], []))]
    assert not [m for m in top if m.split(".")[0] in
                ("e4t_diffusion_torch", "torch")], top
    assert (timing.BF16_FLOP_PER_S, timing.INT8_OP_PER_S,
            timing.F32_FLOP_PER_S) == (flops.H100_BF16_PEAK,
                                       flops.H100_INT8_PEAK,
                                       flops.H100_F32_PEAK)
