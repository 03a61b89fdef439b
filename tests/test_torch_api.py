"""The port's library boundary: every name each JAX package ``__init__``
exports (the package, ``ops``, ``utils``, ``models``, ``data``,
``parallel``) is exported by the port's counterpart, the same object as in
the port module that defines it; ``import imbalanced_regression_tpu_torch``
with jax blocked succeeds, imports no submodule and builds no kernel; and
the modules this slice adds import neither jax, flax, optax, nbformat,
nbclient nor the JAX package."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PACKAGES = ["", ".ops", ".utils", ".models", ".data", ".parallel"]
# JAX-only names: both return a jax.sharding.NamedSharding, which
# torch.distributed has no counterpart of; shard_batch and replicate do
# their work in the port
NOT_EXPORTED = {".parallel": {"batch_sharding", "replicated"}}


def _jax_names(module) -> set[str]:
    """The public names a JAX ``__init__`` defines or imports, without the
    submodules that importing it binds."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not isinstance(v, type(sys))}


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "package")
def test_port_exports_every_jax_name(sub):
    names = _jax_names(importlib.import_module(f"imbalanced_regression_tpu{sub}"))
    port_pkg = importlib.import_module(f"imbalanced_regression_tpu_torch{sub}")
    missing = NOT_EXPORTED.get(sub, set())
    assert missing <= names, "an excepted name is no longer exported by JAX"
    for name in sorted(names - missing):
        obj = getattr(port_pkg, name)  # the package level resolves lazily
        # the object its defining port module holds, not a look-alike
        home = importlib.import_module(obj.__module__)
        assert home.__name__.startswith("imbalanced_regression_tpu_torch."), (name, home)
        assert getattr(home, name) is obj, name
    for name in missing:
        assert not hasattr(port_pkg, name)


def test_package_all_lists_the_jax_names():
    import imbalanced_regression_tpu
    import imbalanced_regression_tpu_torch as irt

    assert set(irt.__all__) == _jax_names(imbalanced_regression_tpu)
    assert set(irt.__all__) <= set(dir(irt))
    with pytest.raises(AttributeError, match="no attribute 'fds_nothing'"):
        irt.fds_nothing  # noqa: B018
    assert irt.ops.prepare_weights_age is irt.ops.lds.prepare_weights_age  # a submodule


BLOCKED = ("jax", "flax", "optax", "nbformat", "nbclient", "imbalanced_regression_tpu")
BARE_IMPORT = """
import sys
for name in {blocked!r}:
    sys.modules[name] = None  # any import of it raises ImportError
import imbalanced_regression_tpu_torch as irt
bare = sorted(m for m in sys.modules if m.startswith("imbalanced_regression_tpu_torch"))
heavy = sorted(m for m in ("torch", "scipy") if m in sys.modules)
from imbalanced_regression_tpu_torch import fds_smooth, FDSConfig, weighted_l1_loss
from imbalanced_regression_tpu_torch.ops import cuda_kernels as ck
after = sorted(m for m in sys.modules if m.startswith("imbalanced_regression_tpu_torch"))
print(bare, heavy, ck.load_library.cache_info().currsize, irt.fds_smooth is fds_smooth,
      [m for m in after if m.split(".")[1:2] in (["tasks"], ["serving"], ["entry"])])
"""


def test_bare_import_with_jax_blocked_builds_nothing():
    """With jax and the JAX package blocked, the bare import loads no
    submodule, not even torch; reaching the FDS names loads ``fds`` and
    ``ops`` but neither a driver, serving nor the entry, and builds no
    kernel."""
    out = subprocess.run([sys.executable, "-c", BARE_IMPORT.format(blocked=BLOCKED)],
                         capture_output=True, text=True, cwd="/", timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[0] == "['imbalanced_regression_tpu_torch'] [] 0 True []"


NEW_MODULES = ("entry", "utils.logging_tools", "tools.make_notebook", "tutorial",
               "tutorial.tutorial", "convert")
IMPORT_BLOCKED = """
import importlib, sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.argv[1:] = ["--device", "cpu"]  # the tutorial script runs on import
for module in {modules!r}:
    importlib.import_module("imbalanced_regression_tpu_torch." + module)
print(sorted(m for m, mod in sys.modules.items() if m.split(".")[0] in {blocked!r}
             and mod is not None))
"""


def test_new_modules_import_no_jax_or_notebook_packages():
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_BLOCKED.format(blocked=BLOCKED, modules=NEW_MODULES)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_import_statement_of_the_slice_names_jax():
    """Every import statement of the new modules and of ``chip_smoke.py``,
    those inside functions too, names none of the blocked packages."""
    files = [REPO / "chip_smoke.py"] + [
        REPO / "imbalanced_regression_tpu_torch" / (m.replace(".", "/") + ".py")
        for m in NEW_MODULES if m != "tutorial"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in BLOCKED], (path.name, names)
