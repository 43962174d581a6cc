"""Every name a JAX subpackage's ``__init__`` exports resolves in the
port's twin package, or is listed with the port's twin of it; importing
the port's packages builds no CUDA kernel (the kernels load lazily)."""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGES = ("core", "locate", "ops", "realtime", "parallel", "detect",
            "data", "models", "utils")
#: JAX names whose port twin has another name
TWINS = {
    ("models", "fcnn_variables_from_state_dict"):
        "fcnn_state_dict_from_reference",
}


def _jax_exports(pkg):
    tree = ast.parse((REPO / "onset_fingerprinting_tpu" / pkg /
                      "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            for a in node.names:
                yield a.asname or a.name


@pytest.mark.parametrize("pkg", PACKAGES)
def test_jax_package_names_resolve_in_the_port(pkg):
    port = importlib.import_module(f"onset_fingerprinting_torch.{pkg}")
    names = list(_jax_exports(pkg))
    assert names, pkg
    missing = [n for n in names
               if not hasattr(port, TWINS.get((pkg, n), n))]
    assert not missing, (pkg, missing)


def test_importing_the_packages_builds_nothing():
    code = (
        "import importlib\n"
        f"for p in {PACKAGES!r}:\n"
        "    importlib.import_module('onset_fingerprinting_torch.' + p)\n"
        "from onset_fingerprinting_torch.ops import _cuda\n"
        "assert all(k._lib is None for k in _cuda.KERNELS)\n"
        "import sys\n"
        "assert 'jax' not in sys.modules\n"
        "print('LAZY')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LAZY" in out.stdout


def test_utils_imports_without_matplotlib():
    """The card's machine has no matplotlib: ``utils`` and its metrics
    import without it, and only ``utils.plots`` needs it."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import onset_fingerprinting_torch.utils as u\n"
        "from onset_fingerprinting_torch.utils.metrics import Metrics\n"
        "from onset_fingerprinting_torch.tools import choose_od_settings\n"
        "from onset_fingerprinting_torch.tools import modify_hits_mc\n"
        "from onset_fingerprinting_torch.tools import realtime_sim\n"
        "assert u.wave_speed(351.0, 0.05) > 0 and Metrics().summary()\n"
        "try:\n"
        "    u.plots\n"
        "except ImportError:\n"
        "    print('LAZY')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LAZY" in out.stdout
