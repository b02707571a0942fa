"""The port stands alone: nothing under ``src/repro_torch/`` and nothing
in ``chip_smoke.py`` imports JAX or the JAX package (``repro``), and the
package imports in a process that has neither loaded."""
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
# `import jax…`, `from jax… import`, `import repro…`, `from repro… import`
# (``repro_torch`` is the port itself), at any indentation
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|repro)(?:\.|\s|,|$)"
    r"|from\s+(?:jax|jaxlib|repro)(?:\.|\s))", re.M)


def _sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_forbidden_import_pattern():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import x",
                "    from repro.models import layers", "import repro",
                "from repro import core", "import jaxlib"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import repro_torch", "from repro_torch.kernels import ops",
               "# from repro.models import layers is the reference",
               "import torch", "import numpy as np"):
        assert not FORBIDDEN.search(ok), ok


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    files = _sources()
    assert len(files) > 20
    offenders = [f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
                 for path in files
                 for m in FORBIDDEN.finditer(path.read_text())]
    assert offenders == []


def test_port_imports_without_jax():
    """Importing every module of the port loads neither ``jax`` nor
    ``repro``."""
    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py")
        if p.name != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
