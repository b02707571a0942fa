"""The benchmark's own tests.  They are not in the repository's test
run; run them with ``python -m pytest portbench/tests``.  Tests marked
``cuda`` need the card and skip without one (decided in the fixture)."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_programs():
    """Each test starts from an empty tick-program cache."""
    from repro_torch.obs.prof import reset_fleet_programs
    reset_fleet_programs()
    yield
    reset_fleet_programs()
