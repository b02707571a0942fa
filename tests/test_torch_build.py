"""The port's kernel build key (``repro_torch.kernels._build``).

A kernel's library is keyed by a hash of its ``.cu`` source, every shared
header beside it (``csrc/*.cuh``) and the ``nvcc`` flags, so an edit to a
header that a source includes builds that source anew.  These tests only
compute keys: no ``nvcc`` runs.
"""
import pathlib
import shutil
import tomllib

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

TC_SOURCES = ("flash_attention", "moe_gemm")
HEADER = "tc_bf16.cuh"


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A source directory of one ``k.cu`` that includes ``k.cuh``."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\nint k() { return K; }\n')
    (tmp_path / "k.cuh").write_text("#define K 1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    return tmp_path


def test_key_is_stable(csrc):
    assert _build._target("k") == _build._target("k")
    src, so = _build._target("k")
    assert src == csrc / "k.cu" and so.parent == _build.BUILD_DIR
    assert so.name.startswith("k-") and so.suffix == ".so"


def test_header_edit_changes_the_library(csrc):
    before = _build._target("k")[1]
    (csrc / "k.cuh").write_text("#define K 2\n")
    after = _build._target("k")[1]
    assert after != before
    (csrc / "k.cuh").write_text("#define K 1\n")
    assert _build._target("k")[1] == before


def test_source_edit_changes_the_library(csrc):
    before = _build._target("k")[1]
    (csrc / "k.cu").write_text('#include "k.cuh"\nint k() { return -K; }\n')
    assert _build._target("k")[1] != before


def test_new_or_renamed_header_changes_the_library(csrc):
    before = _build._target("k")[1]
    (csrc / "other.cuh").write_text("#define J 1\n")
    added = _build._target("k")[1]
    assert added != before
    (csrc / "other.cuh").rename(csrc / "third.cuh")
    assert _build._target("k")[1] not in (before, added)


def test_other_files_do_not_change_the_library(csrc):
    before = _build._target("k")[1]
    (csrc / "notes.txt").write_text("not a header\n")
    (csrc / "j.cu").write_text("int j() { return 0; }\n")
    assert _build._target("k")[1] == before


@pytest.mark.parametrize("name", TC_SOURCES)
def test_tensor_core_sources_rebuild_on_their_header(tmp_path, monkeypatch,
                                                     name):
    """Both tensor-core sources include ``tc_bf16.cuh``; an edit to it
    changes both libraries' keys."""
    for f in (f"{name}.cu", HEADER):
        shutil.copy(_build.CSRC / f, tmp_path / f)
    assert f'#include "{HEADER}"' in (tmp_path / f"{name}.cu").read_text()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target(name)[1]
    with open(tmp_path / HEADER, "a") as fh:
        fh.write("// edited\n")
    assert _build._target(name)[1] != before


def test_headers_ship_with_the_package():
    root = pathlib.Path(__file__).resolve().parents[1]
    data = tomllib.loads((root / "pyproject.toml").read_text())
    globs = data["tool"]["setuptools"]["package-data"]["repro_torch"]
    assert "kernels/csrc/*.cu" in globs and "kernels/csrc/*.cuh" in globs
    assert (_build.CSRC / HEADER).is_file()
