"""The kernels' build cache (``ops/_build.py``): a library's name carries
the hash of its source, of every shared header and of the compiler flags,
so that a change to any of them rebuilds it. Needs no ``nvcc``: only the
names are computed."""

import shutil

import pytest

pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu_torch.ops import _build  # noqa: E402


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_sources_and_headers_exist():
    for src in _build.SOURCES.values():
        assert (_build.CSRC / src).is_file()
    assert {"hopper.cuh", "maxsim_hopper.cuh", "mma_sync.cuh"} <= {
        p.name for p in _build.CSRC.glob("*.cuh")}


def test_target_is_stable(csrc):
    for name in _build.SOURCES:
        assert _build._target(name) == _build._target(name)


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
@pytest.mark.parametrize("header", ["hopper.cuh", "maxsim_hopper.cuh", "mma_sync.cuh"])
def test_header_change_rebuilds_every_library(csrc, name, header):
    before = _build._target(name)
    with open(csrc / header, "a") as f:
        f.write("\n// changed\n")
    after = _build._target(name)
    assert after != before and after.parent == before.parent
    assert after.name.startswith(f"{name}-") and after.suffix == ".so"


def test_new_header_rebuilds(csrc):
    before = {n: _build._target(n) for n in _build.SOURCES}
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert all(_build._target(n) != t for n, t in before.items())


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_source_change_rebuilds_only_its_library(csrc, name):
    """A change to a source rebuilds the libraries built from it: its own,
    and for K2 those of its other head-width groups, and no other."""
    before = {n: _build._target(n) for n in _build.SOURCES}
    with open(csrc / _build.SOURCES[name], "a") as f:
        f.write("\n// changed\n")
    after = {n: _build._target(n) for n in _build.SOURCES}
    same_source = {n for n, src in _build.SOURCES.items() if src == _build.SOURCES[name]}
    assert name in same_source
    assert {n for n in _build.SOURCES if after[n] != before[n]} == same_source


def test_k2_groups_are_built_apart():
    """One source, one library a group of head widths: the groups' flags,
    and so their libraries, differ, and every width of 16 to 128 in steps of
    16 lies in exactly one group."""
    for src in _build.K2_SOURCES:
        names = [src + group for group in _build.K2_GROUPS]
        assert len({_build._target(n) for n in names}) == len(names)
        assert {_build.SOURCES[n] for n in names} == {f"{src}.cu"}
    widths = [hd for first, last in _build.K2_GROUPS.values() for hd in range(first, last + 1, 16)]
    assert sorted(widths) == list(range(16, 129, 16))
