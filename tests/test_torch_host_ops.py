"""The port's host ops (``ops/host_ops.py`` over its own build of
``csrc/host_ops.cpp``) against the JAX package's ``ops/host_ops.py`` and
against their numpy reference versions: results equal to the JAX
function's (the same C++ code), equal to the references' but for the MaxSim
totals, which numpy sums pairwise and the library in order (rtol 1e-6, as
the JAX package's own test), top-k order on tied scores
equal to the JAX function's, the empty cases, and a failed ``g++`` build
that raises instead of falling back to numpy."""

import numpy as np
import pytest

pytest.importorskip("torch")

from reranking_multimodal_retrievers_tpu.ops import host_ops as jhost  # noqa: E402
from reranking_multimodal_retrievers_tpu_torch.ops import host_ops  # noqa: E402

TIES = [
    np.ones(7, np.float32),
    np.array([1, 1, 2], np.float32),
    np.array([3, 1, 3, 2, 3, 1, 2, 3], np.float32),
    np.repeat(np.arange(5, dtype=np.float32), 4)[::-1].copy(),
    np.round(np.random.default_rng(7).normal(size=300), 1).astype(np.float32),
]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 20, 1000])
@pytest.mark.parametrize("case", range(len(TIES)))
def test_top_k_on_ties_is_the_jax_order(case, k):
    assert jhost.native_available()
    scores = TIES[case]
    got = host_ops.top_k_host(scores, k)
    np.testing.assert_array_equal(got, jhost.top_k_host(scores, k))
    # the same scores as the stable sort's, in another order among ties
    ref = host_ops.top_k_reference(scores, k)
    np.testing.assert_array_equal(np.sort(scores[got]), np.sort(scores[ref]))


def test_top_k_tie_order_differs_from_the_reference():
    """The heap lists equal scores from the highest index down; the stable
    sort from the lowest (the module's docstring)."""
    scores = np.ones(4, np.float32)
    np.testing.assert_array_equal(host_ops.top_k_host(scores, 4), [3, 2, 1, 0])
    np.testing.assert_array_equal(host_ops.top_k_reference(scores, 4), [0, 1, 2, 3])


@pytest.mark.parametrize("seed", [0, 1])
def test_native_equals_reference_and_jax(seed):
    rng = np.random.default_rng(seed)
    doclens = rng.integers(0, 9, size=40).astype(np.int32)
    doclens[[0, 17]] = 0
    scores = rng.normal(size=(int(doclens.sum()), 13)).astype(np.float32)
    got = host_ops.segmented_maxsim_host(scores, doclens)
    np.testing.assert_allclose(got, host_ops.segmented_maxsim_reference(scores, doclens),
                               rtol=1e-6)
    np.testing.assert_array_equal(got, jhost.segmented_maxsim_host(scores, doclens))

    src = rng.normal(size=(50, 6)).astype(np.float32)
    offsets = rng.integers(0, 40, size=12).astype(np.int64)
    lengths = rng.integers(0, 11, size=12).astype(np.int32)
    got = host_ops.segmented_lookup_host(src, offsets, lengths)
    np.testing.assert_array_equal(got, host_ops.segmented_lookup_reference(src, offsets, lengths))
    np.testing.assert_array_equal(got, jhost.segmented_lookup_host(src, offsets, lengths))

    s = rng.normal(size=1000).astype(np.float32)
    np.testing.assert_array_equal(host_ops.top_k_host(s, 37), host_ops.top_k_reference(s, 37))

    bits = (rng.random(83) > 0.5).astype(np.uint8)
    packed = host_ops.pack_bits_host(bits)
    np.testing.assert_array_equal(packed, host_ops.pack_bits_reference(bits))
    np.testing.assert_array_equal(packed, jhost.pack_bits_host(bits))
    np.testing.assert_array_equal(host_ops.unpack_bits_host(packed, 83), bits)
    np.testing.assert_array_equal(host_ops.unpack_bits_reference(packed, 83), bits)


def test_empty_and_invalid_inputs():
    assert host_ops.segmented_maxsim_host(np.zeros((0, 7), np.float32),
                                          np.zeros(0, np.int32)).shape == (0,)
    assert host_ops.segmented_lookup_host(np.zeros((3, 4), np.float32), np.zeros(0, np.int64),
                                          np.zeros(0, np.int32)).shape == (0, 4)
    assert host_ops.top_k_host(np.zeros(0, np.float32), 5).shape == (0,)
    assert host_ops.top_k_host(np.ones(3, np.float32), 0).shape == (0,)
    with pytest.raises(ValueError):  # more rows asked than the scores hold
        host_ops.segmented_maxsim_host(np.zeros((3, 2), np.float32), np.array([2, 2], np.int32))
    with pytest.raises(ValueError):  # a segment past the end of src
        host_ops.segmented_lookup_host(np.zeros((3, 2), np.float32), np.array([2], np.int64),
                                       np.array([2], np.int32))
    with pytest.raises(ValueError):
        host_ops.unpack_bits_host(np.zeros(1, np.uint8), 9)


def test_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text(host_ops.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(host_ops, "SOURCE", bad)
    monkeypatch.setattr(host_ops, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(host_ops, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        host_ops.top_k_host(np.ones(3, np.float32), 2)
    assert not host_ops.native_available()
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="not found"):
        host_ops.pack_bits_host(np.ones(3, np.uint8))


def test_library_name_keys_the_source_and_the_host(monkeypatch):
    here = host_ops.library_path()
    assert here.parent == host_ops.BUILD_DIR and here.name.startswith("host_ops-")
    monkeypatch.setattr(host_ops, "host_key", lambda: "another machine")
    assert host_ops.library_path() != here
