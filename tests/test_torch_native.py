"""The fastbits host library of the port (``pilosa_tpu_torch.native``)
against the reference's native library and numpy.

Every test runs twice, as the cases of one parameter: with the library
active (built with g++ into ``build/native/``) and under
``PILOSA_TPU_NO_NATIVE=1``, where each entry point returns None and its
callers (``ops/packing.py``, ``Container.dense_words32``,
``RoaringBitmap._merge_loop``) take their numpy path. Both give the
reference's bytes.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.ops import packing as jpacking
from pilosa_tpu.roaring.bitmap import Container as JContainer
from pilosa_tpu.roaring.bitmap import RoaringBitmap as JBitmap
from pilosa_tpu.roaring.format import serialize as j_serialize
from pilosa_tpu_torch import native
from pilosa_tpu_torch.native import build as native_build
from pilosa_tpu_torch.ops import packing
from pilosa_tpu_torch.roaring.bitmap import ARRAY, RUN, Container, \
    RoaringBitmap
from pilosa_tpu_torch.roaring.format import serialize

torch.set_num_threads(1)

U = np.uint64


@pytest.fixture(params=["native", "numpy"])
def mode(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("PILOSA_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("PILOSA_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    # the case runs on the path it names: no compiler here is a failure
    assert native.available() is (request.param == "native")
    yield request.param
    native._lib = None  # the next user loads afresh


def test_pack_unpack_popcount_match_reference(mode):
    rng = np.random.default_rng(5)
    positions = np.unique(rng.choice(1 << 20, 50_000,
                                     replace=False)).astype(U)
    words = packing.pack_bits(positions, 1 << 20)
    want = jpacking.pack_bits(positions, 1 << 20)
    assert words.dtype == np.uint32 and words.tobytes() == want.tobytes()
    assert packing.popcount_words(words) == jpacking.popcount_words(want) \
        == positions.size
    for offset in (0, 1 << 30):
        got = packing.unpack_bits(words, offset)
        assert got.dtype == np.uint64
        assert got.tobytes() == jpacking.unpack_bits(want, offset).tobytes()
    # int32 words (as the card's tensors hold them) read the same bits
    assert packing.unpack_bits(words.view(np.int32)).tobytes() == \
        packing.unpack_bits(words).tobytes()
    fast = native.pack_positions(positions, (1 << 20) // 32)
    if mode == "native":
        assert fast.tobytes() == want.tobytes()
    else:
        assert fast is None
    with pytest.raises(ValueError):
        packing.pack_bits(np.asarray([1 << 14], U), 1 << 14)


def test_container_decode_matches_reference(mode):
    rng = np.random.default_rng(6)
    runs = np.array([[0, 5], [100, 100], [65530, 65535]], np.uint16)
    lows = np.unique(rng.integers(0, 65536, 3000)).astype(np.uint16)
    for port, ref in ((Container(RUN, runs, 13), JContainer(3, runs, 13)),
                      (Container(ARRAY, lows, lows.size),
                       JContainer(1, lows, lows.size))):
        got = port.dense_words32()
        assert got.dtype == np.uint32 and got.shape == (2048,)
        assert got.tobytes() == ref.dense_words32().tobytes()
    got = packing.unpack_bits(Container(RUN, runs, 13).dense_words32())
    assert got.tolist() == list(range(6)) + [100] + list(range(65530, 65536))
    if mode == "native":
        assert native.runs_to_words(runs).tobytes() == \
            Container(RUN, runs, 13).dense_words32().tobytes()


def test_empty_inputs(mode):
    assert packing.popcount_words(np.zeros(8, np.uint32)) == 0
    assert packing.unpack_bits(np.zeros(8, np.uint32)).size == 0
    assert not packing.pack_bits(np.empty(0, U), 256).any()
    assert not Container(ARRAY, np.empty(0, np.uint16),
                         0).dense_words32().any()
    if mode == "native":
        assert native.popcount_words(np.zeros(8, np.uint32)) == 0
        assert native.unpack_positions(np.zeros(8, np.uint32)).size == 0
        assert not native.pack_positions(np.empty(0, U), 8).any()


def test_small_merges_match_reference(mode):
    """The per-container loop's array unions and differences (fastbits'
    two-pointer merges, or numpy's set operations) build the
    reference's bytes, over empty, disjoint and equal edges."""
    rng = np.random.default_rng(17)
    cases = [
        (np.empty(0, np.uint16), np.empty(0, np.uint16)),
        (np.array([3], np.uint16), np.empty(0, np.uint16)),
        (np.empty(0, np.uint16), np.array([9], np.uint16)),
        (np.array([1, 2, 3], np.uint16), np.array([4, 5], np.uint16)),
        (np.array([0, 65535], np.uint16), np.array([0, 65535], np.uint16)),
    ]
    for _ in range(12):
        cases.append(tuple(
            np.unique(rng.choice(1 << 16, rng.integers(0, 4000),
                                 replace=False).astype(np.uint16))
            for _ in range(2)))
    for a, b in cases:
        if mode == "native":
            assert native.union_sorted_u16(a, b).tobytes() == \
                np.union1d(a, b).tobytes()
            assert native.diff_sorted_u16(a, b).tobytes() == \
                np.setdiff1d(a, b, assume_unique=True).tobytes()
        for remove in (False, True):
            jb, pb = JBitmap(), RoaringBitmap()
            if a.size:
                jb._merge_loop(a.astype(U), False)
                pb._merge_loop(a.astype(U), False)
            # the loop, as a write batch under the kernel's size is
            for part in np.array_split(b.astype(U), max(1, b.size // 50)):
                if part.size:
                    assert pb._merge_loop(part, remove) == \
                        jb._merge_loop(part, remove)
            assert serialize(pb) == j_serialize(jb)


def test_library_builds_outside_the_package(mode, tmp_path, monkeypatch):
    """The library goes to ``build/native/`` under a name that hashes
    its source; with no compiler and nothing built the port still
    imports, and every caller takes numpy."""
    if mode == "native":
        path = native_build.lib_path()
        assert path.parent == native_build.BUILD_DIR
        assert path.parent.parent.name == "build"
        assert path.exists()
        assert native_build.SRC.parent.name == "native"
        assert not any(native_build.SRC.parent.glob("*.so"))
        return
    monkeypatch.delenv("PILOSA_TPU_NO_NATIVE")
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ or clang++
    monkeypatch.setattr(native, "_lib", None)
    assert native_build.build() is None
    assert not native.available()
    runs = np.array([[7, 9]], np.uint16)
    assert packing.unpack_bits(Container(RUN, runs, 3).dense_words32(
        )).tolist() == [7, 8, 9]
