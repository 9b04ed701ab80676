"""The port's native dataset parser (native/vo_io.cpp, bound in
native/dataloader.py) against the numpy readers, on a generated
reference-format dataset: identical arrays, exactly. Also the parser's edge
cases (tests/test_native_io.py:40-50) and the choice of parser in
utils/io: "native" raises when the parser cannot be built, "auto" warns and
parses with numpy."""

import os
import stat

import numpy as np
import pytest

from visual_odometry_tpu.utils import dataset_gen as jdg
from visual_odometry_tpu_torch.native import dataloader
from visual_odometry_tpu_torch.utils import io

FIELDS = ("points", "appearances", "ids", "mask", "counts")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dataset") / "data")
    jdg.generate_dataset(d, num_frames=12, num_landmarks=300, seed=3)
    return d


def _same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("n_slots", [128, 256, None])
def test_native_sequence_equals_numpy(data_dir, n_slots):
    _same(io.load_sequence(data_dir, n_slots, parser="native"),
          io.load_sequence(data_dir, n_slots, parser="numpy"))
    _same(io.load_sequence(data_dir, n_slots), io.load_sequence(data_dir, n_slots, "numpy"))


def test_native_tables_equal_numpy(data_dir):
    for name in io.list_measurement_files(data_dir)[:4]:
        path = os.path.join(data_dir, name)
        got = dataloader.parse_table(path, 3, 1, 14)
        np.testing.assert_array_equal(got, np.loadtxt(path, skiprows=3, usecols=range(1, 15),
                                                      ndmin=2))
        a, b = io.load_measurements(path), io._measurements(path, "numpy")
        for f in ("ids", "points", "appearances"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    world = os.path.join(data_dir, "world.dat")
    got = dataloader.parse_table(world, 0, 0, 14)
    assert got.shape == (300, 14)
    np.testing.assert_array_equal(got, np.loadtxt(world, ndmin=2))
    ids, points, apps = io.load_world(world)
    assert (ids.dtype, points.dtype, apps.dtype) == (np.int32, np.float32, np.float32)
    np.testing.assert_array_equal(points, got[:, 1:4].astype(np.float32))


def test_missing_file(tmp_path):
    missing = str(tmp_path / "nothing.dat")
    assert dataloader.parse_table(missing, 0, 0, 3) is None
    with pytest.raises(FileNotFoundError):
        io.load_world(missing)
    with pytest.raises(ValueError, match="native parser cannot load"):
        io.load_sequence(str(tmp_path), 128, parser="native")


def test_blank_and_short_lines(tmp_path):
    p = tmp_path / "t.dat"
    p.write_text("hdr\n1 2 3\n\n4 5 6\nshort\n7 8 9\n")
    np.testing.assert_array_equal(dataloader.parse_table(str(p), 1, 0, 3),
                                  [[1, 2, 3], [4, 5, 6], [7, 8, 9]])
    empty = tmp_path / "empty.dat"
    empty.write_text("")
    assert dataloader.parse_table(str(empty), 0, 0, 3).shape == (0, 3)


def test_a_frame_over_the_slots(data_dir):
    with pytest.raises(ValueError, match="native parser cannot load"):
        io.load_sequence(data_dir, 8, parser="native")
    with pytest.raises(ValueError, match="exceeds n_slots"):
        io.load_sequence(data_dir, 8, parser="auto")


def test_failed_build_raises_for_native_and_warns_for_auto(data_dir, tmp_path, monkeypatch):
    """A compiler that fails: parser="native" raises with its output, and so
    does every later call without compiling again; "auto" warns and parses
    with numpy; an unknown parser is refused."""
    cc = tmp_path / "broken-cc"
    cc.write_text("#!/bin/sh\necho 'broken-cc: no such toolchain' >&2\nexit 1\n")
    cc.chmod(cc.stat().st_mode | stat.S_IEXEC)
    for compiler, says in ((str(cc), "no such toolchain"),
                           (str(tmp_path / "no-compiler-here"), "could not build")):
        monkeypatch.setattr(dataloader, "COMPILER", compiler)
        for _ in range(2):
            with pytest.raises(dataloader.NativeBuildFailure, match=says):
                io.load_sequence(data_dir, 128, parser="native")
        assert not dataloader.available()
        with pytest.warns(RuntimeWarning, match=says):
            got = io.load_sequence(data_dir, 128, parser="auto")
        _same(got, io.load_sequence(data_dir, 128, parser="numpy"))
        assert not dataloader.library_path(compiler).exists()
    with pytest.raises(ValueError, match="parser"):
        io.load_sequence(data_dir, 128, parser="fast")
