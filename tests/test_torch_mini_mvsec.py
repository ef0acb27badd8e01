"""The port's mini-MVSEC renderer (`data/mini_mvsec.py`) against
tools/make_mini_mvsec.py, bit for bit: every HDF5 dataset, the
calibration and the RPE pair files; and the in-memory archive read
through the MVSEC reader equal to the same sequence read from disk."""

import sys

import numpy as np
import pytest
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _datasets(path):
    import h5py
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_mini_mvsec_renderer_matches_the_tool(tmp_path):
    import tools.make_mini_mvsec as tool
    from ei_nexus_tpu_torch.data import mini_mvsec

    n_want, ts_want = tool.gen_sequence(str(tmp_path / "tool"),
                                        "indoor_flying", "indoor_flying1",
                                        6, 0.0, 10)
    n_got, ts_got = mini_mvsec.gen_sequence(str(tmp_path / "port"),
                                            "indoor_flying", "indoor_flying1",
                                            6, 0.0, 10)
    assert n_got == n_want > 0
    np.testing.assert_array_equal(ts_got, ts_want)
    for suffix in ("_data.hdf5", "_gt.hdf5", "_rectified.h5"):
        name = "indoor_flying/indoor_flying1" + suffix
        want = _datasets(tmp_path / "tool" / name)
        got = _datasets(tmp_path / "port" / name)
        assert sorted(got) == sorted(want), suffix
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_mini_mvsec_pairs_and_calibration_match_the_tool(tmp_path,
                                                         monkeypatch):
    """The tool's main and `make_mini_mvsec` over one validation sequence
    of 70 frames (10 left by its crop, 2 pairs 8 apart): the same pair
    file and calibration."""
    import tools.make_mini_mvsec as tool
    from ei_nexus_tpu_torch.data.mini_mvsec import make_mini_mvsec

    monkeypatch.setattr(sys, "argv", [
        "make_mini_mvsec.py", "--root", str(tmp_path / "tool"),
        "--val-frames", "70", "--sequences", "indoor_flying4"])
    tool.main()
    counts = make_mini_mvsec(str(tmp_path / "port"), val_frames=70,
                             sequences=["indoor_flying4"])
    assert list(counts) == ["indoor_flying4"]
    pairs = np.loadtxt(tmp_path / "port" / "indoor_flying4_final_indices.txt")
    np.testing.assert_array_equal(pairs, [[0, 8], [1, 9]])
    for f in ("indoor_flying4_final_indices.txt",
              "indoor_flying_calib/camchain-imucam-indoor_flying.yaml"):
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "tool" / f).read_text(), f
    with pytest.raises(ValueError, match="unknown"):
        make_mini_mvsec(str(tmp_path), sequences=["no_such"])


def test_rendered_archive_reads_as_the_files(tmp_path):
    """`RenderedArchive` through `MVSECSequence.view`: every field of every
    frame's view equal to the reader's over the written files."""
    from ei_nexus_tpu_torch.data import mini_mvsec
    from ei_nexus_tpu_torch.data.mvsec import MVSECArchive, MVSECSequence

    arrays = mini_mvsec.render_sequence(12, 0.0, 10)
    mini_mvsec.write_sequence(str(tmp_path), "indoor_flying",
                              "indoor_flying1", arrays)
    mini_mvsec.write_calib(str(tmp_path), "indoor_flying")
    disk = MVSECSequence(MVSECArchive(str(tmp_path)), "indoor_flying1")
    mem = MVSECSequence(mini_mvsec.RenderedArchive(
        {"indoor_flying1": arrays}), "indoor_flying1")
    assert len(mem) == len(disk) == 12   # shorter than its crop: uncropped
    np.testing.assert_array_equal(mem.K, disk.K)
    for i in range(len(disk)):
        want = disk.view(i, 0.4, 1 << 16)
        got = mem.view(i, 0.4, 1 << 16)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(mem.view(4, 0.4, 1 << 16)["events_valid"].sum()) > 1000
