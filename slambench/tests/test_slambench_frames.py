"""The harness's frame source against the port's synthetic reader: the
same frames, cast in torch instead of host numpy, at a reduced size."""

import numpy as np
import pytest

from pointnerf_slam_torch.io.synthetic import SyntheticDataset
from slambench.frames import FrameSource

CAM = {"H": 68, "W": 120, "fx": 60.0, "fy": 60.0, "cx": 59.5, "cy": 33.95,
       "crop_edge": 0}
SEQ = {"n_frames": 500, "orbit": 0.5}


@pytest.fixture(scope="module")
def pair():
    reader = SyntheticDataset({"cam": CAM, "data": dict(SEQ)}, None, 1.0)
    return reader, FrameSource(SEQ, CAM, 1.0, 8, "cpu")


@pytest.mark.parametrize("idx", [0, 3, 7])
def test_frames_match_the_reader(pair, idx):
    reader, source = pair
    _, c_ref, d_ref, p_ref = reader[idx]
    i, c, d, p = source[idx]
    assert i == idx and c.dtype == np.float32 and d.dtype == np.float32
    assert c.shape == (CAM["H"], CAM["W"], 3) and d.shape == (CAM["H"],
                                                               CAM["W"])
    np.testing.assert_allclose(c, c_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(d, d_ref, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(p, p_ref)


def test_poses_match_over_the_sequence(pair):
    reader, source = pair
    assert len(source) == len(reader) == SEQ["n_frames"]
    np.testing.assert_array_equal(np.stack(source.poses),
                                  np.stack(reader.poses))


def test_reading_past_the_cast_frames_raises(pair):
    _, source = pair
    with pytest.raises(RuntimeError, match="exhausted"):
        source[8]
