"""Real video-decode plumbing of the port (tests/test_video_io.py mirrored):
an mp4 written by OpenCV in the test, decoded, clipped and driven through
the StreamingBench protocol, each step against stc_tpu's on the same
file.  Skips where OpenCV is missing (the card machine has none)."""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from stc_tpu.eval import solvers as j_sol  # noqa: E402
from stc_tpu.eval import streamingbench as j_sb  # noqa: E402
from stc_tpu_torch.eval import solvers as t_sol  # noqa: E402
from stc_tpu_torch.eval import streamingbench as t_sb  # noqa: E402
from test_eval import FakeModel  # noqa: E402
from test_video_io import SECONDS, H, W, dominant_second  # noqa: E402
from test_video_io import video_path  # noqa: E402,F401


def test_decode_full_video_at_1fps(video_path):  # noqa: F811
    frames = t_sol.load_video_frames(video_path, sample_fps=1.0)
    np.testing.assert_array_equal(
        frames, j_sol.load_video_frames(video_path, sample_fps=1.0))
    assert frames.shape[1:] == (H, W, 3)
    assert SECONDS <= len(frames) <= SECONDS + 1
    assert [dominant_second(f) for f in frames[:SECONDS]] == list(
        range(SECONDS))


def test_split_video_clips_time_range(video_path, tmp_path):  # noqa: F811
    clip = t_sb.split_video(video_path, 2, 5, str(tmp_path / "cache"))
    assert os.path.exists(clip)
    frames = t_sol.load_video_frames(clip, sample_fps=1.0)
    want = j_sol.load_video_frames(
        j_sb.split_video(video_path, 2, 5, str(tmp_path / "jax")), 1.0)
    np.testing.assert_array_equal(frames, want)
    secs = [dominant_second(f) for f in frames]
    assert secs[0] == 2 and secs[-1] in (4, 5), secs
    mtime = os.path.getmtime(clip)
    assert t_sb.split_video(video_path, 2, 5,
                            str(tmp_path / "cache")) == clip
    assert os.path.getmtime(clip) == mtime


def test_streamingbench_protocol_on_real_video(video_path,  # noqa: F811
                                               tmp_path):
    """The per-question loop (timestamp parse, clip, decode, encode, QA,
    incremental dump) on an actual mp4, in both packages."""
    def run(sb, name):
        model = FakeModel(answer="B")
        ev = sb.StreamingBenchEval(model, "m", sample_fps=1.0,
                                   clip_cache_dir=str(tmp_path / name))
        data = [{"video_path": video_path, "questions": [
            {"time_stamp": "00:00:03", "question": "color?",
             "options": ["A. red", "B. blue"], "answer": "B",
             "task_type": "t"},
            {"time_stamp": "00:00:05", "question": "later color?",
             "options": ["A. red", "B. blue"], "answer": "B",
             "task_type": "t"},
        ]}]
        out = str(tmp_path / f"{name}.json")
        ev.run(data, out)
        assert os.path.exists(out)
        return data, [c for c in model.calls if c.startswith("video:")]

    data, videos = run(t_sb, "port")
    assert (data, videos) == run(j_sb, "jax")
    assert all(q["m"] == "B" for q in data[0]["questions"])
    n1, n2 = (int(v.split(":")[1]) for v in videos)
    assert 2 <= n1 <= 4 and 4 <= n2 <= 6 and n2 > n1
