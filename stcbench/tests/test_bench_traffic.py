"""The traffic generator is a function of the seed and the mix."""

import numpy as np

from stcbench import traffic
from stcbench.tests import tiny

SEED = 2 ** 31 + 977


def test_video_is_the_seeds():
    mix = tiny.spec("ingest")["mix"]
    a = traffic.render_video(SEED, 0, 40, mix, "cpu")
    b = traffic.render_video(SEED, 0, 40, mix, "cpu")
    c = traffic.render_video(SEED + 1, 0, 40, mix, "cpu")
    assert a.shape == (40, 36, 64, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # consecutive frames share most of their content: within a scene the
    # mean step is far below that between two seeds' frames
    step = np.abs(a[1:].astype(int) - a[:-1]).mean()
    assert step < 0.5 * np.abs(a.astype(int) - c).mean()


def test_scene_cuts_cover_the_video():
    lens = traffic.scene_lengths(SEED, 3, 960, 30, 120)
    assert sum(lens) == 960 and all(1 <= n <= 120 for n in lens)
    assert all(n >= 30 for n in lens[:-1])


def test_marks_and_picks_are_the_seeds():
    marks = [traffic.marked(SEED, 16, "w", 0, k) for k in range(960)]
    assert marks == [traffic.marked(SEED, 16, "w", 0, k)
                     for k in range(960)]
    assert 30 < sum(marks) < 90
    items = list(range(50))
    p = traffic.pick(SEED, items, 10, "chunks")
    assert p == traffic.pick(SEED, items, 10, "chunks") == sorted(p)
    assert len(set(p)) == 10
    assert traffic.pick(SEED, items[:3], 10, "chunks") == items[:3]
    assert traffic.init_prompt(SEED, 14, 100) == traffic.init_prompt(
        SEED, 14, 100)
