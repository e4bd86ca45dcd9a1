"""The port's random-weight smokes (stc_tpu_torch/cli/stream_demo.py and
serve_demo.py) on the CPU at the tiny size: each `main([... "--size",
"tiny", "--device", "cpu"])` prints the summary lines of stc_tpu's demo
(scripts/stream_demo.py / serve_demo.py, run here with --cpu) with the
same fields (numbers masked where they are times or depend on the
weights, the traffic's counts equal), and its answers equal those of a
port session built here from the same seed and config and driven
directly."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from stc_tpu_torch.cli import serve_demo, stream_demo
from stc_tpu_torch.config import (CacherConfig, PrunerConfig, ReKVConfig,
                                  SessionConfig)
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.runtime.serving import ServingEngine
from stc_tpu_torch.runtime.session import StreamingSession
from stc_tpu_torch.utils.checkpoint import load_stream_state, save_stream_state
from test_torch_common import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
STREAM_ARGS = ["--frames", "16", "--question_every", "8", "--size", "tiny"]
SERVE_ARGS = ["--slots", "2", "--ticks", "8", "--spec", "2", "--migrate",
              "--size", "tiny"]


def _jax_demo(script, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / script)]
                         + args + ["--cpu"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.splitlines()


def _masked(line):
    return re.sub(r"\d+(\.\d+)?", "#", line)


def test_stream_demo_prints_stc_tpu_fields_and_its_answers(capsys):
    got = stream_demo.main(STREAM_ARGS + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    want = _jax_demo("stream_demo.py", STREAM_ARGS)
    assert [_masked(x) for x in lines] == [_masked(x) for x in want]
    assert lines[-1].startswith("done: ") and "host tier: 0 pages" in lines[-1]
    assert got["summary"]["questions"] == 2 and got["host_pages"] == 0

    # the same session, built and driven here
    rekv = ReKVConfig(n_init=4, n_local=256, block_size=3, exc_block_size=3,
                      topk=4, max_blocks=128, max_prompt_tokens=32,
                      max_new_tokens=8)
    scfg = SessionConfig(rekv=rekv, cacher=CacherConfig(),
                         pruner=PrunerConfig(token_per_frame=3))
    model = lo.LlavaOV(lo.LlavaOVConfig.tiny(), dtype=torch.float32,
                       vision_dtype=torch.float32, device="cpu")
    model.init_random_params(torch.Generator().manual_seed(0))
    sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                            device="cpu")
    sess.encode_init_prompt([0, 1, 2, 3])
    rng = np.random.default_rng(0)
    answers = []
    for i in range(16):
        sess.encode_video(rng.integers(0, 256, (1, 56, 56, 3),
                                       dtype=np.uint8))
        if (i + 1) % 8 == 0:
            answers.append(sess.question_answering([5, 6, 7], [5, 6, 7, 8],
                                                   [0], max_new_tokens=8))
    assert got["answers"] == answers


def test_serve_demo_prints_stc_tpu_fields_and_its_answers(capsys, tmp_path):
    got = serve_demo.main(SERVE_ARGS + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    want = _jax_demo("serve_demo.py", SERVE_ARGS)
    # the per-tick answer lines' token counts depend on the weights, the
    # migration line on a temporary path; the summary's counts do not
    assert len(lines) == len(want)
    for a, b in zip(lines, want):
        if " via " in b:
            assert a.split(" via ")[0] == b.split(" via ")[0]
        elif a.startswith("done in"):
            assert a.split("s: ", 1)[1] == b.split("s: ", 1)[1]
        elif "answered" in b:
            assert _masked(a) == _masked(b)
        else:
            assert a == b
    stats = got["stats"]
    assert stats["streams_retired"] == stats["streams_admitted"] == 1

    # the same engine over the same session, built and driven here
    rekv = ReKVConfig(n_init=4, n_local=128, block_size=8, exc_block_size=8,
                      topk=4, max_blocks=256, max_prompt_tokens=16,
                      max_new_tokens=8, spec_decode_draft=2,
                      spec_history_tokens=256)
    cfg = qw.Qwen2Config.tiny()
    lm = qw.Qwen2(cfg, dtype=torch.float32, device="cpu")
    lm.init_random_params(torch.Generator().manual_seed(0))
    sess = StreamingSession(lm, SessionConfig(rekv=rekv), batch=2,
                            state_dtype=torch.float32)
    sess.encode_init_prompt([0, 1, 2, 3])
    eng = ServingEngine(sess, stop_token_ids=[0], max_new_tokens=8)
    rng = np.random.default_rng(0)
    answers = {}
    for tick in range(8):
        for s in range(2):
            if eng.is_free(s):
                continue
            if tick % (s + 1) == 0:
                eng.submit_chunk(s, rng.normal(size=(8, cfg.hidden_size))
                                 .astype(np.float32) * 0.02)
            if (tick + s) % 5 == 4:
                n = 4 + (s + tick) % 5
                eng.submit_question(
                    s, list(rng.integers(1, cfg.vocab_size, size=n)),
                    list(rng.integers(1, cfg.vocab_size, size=n + 2)))
        if tick == 4:
            blob = str(tmp_path / "stream0.npz")
            save_stream_state(sess, 0, blob)
            eng.retire(1)
            load_stream_state(sess, eng.admit(), blob)
        answers.update(eng.step())
    answers.update(eng.run())
    assert got["answers"] == answers
    assert got["stats"] == {k: getattr(eng.stats, k) for k in stats}


@pytest.mark.parametrize("demo", [stream_demo, serve_demo])
def test_demos_default_to_the_card(demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        demo.main(["--size", "tiny"])
