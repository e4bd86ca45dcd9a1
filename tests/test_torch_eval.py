"""The port's eval layer (stc_tpu_torch.eval and runtime/adapter.py) against
stc_tpu's.

First every test of tests/test_eval.py but the two golden-file ones, each
running both packages' functions on the same input (fresh fake models) and
holding the outputs equal, with the original assertions on the port's.
Then the protocols on real sessions: run_eval (offline, VideoMME with its
time field left out, stream), StreamingBench and OVO-Bench drive a port
session and a stc_tpu session built from the same params through each
package's SessionAdapter; rows and outputs must be equal, and no row an
error row.  The stc_tpu side runs once per module."""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stc_tpu.config import (CacherConfig, PrunerConfig, ReKVConfig,
                            SessionConfig)
from stc_tpu.eval import ovobench as j_ovo
from stc_tpu.eval import reports as j_rep
from stc_tpu.eval import runner as j_run
from stc_tpu.eval import scorers as j_sc
from stc_tpu.eval import solvers as j_sol
from stc_tpu.eval import streamingbench as j_sb
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.runtime import adapter as j_ad
from stc_tpu_torch import weights
from stc_tpu_torch.eval import ovobench as t_ovo
from stc_tpu_torch.eval import reports as t_rep
from stc_tpu_torch.eval import runner as t_run
from stc_tpu_torch.eval import scorers as t_sc
from stc_tpu_torch.eval import solvers as t_sol
from stc_tpu_torch.eval import streamingbench as t_sb
from stc_tpu_torch.models import llava_onevision as tlo
from stc_tpu_torch.runtime import adapter as t_ad
from test_eval import (SAMPLE, FakeModel, ProactiveModel, _loader,
                       fake_frames)
from test_eval_batched import ANNO, HashTok, N_INIT, loader
from test_torch_common import (np_tree, one_thread,  # noqa: F401
                               port_cfg, port_model_cfg)

pytestmark = pytest.mark.usefixtures("one_thread")

PKGS = {
    "port": SimpleNamespace(ovo=t_ovo, rep=t_rep, run=t_run, sc=t_sc,
                            sol=t_sol, sb=t_sb, ad=t_ad),
    "jax": SimpleNamespace(ovo=j_ovo, rep=j_rep, run=j_run, sc=j_sc,
                           sol=j_sol, sb=j_sb, ad=j_ad),
}


def both(fn):
    """fn(package) for the port and stc_tpu; asserts the two results equal
    and returns the port's."""
    out = {name: fn(p) for name, p in PKGS.items()}
    assert out["port"] == out["jax"], out
    return out["port"]


# ---------------------------------------------------------------------------
# Scorers
# ---------------------------------------------------------------------------

def test_extract_choice():
    got = both(lambda p: [p.sc.extract_choice(s) for s in
                          ("A) because", "(B) text", "C", "")])
    assert got == ["A", "B", "C", "A"]


def test_multiple_choice_accuracy():
    rows = [{"pred_choice": "A", "correct_choice": "A"},
            {"pred_choice": "B", "correct_choice": "A"}]
    assert both(lambda p: p.sc.multiple_choice_accuracy(rows))[
        "accuracy"] == 50.0


def test_streamingbench_scorer_rules():
    data = [{"questions": [
        {"task_type": "t1", "answer": "A", "m": "A"},
        {"task_type": "t1", "answer": "B", "m": " B "},
        {"task_type": "t2", "answer": "C", "m": ["C", "x"]},
        {"task_type": "t2", "answer": "C", "m": "D"},
        {"task_type": "t2", "answer": "C"},
    ]}]
    s = both(lambda p: p.sc.streamingbench_score(data, "m"))
    assert s["t1"]["accuracy"] == 100.0
    assert s["t2"]["accuracy"] == 50.0
    assert s["total"]["total"] == 4


def test_ovobench_scorer_rules():
    results = {
        "backward": [
            {"task": "EPM", "response": "A", "ground_truth": "A"},
            {"task": "EPM", "response": "the answer is B",
             "ground_truth": "B"},
            {"task": "EPM", "response": "C", "ground_truth": "A"},
        ],
        "realtime": [],
        "forward": [
            {"task": "REC", "test_info": [
                {"response": "3 times", "count": 3},
                {"response": "twelve", "count": 12}]},
            {"task": "SSR", "test_info": [
                {"response": "N", "type": 0},
                {"response": "Yes", "type": 1},
                {"response": "No", "type": 1}]},
        ],
    }
    s = both(lambda p: p.sc.ovobench_score(results))
    assert abs(s["backward"]["tasks"]["EPM"] - 200 / 3) < 1e-6
    assert s["forward"]["tasks"]["REC"] == 50.0
    assert abs(s["forward"]["tasks"]["SSR"] - 200 / 3) < 1e-6
    assert "realtime" not in s


def test_streamingbench_sqa_and_proactive_scorers():
    sqa = [[{"questions": [{"task_type": "t", "answer": "A", "m": "A"}]},
            {"questions": [{"task_type": "t", "answer": "B", "m": "A"}]}]]
    s = both(lambda p: p.sc.streamingbench_score_sqa(sqa, "m"))
    assert s["t"]["total"] == 2 and s["t"]["correct"] == 1

    pro = [{"questions": [{
        "task_type": "p", "ground_truth_time_stamp": "00:01:00",
        "ground_truth_output": "a red car",
        "m": {"dialog_history": [{"time": 61,
                                  "content": "I see a red car"}]},
    }, {
        "task_type": "p", "ground_truth_time_stamp": "00:01:00",
        "ground_truth_output": "a red car",
        "m": {"dialog_history": [{"time": 70, "content": "a red car"}]},
    }]}]
    s = both(lambda p: p.sc.streamingbench_score_proactive(pro, "m"))
    assert s["p"]["total"] == 2
    assert s["p"]["time_correct"] == 1 and s["p"]["answer_correct"] == 1
    assert s["p"]["time_accuracy"] == 0.5


def test_open_ended_accuracy():
    rows = [
        {"answer": "a red car", "pred_answer": "I see a red car."},
        {"answer": "blue", "pred_answer": "green"},
        {"answer": None, "pred_answer": "x"},
    ]
    s = both(lambda p: p.sc.open_ended_accuracy(rows))
    assert s["n"] == 2 and s["accuracy"] == 50.0
    s = both(lambda p: p.sc.open_ended_accuracy(
        rows, judge=lambda q, a, pr: True))
    assert s["accuracy"] == 100.0


# ---------------------------------------------------------------------------
# Solvers + runner over a fake model
# ---------------------------------------------------------------------------

def test_offline_solver_flow():
    def run(p):
        m = FakeModel()
        return p.sol.OfflineVQA(m, frame_loader=fake_frames)(SAMPLE), m.calls

    rows, calls = both(run)
    assert [r.get("qa_acc") for r in rows[:2]] == [100.0, 0.0]
    assert "pred_answer" in rows[2] and "qa_acc" not in rows[2]
    assert calls[:2] == ["clear", "init"]


def test_stream_solver_incremental_windows():
    sample = {
        "video_id": "v", "video_path": "fake.mp4",
        "conversations": [
            {"question": "a", "end_time": 3},
            {"question": "b", "end_time": 7},
            {"question": "c"},
        ],
    }

    def run(p):
        m = FakeModel()
        rows = p.sol.StreamVQA(m, sample_fps=1.0,
                               frame_loader=fake_frames)(sample)
        return rows, [c for c in m.calls if c.startswith("video:")]

    _, feeds = both(run)
    assert feeds == ["video:3", "video:4", "video:3"]


def test_runner_shard_merge(tmp_path):
    anno = [dict(SAMPLE, video_id=f"v{i}") for i in range(5)]
    anno_path = tmp_path / "anno.json"
    anno_path.write_text(json.dumps(anno))

    def run(p):
        d = tmp_path / p.run.__name__.split(".")[0]
        for rank in range(2):
            p.run.run_eval("mlvu", FakeModel(), str(d),
                           anno_path=str(anno_path), rank=rank, world=2,
                           frame_loader=fake_frames)
        out = p.run.merge_and_score(str(d), "mlvu")
        merged = json.loads((d / "merged_score.json").read_text())
        return ({k: v for k, v in out.items() if k != "ts"},
                merged["rows"])

    out, _ = both(run)
    assert out["n_rows"] == 5 * 3
    assert out["score"]["n"] == 10
    assert out["score"]["accuracy"] == 50.0


def test_runner_takes_rank_and_world_from_the_process_group(
        tmp_path, monkeypatch):
    """Without rank / world, run_eval reads torch.distributed's group when
    one is up (else rank 0 of 1), as stc_tpu reads its JAX process."""
    import torch.distributed as dist
    anno = [dict(SAMPLE, video_id=f"v{i}") for i in range(5)]
    anno_path = tmp_path / "anno.json"
    anno_path.write_text(json.dumps(anno))
    rows, path = t_run.run_eval("mlvu", FakeModel(), str(tmp_path / "a"),
                                anno_path=str(anno_path),
                                frame_loader=fake_frames)
    assert path.endswith("results_rank0.json") and len(rows) == 15
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    rows, path = t_run.run_eval("mlvu", FakeModel(), str(tmp_path / "b"),
                                anno_path=str(anno_path),
                                frame_loader=fake_frames)
    assert path.endswith("results_rank1.json")
    assert [r["video_id"] for r in rows[::3]] == ["v1", "v3"]


def test_runner_tags_sweep_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("STC_TOPK", "32")
    monkeypatch.setenv("STC_CHUNK_SIZE", "2")
    anno = [{"video_id": "v", "video_path": "x.mp4",
             "conversations": [{"question": "q", "choices":
                                ["A. a", "B. b"], "answer": "A. a"}]}]
    anno_path = tmp_path / "anno.json"
    anno_path.write_text(json.dumps(anno))

    def run(p):
        rows, _ = p.run.run_eval(
            "mlvu", FakeModel(), str(tmp_path / p.run.__name__),
            anno_path=str(anno_path), rank=0, world=1,
            frame_loader=fake_frames)
        return rows

    rows = both(run)
    assert rows and rows[0]["retrieve_size"] == 32
    assert rows[0]["chunk_size"] == 2


# ---------------------------------------------------------------------------
# StreamingBench / OVO-Bench protocols over a fake model
# ---------------------------------------------------------------------------

def test_streamingbench_protocol(tmp_path):
    def loader4(path, t0, t1, fps):
        return np.zeros((t1 - t0, 4, 4, 3), np.uint8)

    def run(p):
        m = FakeModel()
        data = [{"video_path": "x.mp4", "questions": [
            {"time_stamp": "00:00:10", "question": "q",
             "options": ["A. a"], "answer": "A", "task_type": "t"},
            {"time_stamp": "00:01:00", "question": "q2",
             "options": ["A. a"], "answer": "B", "task_type": "t",
             "m": "B"},
        ]}]
        ev = p.sb.StreamingBenchEval(m, "m", frame_loader=loader4)
        out = ev.run(data, str(tmp_path / f"{p.sb.__name__}.json"))
        return (out, m.encoded_frames, p.sc.streamingbench_score(out, "m"),
                p.sb.parse_timestamp("01:02:03"))

    out, frames, s, ts = both(run)
    assert out[0]["questions"][0]["m"] == "A"
    assert out[0]["questions"][1]["m"] == "B"
    assert frames == 10
    assert s["total"]["correct"] == 2
    assert ts == 3723


def test_ovobench_protocol(tmp_path):
    anno = {
        "backward": [{"id": "1", "video": "v.mp4", "task": "EPM",
                      "question": "q", "options": ["x", "y"], "gt": 0,
                      "realtime": 5}],
        "realtime": [],
        "forward": [{"id": "2", "video": "v2.mp4", "task": "SSR",
                     "question": None,
                     "test_info": [{"step": "chop", "type": 1,
                                    "realtime": 3}]}],
    }

    def loader3(ref, t, fps):
        return np.zeros((3, 4, 4, 3), np.uint8)

    def run(p):
        ev = p.ovo.OVOBenchEval(FakeModel(answer="A"), frame_loader=loader3)
        res = ev.eval(anno, str(tmp_path / f"{p.ovo.__name__}.json"))
        return (res, p.sc.ovobench_score(res),
                p.ovo.build_prompt("EPM", "q", ["x", "y"]),
                p.ovo.split_contiguous(list(range(10)), 1, 3))

    res, s, prompt, split = both(run)
    assert res["backward"][0]["response"].startswith("A")
    assert res["backward"][0]["ground_truth"] == "A"
    assert s["backward"]["tasks"]["EPM"] == 100.0
    assert "A. x; B. y;" in prompt
    assert split == [4, 5, 6]


def test_streamingbench_proactive_protocol(tmp_path):
    def run(p):
        m = ProactiveModel(yes_after=2)
        data = [{"video_path": "x.mp4", "questions": [
            {"time_stamp": "00:00:05", "ground_truth_time_stamp": "00:00:08",
             "question": "say it when ready",
             "ground_truth_output": "the word", "task_type": "proactive"},
        ]}]
        ev = p.sb.StreamingBenchProactiveEval(m, "m", frame_loader=_loader)
        path = str(tmp_path / f"{p.sb.__name__}.json")
        out = ev.run(data, path)
        polls = m.polls
        ev.run(out, path)
        rec = out[0]["questions"][0]["m"]
        # the measured costs are host times: out of the comparison
        dialog = [{k: v for k, v in d.items() if k != "cost"}
                  for d in rec["dialog_history"]]
        return (rec["answered"], dialog, polls, m.polls,
                p.sc.streamingbench_score_proactive(out, "m"))

    answered, dialog, polls, polls_after, s = both(run)
    assert answered == 7
    assert [d["role"] for d in dialog] == ["user", "assistant"] * 3
    assert dialog[-1]["content"] == "the ground truth"
    assert polls_after == polls
    assert s["proactive"]["total"] == 1
    assert s["proactive"]["time_correct"] == 1
    assert s["proactive"]["answer_correct"] == 0


def test_streamingbench_sqa_protocol(tmp_path):
    class EchoModel(FakeModel):
        def __init__(self):
            super().__init__()
            self.prompts = []

        def question_answering(self, input_text, max_new_tokens=128):
            self.prompts.append(input_text["question"])
            return "A"

    def run(p):
        m = EchoModel()
        data = [[{"video_path": "x.mp4", "questions": [
            {"time_stamp": "00:00:05", "question": "q1",
             "options": ["a", "b", "c", "d"], "answer": "A"},
            {"time_stamp": "00:00:09", "question": "q2",
             "options": ["a", "b", "c", "d"], "answer": "B"},
        ]}]]
        ev = p.sb.StreamingBenchSQAEval(m, "m", frame_loader=_loader)
        out = ev.run(data, str(tmp_path / f"{p.sb.__name__}.json"))
        return out, m.prompts, p.sb.PROMPT_TEMPLATE_SQA

    out, prompts, template = both(run)
    assert out[0][0]["questions"][0]["m"] == "A"
    assert "q1" in prompts[1] and "Answer: A" in prompts[1]
    assert prompts[0].startswith(template[:40])
    assert "A. a" in prompts[0]


def test_streamingbench_openstream_protocol(tmp_path):
    def run(p):
        m = FakeModel()
        data = [{"video_path": "x.mp4", "questions": [
            {"time_stamp": "00:00:10", "question": "q1",
             "options": ["a", "b", "c", "d"]},
            {"time_stamp": "00:00:25", "question": "q2"},
        ]}]
        ev = p.sb.StreamingOpenStreamTextEval(m, "m", frame_loader=_loader)
        out = ev.run(data, str(tmp_path / f"{p.sb.__name__}.json"))
        return out, m.calls, m.encoded_frames

    out, calls, frames = both(run)
    assert calls.count("clear") == 1
    assert "video:10" in calls and "video:15" in calls
    assert frames == 25
    assert out[0]["questions"][0]["m"].startswith("A")


# ---------------------------------------------------------------------------
# Report generators
# ---------------------------------------------------------------------------

def test_videomme_sweep_pivot(tmp_path):
    rows = []
    for rs, cs, accs in [(16, 1, [1, 0]), (64, 1, [1, 1]), (16, 2, [0, 0])]:
        rows += [{"retrieve_size": rs, "chunk_size": cs, "qa_acc": a}
                 for a in accs]
    pivot = both(lambda p: p.rep.videomme_sweep(rows))
    assert pivot[1][16] == 50.0 and pivot[1][64] == 100.0
    assert pivot[2][16] == 0.0
    ok = both(lambda p: p.rep.save_heatmap(
        pivot, str(tmp_path / f"{p.rep.__name__}.png")))
    assert not ok or (tmp_path / f"{t_rep.__name__}.png").exists()


def test_mlvu_by_task():
    rows = [{"task": "ego", "qa_acc": 1}, {"task": "ego", "qa_acc": 0},
            {"task": "count", "qa_acc": 1}]
    out = both(lambda p: p.rep.mlvu_by_task(rows))
    assert out["ego"] == 50.0 and out["count"] == 100.0
    assert out["plotQA"] is None
    assert out["overall"] == 75.0


def test_egoschema_report(tmp_path):
    rows = [
        {"video_id": "v1", "question": "q", "qa_acc": 1, "category": "c1",
         "pred_choice": "A", "correct_choice": "A"},
        {"video_id": "v2", "question": "q", "qa_acc": 0, "category": "c1",
         "pred_choice": "B", "correct_choice": "A"},
    ]

    def run(p):
        d = tmp_path / p.rep.__name__
        rep = p.rep.egoschema_report(rows, output_dir=str(d))
        return rep, (d / "report.md").read_text(), json.loads(
            (d / "report.json").read_text())

    rep, md, js = both(run)
    assert rep["accuracy"] == 50.0
    assert rep["by_category"]["c1"]["total"] == 2
    assert rep["top_errors"][0]["video_id"] == "v2"
    assert md.startswith("# EgoSchema report") and js == rep


def test_gpt_judge_parsing_and_fallback(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert both(lambda p: p.rep.parse_judge_response(
        "{'pred': 'yes', 'score': 4}")) == {"pred": "yes", "score": 4.0}
    rows = [{"question": "q", "answer": "cat", "pred_answer": "a cat here"},
            {"question": "q", "answer": "dog", "pred_answer": "a cat"}]
    out = both(lambda p: p.rep.gpt_judge_open_ended(rows))
    assert out["judge"] == "containment-fallback"
    assert out["accuracy"] == 50.0

    def judge(q, a, p):
        return {"pred": "yes", "score": 5.0}
    out = both(lambda p: p.rep.gpt_judge_open_ended(rows, judge=judge))
    assert out["judge"] == "gpt" and out["accuracy"] == 100.0


# ---------------------------------------------------------------------------
# The protocols on real sessions, port against stc_tpu
# ---------------------------------------------------------------------------

STREAM_ANNO = [
    {"video_id": "v2", "video_path": "v2", "conversations": [
        {"question": "what now", "answer": "a", "end_time": 4},
        {"question": "and then", "answer": "b", "end_time": 8},
        {"question": "at the end", "answer": "c"},
    ]},
    {"video_id": "v0", "video_path": "v0", "conversations": [
        {"question": "early on", "answer": "d", "end_time": 2},
        {"question": "later", "answer": "e"},
    ]},
]

SB_DATA = [{"video_path": "v2", "questions": [
    {"time_stamp": "00:00:03", "question": "which color",
     "options": ["A. red", "B. blue", "C. green"], "answer": "B",
     "task_type": "t"},
    {"time_stamp": "00:00:05", "question": "what moved",
     "options": ["A. car", "B. dog"], "answer": "A", "task_type": "t"},
]}, {"video_path": "v0", "questions": [
    {"time_stamp": "00:00:02", "question": "how many",
     "options": ["A. one", "B. two", "C. three", "D. four"], "answer": "C",
     "task_type": "u"},
]}]

OVO_ANNO = {
    "backward": [{"id": "v2", "video": "v2.mp4", "task": "EPM",
                  "question": "what was first", "options": ["x", "y", "z"],
                  "gt": 1, "realtime": 4}],
    "realtime": [{"id": "v0", "video": "v0.mp4", "task": "OCR",
                  "question": "read it", "options": ["p", "q"], "gt": 0,
                  "realtime": 3}],
    "forward": [{"id": "v4", "video": "v4.mp4", "task": "REC",
                 "activity": "jump",
                 "test_info": [{"count": 2, "realtime": 1},
                               {"count": 3, "realtime": 1}]}],
}


def sb_loader(path, t0, t1, fps):
    """StreamingBench's [t0, t1) seconds of a test video, one frame a
    second."""
    return loader(path, fps)[t0:t1]


def ovo_loader(ref, t, fps):
    """OVO-Bench's clip `<id>[_<i>].mp4` up to t seconds."""
    return loader(ref.split(".")[0].split("_")[0], fps)[:max(1, int(t))]


def jax_adapter(params, cfg):
    tpf = 3
    scfg = SessionConfig(
        rekv=ReKVConfig(n_init=N_INIT, n_local=256, block_size=tpf,
                        exc_block_size=tpf, topk=4, max_blocks=128,
                        max_prompt_tokens=32, max_new_tokens=8),
        cacher=CacherConfig(strategy="cacher", update_token_ratio=0.5,
                            cache_interval=2),
        pruner=PrunerConfig(strategy="stc", token_per_frame=tpf))
    sess = jlo.build_session(params, cfg, scfg, state_dtype=jnp.float32)
    return j_ad.SessionAdapter(sess, HashTok(), stop_token_ids=[0])


def port_adapter(params, cfg, jax_scfg, batch=1):
    model = weights.params_from_jax(np_tree(params), port_model_cfg(cfg),
                                    device="cpu")
    sess = tlo.build_session(model, port_cfg(jax_scfg),
                             state_dtype=torch.float32, device="cpu",
                             batch=batch)
    return t_ad.SessionAdapter(sess, HashTok(), stop_token_ids=[0])


def protocols(p, adapter, d):
    """Every protocol of one package over `adapter`: {name: output}."""
    anno = d / "anno.json"
    anno.write_text(json.dumps(ANNO))
    stream_anno = d / "stream.json"
    stream_anno.write_text(json.dumps(STREAM_ANNO))
    out = {}
    for name, path in (("mlvu", anno), ("videomme", anno),
                       ("rvs_ego", stream_anno)):
        rows, _ = p.run.run_eval(name, adapter, str(d / name),
                                 anno_path=str(path), rank=0, world=1,
                                 frame_loader=loader)
        out[name] = rows
    sb = json.loads(json.dumps(SB_DATA))
    out["streamingbench"] = p.sb.StreamingBenchEval(
        adapter, "m", sample_fps=1.0, frame_loader=sb_loader).run(
            sb, str(d / "sb.json"))
    out["ovobench"] = p.ovo.OVOBenchEval(
        adapter, frame_loader=ovo_loader).eval(OVO_ANNO, str(d / "ovo.json"))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """stc_tpu's protocol outputs and a port session's, on the same params
    (computed once)."""
    cfg = jlo.LlavaOVConfig.tiny()
    params = jlo.init_random_params(cfg, jax.random.key(31))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # open-ended answers decode 8 tokens, as in test_eval_batched
        mp.setattr(j_sol.BaseVQA, "open_max_new", 8)
        mp.setattr(t_sol.BaseVQA, "open_max_new", 8)
        ja = jax_adapter(params, cfg)
        out["jax"] = protocols(PKGS["jax"], ja,
                               tmp_path_factory.mktemp("jax"))
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            out["port"] = protocols(
                PKGS["port"], port_adapter(params, cfg, ja.session.scfg),
                tmp_path_factory.mktemp("port"))
        finally:
            torch.set_num_threads(n)
    return out


def no_error_rows(rows):
    assert rows and not any("error" in r for r in rows), rows


@pytest.mark.parametrize("name", ["mlvu", "rvs_ego"])
def test_run_eval_rows_equal_jax(runs, name):
    rows = runs["port"][name]
    no_error_rows(rows)
    want = ANNO if name == "mlvu" else STREAM_ANNO
    assert len(rows) == sum(len(s["conversations"]) for s in want)
    assert rows == runs["jax"][name]


def test_run_eval_videomme_rows_equal_jax_but_time(runs):
    """VideoMME rows carry the encode time (a host time: left out) and the
    KV memory (equal)."""
    def strip(rows):
        return [{k: v for k, v in r.items() if k != "encode_time_s"}
                for r in rows]

    rows = runs["port"]["videomme"]
    no_error_rows(rows)
    assert all(r["encode_time_s"] >= 0 and r["kv_memory_gb"] >= 0
               for r in rows)
    assert strip(rows) == strip(runs["jax"]["videomme"])
    # the offline protocol's rows, plus the two fields
    assert strip(rows) == [dict(r, kv_memory_gb=s["kv_memory_gb"])
                           for r, s in zip(runs["port"]["mlvu"], rows)]


def test_streamingbench_on_sessions_equals_jax(runs):
    out = runs["port"]["streamingbench"]
    answers = [q["m"] for e in out for q in e["questions"]]
    assert len(answers) == 3 and all(isinstance(a, str) for a in answers)
    assert out == runs["jax"]["streamingbench"]


def test_ovobench_on_sessions_equals_jax(runs):
    out = runs["port"]["ovobench"]
    responses = ([r["response"] for g in ("backward", "realtime")
                  for r in out[g]]
                 + [i["response"] for r in out["forward"]
                    for i in r["test_info"]])
    assert len(responses) == 4 and None not in responses
    assert out == runs["jax"]["ovobench"]
