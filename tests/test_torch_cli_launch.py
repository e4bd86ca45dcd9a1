"""The port's eval CLI in several processes, on the CPU: RANK /
WORLD_SIZE sharding as stc_tpu's runner shards, the data-parallel launcher
(stc_tpu_torch/cli/eval_offline.sh) over two shards, and the
retrieve_size x chunk_size sweep (stc_tpu_torch/cli/sweep_videomme.py)
over a 1 x 2 grid.  The checkpoint is a tiny LLaVA-OV written by
chip_smoke.py's HF writer (no transformers), with Qwen2-style tokenizer
files; its rows are the port CLI's own (test_torch_cli.py holds them to
stc_tpu's harness)."""

import importlib.util
import json
import os
import pathlib
import subprocess

import pytest
import torch

pytest.importorskip("tokenizers")

from stc_tpu.eval import runner as j_run
from stc_tpu_torch.cli import run_eval as cli
from stc_tpu_torch.cli import sweep_videomme
from stc_tpu_torch.models import llava_onevision as lo
from stc_tpu_torch.models import qwen2 as qw
from stc_tpu_torch.models import siglip as sg
from test_torch_cli import KNOBS, VOCAB, _argv, _merged, write_anno
from test_torch_common import one_thread  # noqa: F401
from test_torch_tokenizer import write_qwen2_dir

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAUNCHER = ROOT / "stc_tpu_torch" / "cli" / "eval_offline.sh"


def _key(r):
    return (r["video_id"], r["question"])


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """{path, anno, rows, merged}: the world-1 run of the port CLI."""
    root = tmp_path_factory.mktemp("launch")
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = lo.LlavaOVConfig(vision=sg.SiglipConfig.tiny(),
                           text=qw.Qwen2Config.tiny(vocab=VOCAB))
    model = lo.LlavaOV(cfg, dtype=torch.float32, device="cpu")
    model.init_random_params(torch.Generator().manual_seed(4))
    path = root / "ckpt"
    path.mkdir()
    cs.write_hf_checkpoint(model, str(path))
    write_qwen2_dir(path)
    out = {"path": str(path), "anno": write_anno(root)}
    save = root / "world1"
    cli.main(_argv(out, save, "--device", "cpu"))
    with open(save / "results_rank0.json") as f:
        out["rows"] = json.load(f)
    out["merged"] = _merged(save)
    assert len(out["rows"]) == 5 and not [r for r in out["rows"]
                                          if "error" in r]
    return out


def test_rank_and_world_split_as_stc_tpu(ckpt, tmp_path, monkeypatch):
    """RANK / WORLD_SIZE pick anno[rank::world]; rank 1 writes its rank
    file and merges nothing, rank 0 then merges both into the world-1
    rows."""
    rows = ckpt["rows"]
    for rank in (1, 0):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "2")
        out = cli.main(_argv(ckpt, tmp_path, "--device", "cpu"))
        assert (out is None) == (rank == 1)
        with open(tmp_path / f"results_rank{rank}.json") as f:
            got = json.load(f)
        ids = [s["video_id"] for s in j_run.load_and_split_anno(
            ckpt["anno"], rank, 2)]
        assert [r for r in rows if r["video_id"] in ids] == got
    assert sorted(_merged(tmp_path)["rows"], key=_key) == sorted(rows,
                                                                 key=_key)



def _env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("STC_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return env


def test_launcher_merges_two_shards(ckpt, tmp_path):
    rows, merged = ckpt["rows"], ckpt["merged"]
    env = dict(_env(), NUM_PROCESSES="2", SAVE_DIR=str(tmp_path))
    out = subprocess.run(
        ["bash", str(LAUNCHER),
         "mlvu", "llava_ov_7b", ckpt["path"], "--anno_path", ckpt["anno"]]
        + KNOBS + ["--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert sorted(os.listdir(tmp_path)) == [
        "merged_score.json", "results_rank0.json", "results_rank1.json"]
    got = _merged(tmp_path)
    assert sorted(got.pop("rows"), key=_key) == sorted(rows, key=_key)
    assert got == {k: v for k, v in merged.items() if k != "rows"}
    printed = json.loads(out.stdout.strip().splitlines()[-1])
    assert printed.pop("ts") > 0 and printed == got


def test_launcher_fails_when_a_shard_fails(ckpt, tmp_path):
    env = dict(_env(), NUM_PROCESSES="2", SAVE_DIR=str(tmp_path))
    out = subprocess.run(
        ["bash", str(LAUNCHER),
         "mlvu", "llava_ov_7b", str(tmp_path / "missing"), "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 1
    assert "2 of 2 shards failed" in out.stderr


def test_sweep_writes_pivot(ckpt, tmp_path, monkeypatch):
    for k, v in _env().items():
        monkeypatch.setenv(k, v)
    out = sweep_videomme.main(
        ["--dataset", "mlvu", "--model_path", ckpt["path"], "--save_dir",
         str(tmp_path), "--retrieve_sizes", "2", "--chunk_sizes", "1", "2",
         "--anno_path", ckpt["anno"], "--token_per_frame", "3",
         "--n_local", "128", "--device", "cpu"])
    with open(tmp_path / "sweep.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(out))
    assert out["n_rows"] == 10 and sorted(out["pivot"]) == [1, 2]
    assert all(list(v) == [2] for v in out["pivot"].values())
    with open(tmp_path / "rs2_cs2" / "merged_score.json") as f:
        rows = json.load(f)["rows"]
    assert {(r["retrieve_size"], r["chunk_size"]) for r in rows} == {(2, 2)}
