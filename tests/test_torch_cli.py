"""The port's eval CLI (stc_tpu_torch/cli/run_eval.py) with its launcher
and sweep, and the repair of the LLaVA-OV loader's `batch`, on the CPU.

- The loader: a tiny HF LLaVA-OV directory (written by transformers, as in
  test_torch_convert.py) loaded with batch=2 by both packages, fed the
  same two ragged streams: answer ids and blocks equal, pages to F32_TOL.
- The CLI against stc_tpu's harness: the same directory with a Qwen2-style
  tokenizer.json, an MLVU-format annotation over .npy videos; the port's
  `main([... "--device", "cpu"])` against stc_tpu's `run_eval` over its
  `load_llava_ov_7b(dir, scfg=<the CLI's config>)` and
  `AutoTokenizer.from_pretrained(dir)`: rows and merged_score.json equal,
  plainly, with --stream_batch 2 and with --spec_decode 2.
- The knobs against `SessionConfig.from_env` under the variables
  stc_tpu's CLI sets, field by field (n_init aside: the port takes the
  tokenizer's init prompt length).
- Sharding by RANK / WORLD_SIZE, the CLIP backbones' refusal of knobs, the
  card default, the launcher over two shards and a 1 x 2 sweep."""

import dataclasses
import importlib.util
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")
pytest.importorskip("safetensors")

import jax
import jax.numpy as jnp

from stc_tpu import config as jc
from stc_tpu.eval import runner as j_run
from stc_tpu.kvcache.engine import score_blocks
from stc_tpu.models import llava_onevision as jlo
from stc_tpu.models import qwen2 as jq
from stc_tpu.runtime import adapter as j_ad
from stc_tpu_torch.cli import run_eval as cli
from stc_tpu_torch.models import llava_onevision as tlo
from test_torch_common import F32_TOL, one_thread, port_cfg  # noqa: F401
from test_torch_convert import SCFG, _hf_dir
from test_torch_tokenizer import write_qwen2_dir

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 320          # the tokenizer's ids run to 303
# the CLI's knobs for the tiny model (its SigLIP leaves 4 tokens a frame)
KNOBS = ["--token_per_frame", "3", "--n_local", "128", "--retrieve_size", "4"]
PATTERN = [(True, True), (True, False), (False, True), (True, True),
           (True, False)]


def _jax_cli():
    """stc_tpu's scripts/run_eval.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "stc_tpu_run_eval_cli", ROOT / "scripts" / "run_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_cfg(pc):
    """stc_tpu's copy of a port config dataclass (its other fields at their
    defaults)."""
    kw = {}
    for f in dataclasses.fields(pc):
        v = getattr(pc, f.name)
        kw[f.name] = _jax_cfg(v) if dataclasses.is_dataclass(v) else v
    return getattr(jc, type(pc).__name__)(**kw)


def _fields(cfg, prefix=""):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def _mc(q, choices, answer):
    return {"question": q, "choices": choices, "answer": answer}


def write_anno(root):
    """An MLVU-format annotation over three .npy videos under root (five
    questions: four multiple-choice, one open); returns its path."""
    rng = np.random.default_rng(3)
    anno = []
    for i, n in enumerate((8, 12, 6)):
        vid = root / f"v{i}.npy"
        np.save(vid, rng.integers(0, 256, (n, 56, 56, 3), dtype=np.uint8))
        convs = [_mc(f"what is shown {i}", ["a cup", "a dog", "a car"],
                     "a dog")]
        if i == 0:
            convs += [{"question": "describe it", "answer": "a room"},
                      _mc("which side", ["left", "right"], "left")]
        anno.append({"video_id": f"v{i}", "video_path": str(vid),
                     "duration": n, "conversations": convs})
    a_path = root / "anno.json"
    a_path.write_text(json.dumps(anno))
    return str(a_path)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A tiny LLaVA-OV HF directory written by transformers, with
    Qwen2-style tokenizer files, and write_anno's annotation."""
    root = tmp_path_factory.mktemp("cli")
    path = _hf_dir(root, False, "old", vocab=VOCAB)
    write_qwen2_dir(path)
    return {"root": root, "path": str(path), "anno": write_anno(root),
            "rows": {}}


# --------------------------------------------------------------------------
# the loader's batch
# --------------------------------------------------------------------------

def _jax_blocks(sess, question):
    """Per layer, per stream, the blocks stc_tpu's retrieval forward picks
    over the session's own state (test_torch_session's helper at B
    streams, under one jit)."""
    cfg, rekv, B = sess.mcfg, sess.rekv, sess.batch
    ids, lens = sess._pad_ids([question] * B)
    T = ids.shape[1]
    q_valid = jnp.arange(T)[None, :] < jnp.asarray(lens)[:, None]
    body = jq.qa_retrieve_layer_body(cfg, rekv, q_valid, None, T)
    dkvs = jq.init_decode_state(cfg, rekv, B, sess.kvs.init_k.dtype)

    @jax.jit
    def run(params, kvs, ids):
        h = jq.embed_tokens(params, ids)
        out = []
        for l in range(cfg.num_layers):
            lp, kv, dkv = (jax.tree.map(lambda x: x[l], t)
                           for t in (params["layers"], kvs, dkvs))
            q, _, _ = jq._qkv(lp, jq.rms_norm(h, lp["ln1"], cfg.rms_eps),
                              cfg)
            out.append(score_blocks(kv, q, rekv, q_valid))
            h, _ = body(h, (lp, kv, dkv))
        return out

    return [[np.asarray(a)[b][np.asarray(e)[b]].tolist() for b in range(B)]
            for a, e in run(sess.params, sess.kvs, jnp.asarray(ids))]


def test_llava_ov_loader_takes_batch(ckpt):
    """load_llava_ov_7b(..., batch=2) in both packages over one directory:
    the same two ragged streams give equal counters, pages (F32_TOL),
    answers and blocks."""
    t, _ = tlo.load_llava_ov_7b(ckpt["path"], scfg=port_cfg(SCFG),
                                dtype=torch.float32, device="cpu", batch=2)
    j, _ = jlo.load_llava_ov_7b(ckpt["path"], scfg=SCFG, dtype=jnp.float32,
                                batch=2)
    assert t.batch == j.batch == 2
    for s in (t, j):
        s.encode_init_prompt([1, 2, 3, 4])
    rng = np.random.default_rng(5)
    for act in PATTERN:
        frames = rng.integers(0, 256, (2, 1, 56, 56, 3), dtype=np.uint8)
        t.encode_video(frames, active=act)
        j.encode_video(frames, active=act)
    nb = [sum(a[b] for a in PATTERN) for b in range(2)]
    assert t.kvs.num_blocks[0].tolist() == nb
    np.testing.assert_array_equal(np.asarray(j.kvs.num_blocks)[0], nb)
    np.testing.assert_allclose(t.kvs.block_k.numpy(),
                               np.asarray(j.kvs.block_k), **F32_TOL)
    np.testing.assert_allclose(t.kvs.block_v.numpy(),
                               np.asarray(j.kvs.block_v), **F32_TOL)
    q, p = [7, 8, 9], [7, 8, 9, 10]
    want_blocks = _jax_blocks(j, q)
    ans = t.question_answering(q, p, [0], max_new_tokens=4, all_streams=True)
    assert ans == j.question_answering(q, p, [0], max_new_tokens=4,
                                       all_streams=True)
    assert t.last_retrieved_indices == want_blocks


# --------------------------------------------------------------------------
# the CLI against stc_tpu's run_eval
# --------------------------------------------------------------------------

def _argv(ckpt, save_dir, *extra):
    return (["--dataset", "mlvu", "--model_path", ckpt["path"],
             "--anno_path", ckpt["anno"], "--save_dir", str(save_dir)]
            + KNOBS + list(extra))


def _merged(save_dir):
    with open(os.path.join(save_dir, "merged_score.json")) as f:
        out = json.load(f)
    out.pop("ts")
    return out


def _port_run(ckpt, name, *extra):
    """The port CLI's rows (cached per setting) and merged_score.json."""
    if name not in ckpt["rows"]:
        save = ckpt["root"] / f"port_{name}"
        out = cli.main(_argv(ckpt, save, *extra, "--device", "cpu"))
        assert out["n_rows"] == 5 and "rows" not in out
        with open(save / "results_rank0.json") as f:
            ckpt["rows"][name] = (json.load(f), _merged(save))
    return ckpt["rows"][name]


@pytest.mark.parametrize("name,extra", [
    ("plain", ()), ("stream_batch", ("--stream_batch", "2")),
    ("spec_decode", ("--spec_decode", "2"))])
def test_cli_rows_equal_stc_tpu_harness(ckpt, name, extra, monkeypatch):
    """stc_tpu's side runs as its CLI would: apply_knobs sets the variables
    (its runner tags the rows with retrieve_size from them)."""
    from transformers import AutoTokenizer
    rows, merged = _port_run(ckpt, name, *extra)
    assert not [r for r in rows if "error" in r]
    argv = _argv(ckpt, "unused", *extra)
    args = cli.parse_args(argv)
    monkeypatch.setattr(sys, "argv", ["run_eval.py"] + argv)
    monkeypatch.setattr(os, "environ", {k: v for k, v in os.environ.items()
                                        if not k.startswith("STC_")})
    j_cli = _jax_cli()
    j_cli.apply_knobs(j_cli.parse_args())
    tok = AutoTokenizer.from_pretrained(ckpt["path"])
    n_init = len(tok(j_ad.ChatTemplate.init_prompt).input_ids)
    scfg = _jax_cfg(cli.session_config(args, n_init))
    sess, _ = jlo.load_llava_ov_7b(ckpt["path"], scfg=scfg,
                                   dtype=jnp.float32,
                                   batch=args.stream_batch)
    save = ckpt["root"] / f"jax_{name}"
    want, _ = j_run.run_eval(
        "mlvu", j_ad.SessionAdapter(sess, tok), str(save),
        anno_path=ckpt["anno"], rank=0, world=1,
        stream_batch=args.stream_batch)
    j_run.merge_and_score(str(save), "mlvu")
    assert rows == want
    assert merged == _merged(save)
    if name == "stream_batch":    # rows equal to the sequential solver's
        assert rows == _port_run(ckpt, "plain")[0]


def test_cli_sessions_run_with_the_arguments(ckpt):
    args = cli.parse_args(_argv(ckpt, "unused", "--stream_batch", "2",
                                "--spec_decode", "2", "--device", "cpu"))
    model = cli.load_model(args, torch.device("cpu"))
    scfg = model.session.scfg
    assert model.session.batch == 2
    assert scfg.rekv.spec_decode_draft == 2
    assert scfg.rekv.n_init == model.init_prompt_len
    assert model.stop_token_ids == [model.tokenizer.convert_tokens_to_ids(
        "<|im_end|>")]


@pytest.mark.parametrize("argv", [
    [],
    ["--n_local", "2000", "--retrieve_size", "16", "--retrieve_chunk_size",
     "2", "--cache_strategy", "none", "--update_token_ratio", "0.5",
     "--token_per_frame", "30", "--prune_strategy", "stc", "--ingest",
     "yuv420", "--spec_decode", "3"],
    ["--prune_strategy", "full_tokens", "--token_per_frame", "30"],
    ["--prune_strategy", "none", "--cache_strategy", "cacher"],
], ids=["defaults", "every_knob", "full_tokens", "pruner_off"])
def test_knobs_equal_from_env(monkeypatch, argv):
    """stc_tpu's apply_knobs sets its variables; SessionConfig.from_env then
    equals the port CLI's config field by field, n_init aside."""
    j_cli = _jax_cli()
    base = ["--dataset", "mlvu", "--model_path", "unused"]
    monkeypatch.setattr(sys, "argv", ["run_eval.py"] + base + argv)
    monkeypatch.setattr(os, "environ", {k: v for k, v in os.environ.items()
                                        if not k.startswith("STC_")})
    j_cli.apply_knobs(j_cli.parse_args())
    want = _fields(jc.SessionConfig.from_env())
    got = _fields(cli.session_config(cli.parse_args(base + argv), n_init=20))
    assert got.pop("rekv.n_init") == 20 and want.pop("rekv.n_init") == 14
    assert want.pop("rekv.decode_attn_backend") == "jnp"
    assert got == want


def test_clip_backbone_refuses_knobs(ckpt, tmp_path):
    with pytest.raises(ValueError, match="--n_local: longva_7b"):
        cli.main(["--dataset", "mlvu", "--model", "longva_7b",
                  "--model_path", ckpt["path"], "--save_dir", str(tmp_path),
                  "--n_local", "100", "--device", "cpu"])


def test_cli_defaults_to_the_card(ckpt, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.parse_args(["--dataset", "mlvu"]).device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(_argv(ckpt, tmp_path))
    assert not (tmp_path / "results_rank0.json").exists()
