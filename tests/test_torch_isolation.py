"""The port stands alone: stc_tpu_torch (and chip_smoke.py) import neither
JAX nor any module of the JAX package stc_tpu, nor safetensors,
transformers, tokenizers, regex or ml_dtypes (the card machine has none of
them); its own serving engine, checkpoints, tokenizer reader and
command-line entry points included."""

import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "stc_tpu_torch"
# word match: `stc_tpu` must not be followed by a word character, so the
# port's own `stc_tpu_torch` passes
NAMES = r"(?:jax|stc_tpu|safetensors|transformers|tokenizers|regex|ml_dtypes)"
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+[\w., ]*\b" + NAMES + r"\b(?!\w)"
    r"|from\s+" + NAMES + r"\b(?![\w]))", re.M)
BLOCKED = ("jax", "stc_tpu", "safetensors", "transformers", "tokenizers",
           "regex", "ml_dtypes")
PARALLEL = tuple(("parallel", f"{m}.py") for m in (
    "__init__", "mesh", "sharding", "pipeline", "dryrun"))
EVAL = tuple(("eval", f"{m}.py") for m in (
    "__init__", "datasets", "scorers", "reports", "solvers",
    "streamingbench", "ovobench", "runner"))
CLI = tuple(("cli", f"{m}.py") for m in (
    "__init__", "run_eval", "sweep_videomme", "stream_demo", "serve_demo"))


def test_sources_import_no_jax_and_no_stc_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in ((("kvcache", "host_tier.py"), ("runtime", "serving.py"),
              ("utils", "checkpoint.py"), ("models", "clip.py"),
              ("models", "longva.py"), ("models", "video_llava.py"),
              ("models", "flash_vstream.py"), ("utils", "metrics.py"),
              ("runtime", "adapter.py"), ("runtime", "tokenizer.py"))
              + EVAL + PARALLEL + CLI):
        assert PKG.joinpath(*f) in files, f
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    assert FORBIDDEN.search("from stc_tpu.config import ReKVConfig")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from safetensors.torch import load_file")
    assert FORBIDDEN.search("    import transformers")
    assert FORBIDDEN.search("import numpy, ml_dtypes")
    assert FORBIDDEN.search("from tokenizers import Tokenizer")
    assert FORBIDDEN.search("import regex as re")
    assert not FORBIDDEN.search("import re")
    assert not FORBIDDEN.search("from stc_tpu_torch.ops import rope")


def test_ablation_and_frame_sources_name_no_stc_tpu():
    """The modules that copy or rewrite parts of stc_tpu (the scoring and
    experiments libraries, the frame library's binding and C++ source, the
    host pipeline, the eval harnesses, the session adapter and the
    metrics) do not name the JAX package anywhere, comments included."""
    name = re.compile(r"\bstc_tpu\b(?!_torch)")
    files = [PKG / "native.py", PKG / "compress" / "scoring.py",
             PKG / "compress" / "experiments.py",
             PKG / "runtime" / "pipeline.py",
             PKG / "csrc" / "frameproc.cpp",
             PKG / "runtime" / "adapter.py",
             PKG / "utils" / "metrics.py"] + [PKG.joinpath(*f) for f in EVAL]
    bad = [f"{f.relative_to(ROOT)}:{i + 1}" for f in files
           for i, line in enumerate(f.read_text().splitlines())
           if name.search(line)]
    assert not bad, bad
    assert name.search("from stc_tpu import native")
    assert not name.search("from stc_tpu_torch import native")


def test_importing_the_eval_package_loads_no_cv2_and_no_jax():
    """The eval harnesses decode video with decord or OpenCV only inside
    the function that reads a file: a fresh interpreter imports
    stc_tpu_torch.eval, its modules and the adapter, and neither cv2 nor
    decord nor any blocked package is loaded."""
    code = f"BLOCKED = {BLOCKED!r}\n" + textwrap.dedent("""
        import sys
        import stc_tpu_torch.eval
        from stc_tpu_torch.eval import (datasets, ovobench, reports, runner,
                                        scorers, solvers, streamingbench)
        from stc_tpu_torch.runtime import adapter
        from stc_tpu_torch.utils import metrics
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in BLOCKED + ("cv2", "decord",
                                                   "matplotlib", "openai")]
        assert not leaked, leaked
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "OK"


def test_importing_the_parallel_package_loads_no_jax():
    """The parallel layouts (meshes, sharding, the pipeline relay, the dry
    run and its rank launcher) and the parallel tests' rank-side worker
    import torch and the port only: a fresh interpreter imports them and
    no blocked package is loaded."""
    code = f"BLOCKED = {BLOCKED!r}\n" + textwrap.dedent("""
        import sys
        sys.path.insert(0, "tests")
        from stc_tpu_torch.parallel import dryrun, mesh, pipeline, sharding
        import torch_parallel_worker
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "OK"


def test_importing_and_running_the_port_loads_no_jax():
    """A fresh interpreter imports every module of the port, runs a tiny
    session on the CPU and reloads its model from an HF checkpoint
    directory; none of jax, stc_tpu, safetensors, transformers or
    ml_dtypes ends up in sys.modules."""
    code = f"BLOCKED = {BLOCKED!r}\n" + textwrap.dedent("""
        import importlib, pkgutil, sys
        import numpy as np, torch
        import dataclasses
        import stc_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            stc_tpu_torch.__path__, "stc_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        from stc_tpu_torch.config import (ReKVConfig, SessionConfig,
                                          PrunerConfig, CacherConfig)
        from stc_tpu_torch.models import llava_onevision as lo
        cfg = lo.LlavaOVConfig.tiny()
        gen = torch.Generator().manual_seed(0)
        model = lo.LlavaOV(cfg, dtype=torch.float32,
                           device="cpu").init_random_params(gen)
        scfg = SessionConfig(
            rekv=ReKVConfig(n_init=4, n_local=128, block_size=3,
                            exc_block_size=3, topk=4, max_blocks=64,
                            max_prompt_tokens=32, max_new_tokens=8),
            cacher=CacherConfig(update_token_ratio=0.5),
            pruner=PrunerConfig(token_per_frame=3))
        sess = lo.build_session(model, scfg, state_dtype=torch.float32,
                                device="cpu")
        sess.encode_init_prompt([1, 2, 3, 4])
        frames = np.random.default_rng(0).integers(
            0, 256, (3, 56, 56, 3), dtype=np.uint8)
        sess.encode_video(frames)
        out = sess.question_answering([5, 6], [5, 6, 7], [0],
                                      max_new_tokens=4)
        assert 1 <= len(out) <= 4, out
        # the ablation settings and yuv420 ingest with the host frame
        # library and the prefetcher
        from stc_tpu_torch.runtime.pipeline import stream_encode
        scfg_ab = dataclasses.replace(
            scfg, ingest_format="yuv420",
            cacher=dataclasses.replace(scfg.cacher, sim_source="value"),
            rekv=dataclasses.replace(
                scfg.rekv, retrieval_scorer="aks",
                window_kv_compression="select_top_half",
                retrieved_kv_compression="filter_tokens_random"))
        sess_ab = lo.build_session(model, scfg_ab,
                                   state_dtype=torch.float32, device="cpu")
        sess_ab.encode_init_prompt([1, 2, 3, 4])
        stream_encode(sess_ab, frames)
        out = sess_ab.question_answering([5, 6], [5, 6, 7], [0],
                                         max_new_tokens=4)
        assert 1 <= len(out) <= 4, out
        # two streams past a 24-page store: the host tier evicts, and a
        # question over the evicted pages is answered
        assert "stc_tpu_torch.kvcache.host_tier" in mods
        import dataclasses
        scfg2 = dataclasses.replace(scfg, rekv=dataclasses.replace(
            scfg.rekv, n_local=24, max_blocks=24))
        sess2 = lo.build_session(model, scfg2, state_dtype=torch.float32,
                                 device="cpu", batch=2)
        sess2.encode_init_prompt([1, 2, 3, 4])
        sess2.encode_video(np.random.default_rng(1).integers(
            0, 256, (2, 30, 56, 56, 3), dtype=np.uint8))
        assert sess2._evicted_pages > 0
        out = sess2.question_answering([5, 6], [5, 6, 7], [0],
                                       max_new_tokens=4,
                                       retrieved_indices=[0, 1],
                                       all_streams=True)
        assert sess2.host_store.fetch_count > 0 and len(out) == 2, out
        # a serving engine over a speculative 2-stream session, and a
        # stream checkpoint restored into its recycled slot
        import tempfile
        assert "stc_tpu_torch.runtime.serving" in mods
        assert "stc_tpu_torch.utils.checkpoint" in mods
        from stc_tpu_torch.runtime.serving import ServingEngine
        from stc_tpu_torch.utils import checkpoint
        scfg3 = dataclasses.replace(scfg, rekv=dataclasses.replace(
            scfg.rekv, spec_decode_draft=2))
        sess3 = lo.build_session(model, scfg3, state_dtype=torch.float32,
                                 device="cpu", batch=2)
        sess3.encode_init_prompt([1, 2, 3, 4])
        eng = ServingEngine(sess3, [0], max_new_tokens=4)
        px = np.random.default_rng(2).integers(0, 256, (1, 56, 56, 3),
                                               dtype=np.uint8)
        eng.submit_chunk(0, px)
        eng.submit_chunk(1, px)
        rid = eng.submit_question(0, [5, 6], [5, 6, 7])
        res = eng.run()
        assert sess3.last_serve_fused and 1 <= len(res[rid]["tokens"]) <= 4
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_stream_state(sess3, 0, d + "/s.npz")
            eng.retire(1)
            checkpoint.load_stream_state(sess3, eng.admit(), d + "/s.npz")
        assert sess3._stream_blocks.tolist() == [1, 1]
        # the CLIP backbones: a tiny LongVA session (full and MLP-skip
        # chunks) and the registry of all four loaders
        from stc_tpu_torch.models import MODEL_REGISTRY
        from stc_tpu_torch.models import longva as lv
        lcfg = lv.LongVAConfig.tiny()
        lmodel = lv.ClipVLM(lcfg, dtype=torch.float32,
                           device="cpu").init_random_params(gen)
        lsess = lv.build_session(lmodel, dataclasses.replace(
            scfg, rekv=dataclasses.replace(scfg.rekv, block_size=4,
                                           exc_block_size=4),
            pruner=PrunerConfig(strategy="none", token_per_frame=4)),
            state_dtype=torch.float32, device="cpu")
        lsess.encode_init_prompt([1, 2, 3, 4])
        lsess.encode_video(frames)
        assert int(lsess._vstate.tokens_skipped[0]) > 0
        assert {"llava_ov_7b", "longva_7b", "video_llava_7b",
                "flash_vstream_7b"} <= set(MODEL_REGISTRY)
        # an HF checkpoint written by chip_smoke.py's writer loads back
        # through the port's own shard reader
        sys.path.insert(0, ".")
        import chip_smoke
        chip_smoke.tie_head_and_round_vision(model)
        with torch.no_grad():  # the float32 LM too holds bf16 values
            for prm in model.text.parameters():
                prm.copy_(prm.to(torch.bfloat16))
        with tempfile.TemporaryDirectory() as d:
            chip_smoke.write_hf_checkpoint(model, d)
            loaded, _ = lo.load_llava_ov_7b(d, scfg, dtype=torch.float32,
                                            device="cpu")
        src, got = model.state_dict(), loaded.model.state_dict()
        assert all(torch.equal(src[k], got[k]) for k in src)
        # the eval harness over a bare session with the frame encoder,
        # through the session adapter, and a chunk's FLOPs count
        import json
        from stc_tpu_torch.eval.runner import run_eval
        from stc_tpu_torch.runtime.adapter import SessionAdapter
        from stc_tpu_torch.runtime.session import StreamingSession

        class Tok:
            def __call__(self, text):
                return [1 + b % 50 for b in text.encode()][:4]

            def decode(self, ids, **kw):
                return ",".join(map(str, ids))

        bare = StreamingSession(model.text, scfg, state_dtype=torch.float32,
                                frame_encoder=lo.FrameEncoder(model, scfg,
                                                              device="cpu"))
        ad = SessionAdapter(bare, Tok(), stop_token_ids=[0])
        assert ad.init_prompt_len == scfg.rekv.n_init
        with tempfile.TemporaryDirectory() as d:
            with open(d + "/a.json", "w") as f:
                json.dump([{"video_id": "v", "video_path": "v",
                            "conversations": [{"question": "q", "choices":
                                               ["a", "b"], "answer": "b"}]}],
                          f)
            rows, _ = run_eval("mlvu", ad, d, anno_path=d + "/a.json",
                               frame_loader=lambda p, fps: frames)
        assert len(rows) == 1 and "error" not in rows[0], rows
        assert sess.estimate_chunk_flops() > sess.estimate_chunk_flops(True)
        leaked = [m for m in sys.modules
                  if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print("OK", len(mods))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n_mods = int(res.stdout.split()[-1])
    assert n_mods >= 15, res.stdout


def test_the_cli_and_the_tokenizer_load_no_jax(tmp_path):
    """A fresh interpreter reads a Qwen2-style tokenizer.json with the
    port's reader, runs `python -m stc_tpu_torch.cli.run_eval`'s main on
    the CPU over a tiny checkpoint (chip_smoke.py's writer) and an .npy
    video, then the stream demo; none of jax, stc_tpu, transformers,
    tokenizers or regex is loaded.  The tokenizer file is written here,
    by the tokenizers library, outside that interpreter."""
    from test_torch_tokenizer import write_qwen2_dir
    write_qwen2_dir(tmp_path / "ckpt")
    code = f"BLOCKED = {BLOCKED!r}\nD = {str(tmp_path)!r}\n" + \
        textwrap.dedent("""
        import json, sys
        import numpy as np, torch
        sys.path.insert(0, ".")
        import chip_smoke
        from stc_tpu_torch.cli import run_eval, stream_demo
        from stc_tpu_torch.models import llava_onevision as lo
        from stc_tpu_torch.models import qwen2 as qw
        from stc_tpu_torch.models import siglip as sg
        from stc_tpu_torch.runtime.tokenizer import load_tokenizer
        tok = load_tokenizer(D + "/ckpt")
        text = "<|im_start|>system \\nYou are a helpful assistant."
        assert tok.decode(tok(text)) == text
        cfg = lo.LlavaOVConfig(vision=sg.SiglipConfig.tiny(),
                               text=qw.Qwen2Config.tiny(vocab=320))
        model = lo.LlavaOV(cfg, dtype=torch.float32, device="cpu")
        model.init_random_params(torch.Generator().manual_seed(0))
        chip_smoke.write_hf_checkpoint(model, D + "/ckpt")
        np.save(D + "/v.npy", np.zeros((6, 56, 56, 3), np.uint8))
        with open(D + "/a.json", "w") as f:
            json.dump([{"video_id": "v", "video_path": D + "/v.npy",
                        "conversations": [{"question": "q", "choices":
                                           ["a", "b"], "answer": "b"}]}], f)
        out = run_eval.main(["--dataset", "mlvu", "--model_path",
                             D + "/ckpt", "--anno_path", D + "/a.json",
                             "--save_dir", D + "/out", "--token_per_frame",
                             "3", "--n_local", "128", "--retrieve_size", "4",
                             "--device", "cpu"])
        assert out["n_rows"] == 1, out
        stream_demo.main(["--frames", "4", "--question_every", "4",
                          "--device", "cpu"])
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-1] == "OK"
