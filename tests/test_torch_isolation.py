"""The port stands alone: stc_tpu_torch (and chip_smoke.py) import neither
JAX nor any module of the JAX package stc_tpu, nor safetensors,
transformers or ml_dtypes (the card machine has none of them); its own
serving engine and checkpoints included."""

import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "stc_tpu_torch"
# word match: `stc_tpu` must not be followed by a word character, so the
# port's own `stc_tpu_torch` passes
NAMES = r"(?:jax|stc_tpu|safetensors|transformers|ml_dtypes)"
FORBIDDEN = re.compile(
    r"^\s*(?:import\s+[\w., ]*\b" + NAMES + r"\b(?!\w)"
    r"|from\s+" + NAMES + r"\b(?![\w]))", re.M)
BLOCKED = ("jax", "stc_tpu", "safetensors", "transformers", "ml_dtypes")


def test_sources_import_no_jax_and_no_stc_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in (("kvcache", "host_tier.py"), ("runtime", "serving.py"),
              ("utils", "checkpoint.py"), ("models", "clip.py"),
              ("models", "longva.py"), ("models", "video_llava.py"),
              ("models", "flash_vstream.py")):
        assert PKG.joinpath(*f) in files, f
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
           for f in files for m in FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad
    assert FORBIDDEN.search("from stc_tpu.config import ReKVConfig")
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from safetensors.torch import load_file")
    assert FORBIDDEN.search("    import transformers")
    assert FORBIDDEN.search("import numpy, ml_dtypes")
    assert not FORBIDDEN.search("from stc_tpu_torch.ops import rope")


def test_ablation_and_frame_sources_name_no_stc_tpu():
    """The modules that copy or rewrite parts of stc_tpu (the scoring and
    experiments libraries, the frame library's binding and C++ source, the
    host pipeline) do not name the JAX package anywhere, comments
    included."""
    name = re.compile(r"\bstc_tpu\b(?!_torch)")
    files = [PKG / "native.py", PKG / "compress" / "scoring.py",
             PKG / "compress" / "experiments.py",
             PKG / "runtime" / "pipeline.py",
             PKG / "csrc" / "frameproc.cpp"]
    bad = [f"{f.relative_to(ROOT)}:{i + 1}" for f in files
           for i, line in enumerate(f.read_text().splitlines())
           if name.search(line)]
    assert not bad, bad
    assert name.search("from stc_tpu import native")
    assert not name.search("from stc_tpu_torch import native")


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
