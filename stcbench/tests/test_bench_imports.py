"""What a run loads: no JAX and no JAX package (top-level names compared
whole, so stc_tpu_torch is not taken for stc_tpu); the reference loads
nothing of the program either."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "stc_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    names = loaded(
        "import importlib.util, sys\n"
        "sp = importlib.util.spec_from_file_location('run', "
        "'stcbench/run.py')\n"
        "m = importlib.util.module_from_spec(sp); sp.loader.exec_module(m)\n"
        "import stcbench.calibrate\n"
        "from stc_tpu_torch.models import llava_onevision, longva, convert\n"
        "from stc_tpu_torch.ops import stream_attention, decode_attention\n"
        "from stcbench.families import llava_ov as a, longva as b\n")
    assert "stc_tpu_torch" in names and "stcbench" in names
    assert not names & FORBIDDEN


def test_reference_loads_no_program():
    names = loaded("import sys; sys.path.insert(0, '.')\n"
                   "from stcbench.reference import lm, vision, precision\n")
    assert not names & (FORBIDDEN | {"stc_tpu_torch"})


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "stcbench/run.py", "--workload", "ov7b-ingest",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
