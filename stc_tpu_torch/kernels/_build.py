"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
loaded with ``ctypes``.  Builds happen at first use, into
``build/stc_tpu_torch/`` at the root of the checkout, keyed by a hash of the
sources and flags; all sources compile in parallel, one ``nvcc`` each.
The host library ``csrc/frameproc.cpp`` (frame preprocessing and YUV
packing) builds the same way with ``g++`` (``load_host``), on any machine.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG.parent / "build" / "stc_tpu_torch"
SOURCES = ("stream_attention", "decode_attention", "decode_score")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # name -> compiler output of its build (kept as .log)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str, defines: tuple = ()) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS + defines).encode())
    tag = "".join("-" + d.replace("=", "") for d in defines)
    return BUILD / f"lib{name}{tag}-{h.hexdigest()[:16]}.so"


def build_all(variants: dict | None = None) -> dict:
    """Compile every kernel source that is not built yet, all in parallel.
    variants, {key: (source name, -D defines)}, builds those instead (a
    measurement's variants of a kernel).  Returns {name or key: path}.
    Raises with the compiler output on a failure."""
    jobs = variants or {n: (n, ()) for n in SOURCES}
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        todo = {key: _lib_path(*job) for key, job in jobs.items()}
        procs = {}
        for name, out in todo.items():
            if out.exists():
                log = out.with_suffix(".log")
                if name not in build_log and log.exists():
                    build_log[name] = log.read_text()
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            src, defines = jobs[name]
            cmd = [_nvcc(), *FLAGS, *("-D" + d for d in defines), "-o",
                   str(tmp), str(CSRC / f"{src}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name} ---\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return todo


@functools.lru_cache(maxsize=None)
def split_grid(rows: int, heads: int, n_keys: int, br: int, bc: int,
               slots: int) -> tuple:
    """The grid of a split-KV attention launch, from the tile the kernel
    reports (br rows, bc keys): (row_blocks, n_split).  rows: folded query
    rows per kv head (G * T); heads: kv heads times batch; n_keys: keys
    each row tile walks; slots: blocks the card holds at once (SMs times
    blocks per SM).  n_split blocks share one row tile's KV walk; it is
    the count that finishes soonest when a block takes one time unit per
    key tile it walks plus one for loading its queries and writing its
    partial sums: (waves) x (tiles a block walks + 1), the largest such."""
    row_blocks = -(-rows // br) * heads
    n_tiles = -(-n_keys // bc)

    def cost(s):
        return -(-row_blocks * s // slots) * (-(-n_tiles // s) + 1)

    return row_blocks, min(range(1, n_tiles + 1),
                           key=lambda s: (cost(s), -s))


def n_splits(name: str, codes: tuple, rows: int, heads: int, n_keys: int,
             device) -> int:
    """split_grid's n_split for kernel `name` at its tile query's codes
    on device."""
    br, bc, per_sm = tile(name, codes)
    return split_grid(rows, heads, n_keys, br, bc,
                      _sm_count(device.index) * per_sm)[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


_tiles: dict = {}


def tile(name: str, codes: tuple) -> tuple:
    """(rows, keys, blocks per SM) of the tile that kernel `name` runs,
    as its library reports it; codes are the query's int arguments
    (stream_attention: dtype, page kind, D; decode_attention: dtype, D)."""
    key = (name, codes)
    if key not in _tiles:
        fn = getattr(load(name), f"stc_{name}_tile")
        out = (ctypes.c_int * 3)()
        fn.argtypes = [ctypes.c_int] * len(codes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        check_launch(fn(*codes, out), f"{name} tile query")
        _tiles[key] = tuple(out)
    return _tiles[key]


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library csrc/<name>.cpp, built with g++ on first
    use (keyed by a hash of the source and flags).  Raises without g++ or
    on a failed build."""
    key = ("host", name)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes() + " ".join(HOST_FLAGS).encode())
    out = BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"
    with _lock:
        if not out.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: {src.name} is built "
                                   "with a C++ compiler at first use")
            BUILD.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *HOST_FLAGS, str(src), "-o",
                                   str(tmp)], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {src.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[key] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib
