"""Host-side helpers around the CUDA kernels that run without a card: the
build keys of a kernel's -D variants (kernels/_build.py), each launcher's
ctypes binding against the kernel's C prototype, and the least time
chip_smoke.py holds each kernel to."""

import ctypes
import importlib.util
import pathlib
import re
import types

import pytest
import torch

from stc_tpu_torch.kernels import _build
from stc_tpu_torch.ops import decode_attention as da
from stc_tpu_torch.ops import latent_attention as la
from stc_tpu_torch.ops import stream_attention as sa

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_variant_libraries_are_keyed_by_their_defines():
    plain = _build._lib_path("decode_score")
    drop1 = _build._lib_path("decode_score", ("STC_SCORE_DROP=1",))
    drop2 = _build._lib_path("decode_score", ("STC_SCORE_DROP=2",))
    assert len({plain, drop1, drop2}) == 3
    assert plain == _build._lib_path("decode_score", ())
    assert drop1.name.startswith("libdecode_score-STC_SCORE_DROP1-")
    assert plain.parent == drop1.parent == _build.BUILD


@pytest.mark.parametrize("D, flops_a_pair, want", [
    (64, 4, "operations=exp"),   # attention at 0.5b heads: 256 flops a pair
    (128, 4, "operations"),      # attention at 7B heads
    (64, 2, "exp"),              # decode_score at 0.5b heads
    (128, 2, "operations=exp"),  # decode_score at 7B heads
])
def test_bound_puts_products_and_exponentials_at_one_clock(D, flops_a_pair,
                                                           want):
    cs = _chip_smoke()
    terms = 14 * 1_000_000  # (head, query, key) triples
    ms, by = cs.bound(1.0, flops_a_pair * D * terms, terms)
    assert by == want
    assert ms == pytest.approx(
        max(flops_a_pair * D / 4096, 1 / 16) * terms
        / (cs.H100_SMS * cs.H100_CLOCK_HZ) * 1e3, rel=1e-12)
    # the data sheet's dense bf16 peak, 989 TFLOP/s, at that clock
    assert cs.H100_BF16_FLOPS == pytest.approx(989e12, rel=1e-3)


def test_bound_is_the_bytes_where_they_take_longest():
    cs = _chip_smoke()
    ms, by = cs.bound(3.35e9, 1e6, 1e3)
    assert (ms, by) == (pytest.approx(1.0), "bytes")


def test_chip_smoke_defines_each_name_once():
    """A later definition of a module-level function or class in
    chip_smoke.py would silently replace an earlier one that a phase
    calls."""
    import ast
    import collections
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = collections.Counter(
        n.name for n in tree.body
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
    assert [k for k, v in names.items() if v > 1] == []


# ------------------------------------------ each launcher's C binding --

CTYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
          "float": ctypes.c_float}
STREAM = 0x7F3A_0000_1230  # a stream handle past 32 bits, as a card's are


def c_prototype(name: str, symbol: str) -> list:
    """The parameter kinds ('ptr', 'int', 'float') of `symbol`'s
    extern "C" prototype in csrc/<name>.cu, read here on their own."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    params = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)",
                       src).group(1)
    return ["ptr" if "*" in p else p.split()[0] for p in params.split(",")]


class StandInFn:
    """A kernel library's function that refuses a call unless its argtypes
    are those of the C prototype and each argument fits its C type; it
    records the calls and, as a tile query, reports a tile."""

    def __init__(self, name: str, symbol: str):
        self.kinds = c_prototype(name, symbol)
        self.argtypes = self.restype = None
        self.calls = []

    def __call__(self, *args):
        want = [CTYPES[k] for k in self.kinds]
        if self.argtypes != want or self.restype is not ctypes.c_int:
            raise TypeError(f"argtypes {self.argtypes} against the "
                            f"prototype's {want}")
        if len(args) != len(self.kinds):
            raise TypeError(f"{len(args)} arguments for "
                            f"{len(self.kinds)} parameters")
        for i, (a, k) in enumerate(zip(args, self.kinds)):
            fits = (a is None or isinstance(a, (int, ctypes.Array))
                    if k == "ptr" else isinstance(a, float) if k == "float"
                    else isinstance(a, int) and -2 ** 31 <= a < 2 ** 31)
            if not fits:
                raise TypeError(f"argument {i}, {a!r}, is no C {k}")
        self.calls.append(args)
        if isinstance(args[-1], ctypes.Array):
            args[-1][:] = [64, 64, 2]
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """Kernel libraries of stand-in functions, a card stream of 64 bits,
    and the tile queries stubbed; returns {symbol: its stand-in}."""
    fns = {}

    def load(name):
        lib = types.SimpleNamespace()
        for symbol in (f"stc_{name}", f"stc_{name}_tile"):
            if symbol in (_build.CSRC / f"{name}.cu").read_text():
                fns.setdefault(symbol, StandInFn(name, symbol))
                setattr(lib, symbol, fns[symbol])
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_tiles", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=STREAM))
    monkeypatch.setattr(_build, "n_splits", lambda *a, **k: 2)
    return fns


def _stream_attention():
    B, Hq, Hkv, T, D, Nb, S, n_init = 1, 4, 2, 8, 16, 6, 8, 4
    r = torch.randn
    bf = dict(dtype=torch.bfloat16)
    sa._launch(r(B, Hq, T, D, **bf), r(B, Hq, T, D, **bf),
               r(B, Hkv, Nb, S, D, **bf), r(B, Hkv, Nb, S, D, **bf),
               r(B, 16, D), r(B, 16, D), r(B, Hkv, n_init, D, **bf),
               r(B, Hkv, n_init, D, **bf), r(B, Hkv, n_init, D, **bf),
               torch.zeros(B, 5, dtype=torch.int32), n_local=64,
               k_scales=None, v_scales=None,
               page_keep=torch.ones(B, Nb, S, dtype=torch.bool))


def _decode():
    q, k = torch.randn(2, 4, 3, 16), torch.randn(2, 2, 40, 16)
    cursor = torch.tensor([40, 30], dtype=torch.int32)
    return q, k, cursor - 3, cursor


def _decode_attention():
    q, k, start, cursor = _decode()
    da._launch(q, k, k.clone(), start, cursor, 32, True)


def _decode_score():
    q, k, start, cursor = _decode()
    da._launch_score(q, k, torch.zeros(2, 4, 3), start, cursor, 32)


def _latent_attention():
    B, T, Hq, Nb, S, n_init = 1, 4, 2, 3, 4, 4
    bf = dict(dtype=torch.bfloat16)
    q = torch.randn(B, T, Hq, la.WIDTH, **bf)
    la._launch(q, q.clone(), torch.randn(B, Nb, S, la.WIDTH, **bf),
               torch.randn(B, 8, la.ROPE), torch.randn(B, 8, la.ROPE),
               torch.randn(B, n_init, la.WIDTH, **bf),
               torch.randn(B, n_init, la.WIDTH, **bf),
               torch.zeros(B, 5, dtype=torch.int32), n_local=64, scale=0.1)


LAUNCHERS = {"stream_attention": ("stream_attention", _stream_attention),
             "decode_attention": ("decode_attention", _decode_attention),
             "decode_score": ("decode_score", _decode_score),
             "latent_attention": ("latent_attention", _latent_attention)}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_launcher_binds_the_c_prototype(launcher, stand_in):
    """Each launcher on small CPU tensors, against a library whose function
    refuses a call unless its argtypes count and type the parameters of
    the C prototype in csrc/<name>.cu (read by this test on its own): the
    kernel is called once, with the 64-bit stream handle last, whole."""
    name, launch = LAUNCHERS[launcher]
    launch()
    fn = stand_in[f"stc_{launcher}"]
    assert len(fn.calls) == 1
    assert fn.calls[0][-1] == STREAM


@pytest.mark.parametrize("name", ["stream_attention", "decode_attention",
                                  "latent_attention"])
def test_tile_query_binds_the_c_prototype(name, stand_in, monkeypatch):
    """_build.tile calls stc_<name>_tile with its prototype's types and
    reads the tile it reports."""
    codes = {"stream_attention": (1, 0, 64), "decode_attention": (1, 64),
             "latent_attention": ()}[name]
    assert _build.tile(name, codes) == (64, 64, 2)
    assert len(stand_in[f"stc_{name}_tile"].calls) == 1


@pytest.mark.parametrize("symbol", [
    "stream_attention", "stream_attention_tile", "decode_attention",
    "decode_attention_tile", "decode_score", "latent_attention",
    "latent_attention_tile"])
def test_prototypes_read_each_source(symbol):
    """_build.prototypes reads every extern "C" function of the sources,
    each parameter as its C type; every kernel returns an int."""
    name = symbol.replace("_tile", "")
    restype, argtypes = _build.prototypes(name)[f"stc_{symbol}"]
    assert restype is ctypes.c_int
    assert argtypes == [CTYPES[k] for k in c_prototype(name,
                                                       f"stc_{symbol}")]


def test_an_unknown_c_type_raises_by_name(tmp_path, monkeypatch):
    (tmp_path / "bogus.cu").write_text(
        'extern "C" int stc_bogus(const void* q, double scale,\n'
        '                         void* stream) { return 0; }\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    lib = types.SimpleNamespace(stc_bogus=types.SimpleNamespace(
        argtypes=None, restype=None))
    with pytest.raises(RuntimeError, match=r"stc_bogus.*'double'"):
        _build.entry("bogus", lib=lib)
