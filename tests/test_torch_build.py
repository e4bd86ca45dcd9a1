"""Host-side helpers around the CUDA kernels that run without a card: the
build keys of a kernel's -D variants (kernels/_build.py) and the least
time chip_smoke.py holds each kernel to."""

import importlib.util
import pathlib

import pytest

from stc_tpu_torch.kernels import _build

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
