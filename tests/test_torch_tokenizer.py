"""The port's tokenizer.json reader (stc_tpu_torch/runtime/tokenizer.py)
against the `tokenizers` library and `transformers.AutoTokenizer` on files
built here (no download), in both pipelines the backbones use:

- the Qwen2 style (LLaVA-OV, LongVA): NFC, a Split on Qwen2's pattern,
  ByteLevel without its regex, byte-level BPE trained on a short corpus,
  the three Qwen2 special tokens and one non-special added token;
- the Llama style (Video-LLaVA, Flash-VStream): BPE over a vocab holding
  <0x00>..<0xFF> with byte_fallback and fuse_unk, a `<s>` template, in
  both generations of the file: a Prepend + Replace normalizer, and a
  Metaspace pre-tokenizer.

Ids must equal the library's and AutoTokenizer's; decoded strings must
equal with skip_special_tokens and clean_up_tokenization_spaces both ways,
on every prefix of the ids (so multi-byte characters cut in the middle
too).  A hypothesis property test draws 200 texts per style."""

import json
import re
import unicodedata

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

tokenizers = pytest.importorskip("tokenizers")
transformers = pytest.importorskip("transformers")

from tokenizers import (AddedToken, Regex, Tokenizer, decoders, models,
                        normalizers, pre_tokenizers, processors, trainers)

from stc_tpu_torch.runtime import tokenizer as ptok
from stc_tpu_torch.runtime.adapter import ChatTemplate

QWEN2_SPECIALS = ("<|endoftext|>", "<|im_start|>", "<|im_end|>")
LLAMA_SPECIALS = ("<unk>", "<s>", "</s>")
CORPUS = [
    ChatTemplate.init_prompt,
    ChatTemplate.wrap("What is the man holding?"),
    ChatTemplate.wrap("Question: Which tool?\nOptions:\n(A) saw\n(B) pen",
                      mc=True),
    "It's THEY'RE we'LL I'M you'Ve he'd 'S don't",
    "a   b\t\tc  \t d\r\nnext line \r\n\r\n  trailing   ",
    "12 345 x² Ⅻ ٣ 2³ ½",
    "cafe\u0301 nai\u0308ve A\u030a \u00c5",     # NFD accents
    "漢字かな交じり文 한국어 😀👍🏽 emoji",
    "<|im_end|><|im_end|>x<|endoftext|> <frame>y<|im_start|>",
    "Hi , there . I 'm ok ! don 't ? yes",
    "",
]
TRAIN = CORPUS * 3 + ["hello world the quick brown fox jumps over the lazy "
                      "dog", "what is in the video"] * 5


def _qwen2(path):
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(ptok.QWEN2_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.post_processor = processors.ByteLevel(trim_offsets=False)
    tok.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=300, initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in QWEN2_SPECIALS])
    tok.add_tokens([AddedToken("<frame>", special=False)])
    tok.save(str(path))


def _llama(path, generation, decoder="sequence", split=False):
    """generation 'prepend' (normalizer Prepend + Replace) or 'metaspace'
    (a Metaspace pre-tokenizer, prepend_scheme first)."""
    base = Tokenizer(models.BPE())
    base.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                            normalizers.Replace(" ", "▁")])
    base.train_from_iterator(TRAIN[-10:], trainers.BpeTrainer(vocab_size=120))
    learnt = json.loads(base.to_str())["model"]
    vocab = {t: i for i, t in enumerate(LLAMA_SPECIALS)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for t, _ in sorted(learnt["vocab"].items(), key=lambda kv: kv[1]):
        vocab.setdefault(t, len(vocab))
    merges = [tuple(m) for m in learnt["merges"]]
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges, unk_token="<unk>",
                               byte_fallback=True, fuse_unk=True))
    if generation == "prepend":
        tok.normalizer = base.normalizer
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(
            replacement="▁", prepend_scheme="first", split=split)
    tok.decoder = (decoders.Metaspace(replacement="▁", prepend_scheme="first")
                   if decoder == "metaspace" else decoders.Sequence([
                       decoders.Replace("▁", " "), decoders.ByteFallback(),
                       decoders.Fuse(), decoders.Strip(" ", 1, 0)]))
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", 1)])
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in LLAMA_SPECIALS])
    tok.save(str(path))


def write_qwen2_dir(d, eos="<|im_end|>", clean_up=False):
    """A checkpoint directory's tokenizer files in the Qwen2 style."""
    d.mkdir(parents=True, exist_ok=True)
    _qwen2(d / "tokenizer.json")
    _write_config(d, eos, clean_up)
    return d


def _write_config(d, eos, clean_up):
    with open(d / "tokenizer_config.json", "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast",
                   "eos_token": {"__type": "AddedToken", "content": eos,
                                 "lstrip": False, "rstrip": False,
                                 "normalized": False, "single_word": False,
                                 "special": True},
                   "clean_up_tokenization_spaces": clean_up}, f)


STYLES = {"qwen2": ("<|im_end|>", _qwen2),
          "llama_prepend": ("</s>", lambda p: _llama(p, "prepend")),
          "llama_metaspace": ("</s>", lambda p: _llama(p, "metaspace"))}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """style -> {clean_up: directory}"""
    root = tmp_path_factory.mktemp("tok")
    out = {}
    for name, (eos, build) in STYLES.items():
        out[name] = {}
        for clean in (False, True):
            d = root / f"{name}_{int(clean)}"
            d.mkdir()
            build(d / "tokenizer.json")
            _write_config(d, eos, clean)
            out[name][clean] = d
    return out


def _three(d):
    """(library Tokenizer, AutoTokenizer, the port's) of directory d."""
    from transformers import AutoTokenizer
    return (Tokenizer.from_file(str(d / "tokenizer.json")),
            AutoTokenizer.from_pretrained(str(d)),
            ptok.load_tokenizer(str(d)))


@pytest.mark.parametrize("style", STYLES)
def test_ids_equal_library_and_autotokenizer(dirs, style):
    lib, auto, port = _three(dirs[style][False])
    for text in CORPUS:
        want = lib.encode(text).ids
        assert port.encode(text) == want == auto(text).input_ids, text
        assert port(text) == want
        assert (port.encode(text, add_special_tokens=False)
                == lib.encode(text, add_special_tokens=False).ids), text


@pytest.mark.parametrize("clean", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("style", STYLES)
def test_decode_equal_autotokenizer(dirs, style, skip, clean):
    """Every prefix of every text's ids, so emoji and CJK cut inside their
    bytes decode to the library's U+FFFD count."""
    _, auto, port = _three(dirs[style][clean])
    assert auto.clean_up_tokenization_spaces == clean
    assert port.eos_token_id == auto.eos_token_id is not None
    cut = 0
    for text in CORPUS:
        ids = auto(text).input_ids
        for k in range(len(ids) + 1):
            want = auto.decode(ids[:k], skip_special_tokens=skip)
            assert port.decode(ids[:k], skip_special_tokens=skip) == want, (
                text, k)
            cut += "�" in want
    assert cut > 0          # some prefix did end inside a character
    # ids past the vocab are dropped, as the library drops them
    assert port.decode([10 ** 6] + ids) == auto.decode([10 ** 6] + ids)


@pytest.mark.parametrize("style", STYLES)
def test_ids_equal_library_on_random_text(dirs, style):
    lib, _, port = _three(dirs[style][False])

    @settings(derandomize=True, max_examples=200, deadline=None,
              database=None)
    @given(st.text())
    def check(text):
        assert port.encode(text) == lib.encode(text).ids

    check()


@pytest.mark.parametrize("decoder,split", [("metaspace", False),
                                           ("sequence", True)])
def test_metaspace_variants_equal_library(tmp_path, decoder, split):
    """The Metaspace decoder, and a Metaspace that splits at each ▁."""
    path = tmp_path / "tokenizer.json"
    _llama(path, "metaspace", decoder=decoder, split=split)
    lib = Tokenizer.from_file(str(path))
    port = ptok.load_tokenizer(str(tmp_path))
    for text in CORPUS:
        ids = lib.encode(text).ids
        assert port.encode(text) == ids, text
        for skip in (False, True):
            assert (port.decode(ids, skip_special_tokens=skip)
                    == lib.decode(ids, skip_special_tokens=skip)), text


@pytest.mark.parametrize("add_prefix_space", [False, True])
def test_byte_level_with_gpt2_regex_equal_library(tmp_path,
                                                  add_prefix_space):
    """ByteLevel splitting on GPT-2's own pattern (use_regex), with and
    without the space it prepends to every piece (none to an empty one)."""
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(
        add_prefix_space=add_prefix_space, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(TRAIN, trainers.BpeTrainer(
        vocab_size=300, initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens([AddedToken(t, special=True, normalized=False)
                            for t in QWEN2_SPECIALS])
    tok.save(str(tmp_path / "tokenizer.json"))
    port = ptok.load_tokenizer(str(tmp_path))

    @settings(derandomize=True, max_examples=100, deadline=None,
              database=None)
    @given(st.sampled_from(CORPUS) | st.text())
    def check(text):
        ids = tok.encode(text).ids
        assert port.encode(text) == ids
        assert port.decode(ids) == tok.decode(ids, skip_special_tokens=False)

    check()


def test_merges_as_strings_equal_pairs(dirs, tmp_path):
    """Older files write each merge as one "a b" string."""
    with open(dirs["qwen2"][False] / "tokenizer.json") as f:
        spec = json.load(f)
    assert isinstance(spec["model"]["merges"][0], list)
    spec["model"]["merges"] = [" ".join(m) for m in spec["model"]["merges"]]
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    lib = Tokenizer.from_file(str(path))
    port = ptok.load_tokenizer(str(tmp_path))
    for text in CORPUS:
        assert port.encode(text) == lib.encode(text).ids, text


@pytest.mark.parametrize("ignore_merges", [False, True])
def test_ignore_merges_equal_library(tmp_path, ignore_merges):
    """A vocab word that the merges would not build: taken whole only
    under ignore_merges."""
    vocab = {c: i for i, c in enumerate("abcd")}
    vocab.update({"ab": 4, "abcd": 5, "cd": 6})
    tok = Tokenizer(models.BPE(vocab=vocab, merges=[("a", "b"), ("c", "d")],
                               ignore_merges=ignore_merges))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    spec = json.loads(tok.to_str())
    spec["pre_tokenizer"] = {"type": "Split", "pattern": {
        "Regex": ptok.GPT2_PATTERN}, "behavior": "Isolated", "invert": False}
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(spec))
    lib = Tokenizer.from_file(str(path))
    port = ptok.load_tokenizer(str(tmp_path))
    for text in ("abcd", "abcdab", "ab cd", "dcba", "abcd abcd"):
        assert port.encode(text) == lib.encode(text).ids, text
    assert (port.encode("abcd") == [5]) == ignore_merges


def test_added_token_flags_equal_library(tmp_path):
    """lstrip, rstrip, single_word and normalized added tokens, special and
    not, split out before normalisation as the library splits them."""
    _qwen2(tmp_path / "base.json")
    tok = Tokenizer.from_file(str(tmp_path / "base.json"))
    tok.add_special_tokens([
        AddedToken("<L>", special=True, lstrip=True),
        AddedToken("<R>", special=True, rstrip=True),
        AddedToken("word", single_word=True, special=False),
        AddedToken("\u00c5", special=False, normalized=True)])
    tok.save(str(tmp_path / "tokenizer.json"))
    port = ptok.load_tokenizer(str(tmp_path))
    texts = ["a  <L> b", "<L>x", "x<R>  y", "<R>", "word words sword word.",
             "Å and Å", " <L><R> word"]
    for text in texts:
        ids = tok.encode(text).ids
        assert port.encode(text) == ids, text
        for skip in (False, True):
            assert (port.decode(ids, skip_special_tokens=skip)
                    == tok.decode(ids, skip_special_tokens=skip)), text


def test_whitespace_is_the_library_set():
    """The scanner's \\s is Unicode White_Space, as the library's regex
    engine reads it: not str.isspace (which takes U+001C-U+001F too)."""
    split = pre_tokenizers.Split(Regex(ptok.QWEN2_PATTERN),
                                 behavior="isolated")
    for cp in list(range(0x00, 0x2100)) + [0x202F, 0x205F, 0x3000, 0xFEFF]:
        if unicodedata.category(chr(cp)) == "Cn":
            continue    # unassigned to Python's tables (see the module)
        text = "." + chr(cp) * 2 + "x\n"
        want = [p for p, _ in split.pre_tokenize_str(text)]
        assert ptok._split_isolated(text, ptok._qwen2_match) == want, hex(cp)
    assert "\x1c".isspace() and "\x1c" not in ptok.WHITESPACE
    assert "\x85" in ptok.WHITESPACE


def test_scanner_categories_pin_letters_and_numbers(dirs, monkeypatch):
    """`[^\\W\\d_]` and `\\d` are the obvious stand-ins for \\p{L} and
    \\p{N} in Python's re; they take '²' (No) for a letter, so 'x²' splits
    into other pieces than the library's.  The category scanner does
    not."""
    split = pre_tokenizers.Split(Regex(ptok.QWEN2_PATTERN),
                                 behavior="isolated")
    lib, _, port = _three(dirs["qwen2"][False])
    for text in ("x²", "Ⅻx", "a\u0301b"):
        want = [p for p, _ in split.pre_tokenize_str(text)]
        assert ptok._split_isolated(text, ptok._qwen2_match) == want
        assert port.encode(text) == lib.encode(text).ids
    monkeypatch.setattr(ptok, "_is_letter",
                        lambda c: re.match(r"[^\W\d_]", c) is not None)
    monkeypatch.setattr(ptok, "_is_number",
                        lambda c: re.match(r"\d", c) is not None)
    want = [p for p, _ in split.pre_tokenize_str("x²")]
    assert ptok._split_isolated("x²", ptok._qwen2_match) != want


def test_convert_tokens_to_ids(dirs):
    _, auto, port = _three(dirs["qwen2"][False])
    toks = ["<|im_end|>", "<frame>", "Ġthe", "h"]
    assert port.convert_tokens_to_ids(toks) == auto.convert_tokens_to_ids(
        toks)
    assert port.convert_tokens_to_ids("<|im_start|>") == \
        auto.convert_tokens_to_ids("<|im_start|>")


@pytest.mark.parametrize("component,value", [
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": r"\w+"},
                       "behavior": "Isolated", "invert": False}),
    ("normalizer", {"type": "Lowercase"}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("post_processor", {"type": "BertProcessing", "sep": ["[SEP]", 1],
                        "cls": ["[CLS]", 2]}),
])
def test_unsupported_component_raises(dirs, tmp_path, component, value):
    with open(dirs["qwen2"][False] / "tokenizer.json") as f:
        spec = json.load(f)
    spec[component] = value
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ValueError, match=component):
        ptok.load_tokenizer(str(tmp_path))


def test_sentencepiece_only_checkpoint_raises(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(FileNotFoundError, match="tokenizer.model"):
        ptok.load_tokenizer(str(tmp_path))


def test_reader_imports_standard_library_only():
    import ast
    tree = ast.parse(open(ptok.__file__, encoding="utf-8").read())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names <= {"__future__", "json", "os", "unicodedata", "typing"}


def test_bpe_results_cached(dirs):
    port = ptok.load_tokenizer(str(dirs["qwen2"][False]))
    port.encode("hello hello world")
    assert "hello" in port.model._cache or "Ġhello" in port.model._cache
    hit = dict(port.model._cache)
    port.encode("hello hello world")
    assert port.model._cache == hit


def test_chip_smoke_tokenizer_file_equal_library(tmp_path):
    """chip_smoke.py writes its own byte-level tokenizer.json (phase 17:
    the card machine has no tokenizers library); the library reads the
    file and agrees with the port's reader on it."""
    import importlib.util
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    n = cs.write_byte_level_tokenizer(str(tmp_path), cs.CLI_CORPUS)
    assert 0 < n <= 200
    with open(tmp_path / "tokenizer.json") as f:
        assert len(json.load(f)["model"]["vocab"]) == 151643
    lib = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    port = ptok.load_tokenizer(str(tmp_path))
    assert port.eos_token_id == 151645
    for text in cs.CLI_CORPUS + CORPUS:
        ids = lib.encode(text).ids
        assert port.encode(text) == ids, text
        assert port.decode(ids) == lib.decode(
            ids, skip_special_tokens=False), text
    ids = [40, 151000, 151645, 151700]
    assert port.decode(ids) == lib.decode(ids, skip_special_tokens=False) \
        == "(<t151000><|im_end|>"
