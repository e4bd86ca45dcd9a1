"""A reader of a checkpoint's ``tokenizer.json``: the port's counterpart of
``transformers.AutoTokenizer.from_pretrained(dir)`` for the four
backbones, on the standard library alone (no ``tokenizers``,
``transformers`` or ``regex``).

Two pipelines share the format:

- Qwen2 (LLaVA-OV, LongVA): an NFC normalizer, a ``Split`` on Qwen2's
  pre-tokenizer regex, GPT-2's byte-to-unicode table, byte-level BPE and
  the added special tokens (``<|endoftext|>``, ``<|im_start|>``,
  ``<|im_end|>``);
- Vicuna / Llama (Video-LLaVA, Flash-VStream): BPE with byte fallback
  (``<0xXX>`` pieces), ``fuse_unk`` and a ``▁`` prefix, written either as
  a ``Prepend`` + ``Replace`` normalizer or as a ``Metaspace``
  pre-tokenizer, a ``TemplateProcessing`` post-processor that adds
  ``<s>``, and a decoder that strips one leading space.

The two regexes the files name (Qwen2's and GPT-2's) use ``\\p{L}`` and
``\\p{N}``, which Python's ``re`` lacks; they run here as small scanners
over ``unicodedata.category`` (L* letters, N* numbers) and the Unicode
White_Space set (``\\s`` as the ``tokenizers`` library reads it: not
``str.isspace``, which also takes U+001C-U+001F).  Any other component,
pattern or setting raises a ``ValueError`` that names it.

Character classes and NFC come from Python's ``unicodedata`` (Unicode 15.0
in Python 3.12).  The library's regex engine has Unicode 16.0 and its NFC
tables predate 14.0, so text holding a character assigned after Unicode
13 (a Unicode 16 letter, or a combining mark of 14-15 beside another
mark) can split or normalise differently there.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|"
                 r"\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
                r"|\s+(?!\S)|\s+")

# the Unicode White_Space property: `\s` of the library's regex engine and
# Rust's char::is_whitespace (lstrip / rstrip of added tokens)
WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B)))
CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")

# transformers' clean_up_tokenization, in its order
CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
            (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
            (" 've", "'ve"), (" 're", "'re"))


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's table: every byte to a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_CHAR = _bytes_to_unicode()
CHAR_BYTE = {c: b for b, c in BYTE_CHAR.items()}


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    """[^\\s\\p{L}\\p{N}]"""
    return not (c in WHITESPACE or _is_letter(c) or _is_number(c))


def _is_word_char(c: str) -> bool:
    """Rust regex's Unicode \\w (single_word added tokens): letters, marks,
    decimal digits, letter numbers, connector punctuation, joiners."""
    cat = unicodedata.category(c)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
            or c in "\u200c\u200d")


def _run(s: str, i: int, pred) -> int:
    while i < len(s) and pred(s[i]):
        i += 1
    return i


def _contraction(s: str, i: int, fold: bool) -> Optional[int]:
    if s[i] != "'":
        return None
    for c in CONTRACTIONS:
        part = s[i + 1:i + 1 + len(c)]
        if fold:   # (?i:...): Unicode simple case folding ('ſ' is 's')
            part = "".join("s" if ch == "ſ" else ch.lower() if ch.isascii()
                           else ch for ch in part)
        if part == c:
            return i + 1 + len(c)
    return None


def _ws_tail(s: str, i: int) -> Optional[int]:
    """\\s+(?!\\S) then \\s+ at i: a whitespace run leaves its last
    character to the next piece unless it ends the text or is one
    character long."""
    if s[i] not in WHITESPACE:
        return None
    r = _run(s, i, WHITESPACE.__contains__)
    return r if r == len(s) or r - i == 1 else r - 1


def _qwen2_match(s: str, i: int) -> Optional[int]:
    """The end of Qwen2's pattern's match at i (leftmost-first
    alternation, backtracking as the library's engine does), or None."""
    c = s[i]
    end = _contraction(s, i, fold=True)
    if end is not None:
        return end
    # [^\r\n\p{L}\p{N}]?\p{L}+
    if (c not in "\r\n" and not _is_letter(c) and not _is_number(c)
            and i + 1 < len(s) and _is_letter(s[i + 1])):
        return _run(s, i + 1, _is_letter)
    if _is_letter(c):
        return _run(s, i, _is_letter)
    if _is_number(c):                       # \p{N}: one at a time
        return i + 1
    # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
    j = i + 1 if c == " " and i + 1 < len(s) and _is_other(s[i + 1]) else i
    if _is_other(s[j]):
        return _run(s, _run(s, j, _is_other), "\r\n".__contains__)
    # \s*[\r\n]+: up to the last CR or LF of the whitespace run
    r = _run(s, i, WHITESPACE.__contains__)
    last = max((k for k in range(i, r) if s[k] in "\r\n"), default=None)
    if last is not None:
        return last + 1
    return _ws_tail(s, i)


def _gpt2_match(s: str, i: int) -> Optional[int]:
    end = _contraction(s, i, fold=False)
    if end is not None:
        return end
    j = i + 1 if s[i] == " " and i + 1 < len(s) else i
    for pred in (_is_letter, _is_number, _is_other):
        if pred(s[j]):
            return _run(s, j, pred)
        if pred(s[i]):
            return _run(s, i, pred)
    return _ws_tail(s, i)


def _split_isolated(s: str, match: Callable) -> List[str]:
    """Every match as a piece of its own, and every stretch between
    matches as one too (SplitDelimiterBehavior::Isolated)."""
    out, i, gap = [], 0, 0
    while i < len(s):
        end = match(s, i)
        if end is None:
            i += 1
            continue
        if gap < i:
            out.append(s[gap:i])
        out.append(s[i:end])
        i = gap = end
    if gap < len(s):
        out.append(s[gap:])
    return out


PATTERNS = {QWEN2_PATTERN: _qwen2_match, GPT2_PATTERN: _gpt2_match}


def _unsupported(component: str, value) -> ValueError:
    return ValueError(f"tokenizer.json: {component} {json.dumps(value)} is "
                      f"not supported by the port's tokenizer reader")


# --------------------------------------------------------------------------
# normalizers: str -> str
# --------------------------------------------------------------------------

def _string_pattern(spec: dict, component: str) -> str:
    pat = spec.get("pattern", {})
    if set(pat) != {"String"}:
        raise _unsupported(component, spec)
    return pat["String"]


def _normalizer(spec) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for p in parts:
                s = p(s)
            return s
        return seq
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        old = _string_pattern(spec, "normalizer")
        new = spec["content"]
        return lambda s: s.replace(old, new)
    raise _unsupported("normalizer", spec)


# --------------------------------------------------------------------------
# pre-tokenizers: [(piece, starts the text)] -> [(piece, starts the text)]
# --------------------------------------------------------------------------

Pieces = List[Tuple[str, bool]]


def _each(fn: Callable[[str, bool], List[str]]):
    """A pre-tokenizer from a function of one piece to its sub-pieces; the
    first sub-piece of a piece that starts the text starts it too."""
    def apply(pieces: Pieces) -> Pieces:
        out = []
        for p, first in pieces:
            out += [(q, first and k == 0) for k, q in enumerate(fn(p, first))]
        return out
    return apply


def _split_merged_with_next(s: str, delim: str) -> List[str]:
    out, cur = [], ""
    for ch in s:
        if ch == delim and cur:
            out.append(cur)
            cur = ""
        cur += ch
    return out + ([cur] if cur else [])


def _prepend_scheme(spec: dict, component: str) -> str:
    """A Metaspace's prepend_scheme; files written before it had one give
    add_prefix_space."""
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("first", "always", "never"):
        raise _unsupported(component, spec)
    return scheme


def _pre_tokenizer(spec) -> Callable[[Pieces], Pieces]:
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    if kind == "Split":
        pat = spec.get("pattern", {}).get("Regex")
        if (pat not in PATTERNS or spec.get("behavior") != "Isolated"
                or spec.get("invert")):
            raise _unsupported("pre_tokenizer", spec)
        match = PATTERNS[pat]
        return _each(lambda p, _: _split_isolated(p, match))
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", False)
        regex = spec.get("use_regex", True)

        def byte_level(p, _):
            if prefix and p and not p.startswith(" "):
                p = " " + p
            parts = _split_isolated(p, _gpt2_match) if regex else [p]
            return ["".join(BYTE_CHAR[b] for b in q.encode()) for q in parts]
        return _each(byte_level)
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = _prepend_scheme(spec, "pre_tokenizer")
        split = spec.get("split", True)

        def metaspace(p, first):
            p = p.replace(" ", rep)
            if (p and not p.startswith(rep)
                    and (scheme == "always" or scheme == "first" and first)):
                p = rep + p
            return _split_merged_with_next(p, rep) if split else [p]
        return _each(metaspace)
    raise _unsupported("pre_tokenizer", spec)


# --------------------------------------------------------------------------
# the BPE model
# --------------------------------------------------------------------------

class BPE:
    def __init__(self, spec: dict):
        for key in ("type", "vocab", "merges"):
            if key not in spec:
                raise _unsupported("model", {k: v for k, v in spec.items()
                                             if k not in ("vocab", "merges")})
        if spec["type"] != "BPE" or spec.get("dropout") not in (None, 0.0):
            raise _unsupported("model", {k: v for k, v in spec.items()
                                         if k not in ("vocab", "merges")})
        self.vocab: Dict[str, int] = spec["vocab"]
        self.inverse = {i: t for t, i in self.vocab.items()}
        self.unk_token = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        pairs = []
        for m in spec["merges"]:
            if isinstance(m, str):          # "a b" (older files)
                if m.startswith("#version"):
                    continue
                m = m.split(" ")
            if len(m) != 2:
                raise _unsupported("model merge", m)
            pairs.append(tuple(m))
        # (left id, right id) -> (rank, merged id); a repeated pair keeps
        # its last rank, as the library's map does
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(pairs):
            merged = a + b[len(self.prefix):]
            try:
                self.merges[self.vocab[a], self.vocab[b]] = (
                    rank, self.vocab[merged])
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names "
                                 f"{e.args[0]!r}, which is not in the "
                                 f"vocab") from None
        self._cache: Dict[str, List[int]] = {}

    def _unk_id(self) -> int:
        if self.unk_token not in self.vocab:
            raise ValueError(f"tokenizer.json: unk_token "
                             f"{self.unk_token!r} is not in the vocab")
        return self.vocab[self.unk_token]

    def _symbols(self, word: str) -> List[int]:
        """The word's characters as ids, with byte fallback and the unknown
        token (fused when fuse_unk) for characters not in the vocab."""
        out, unk = [], None      # unk: a pending unknown id
        for k, ch in enumerate(word):
            s = (self.prefix if k else "") + ch
            if k == len(word) - 1:
                s += self.suffix
            if s in self.vocab:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(self.vocab[s])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in s.encode()]
                if all(c in self.vocab for c in codes):
                    out += [self.vocab[c] for c in codes]
                    continue
            if self.unk_token is not None:
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = self._unk_id()
        if unk is not None:
            out.append(unk)
        return out

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = self._symbols(word)
            while len(ids) > 1:   # the lowest rank first, leftmost on a tie
                best = None
                for k in range(len(ids) - 1):
                    m = self.merges.get((ids[k], ids[k + 1]))
                    if m is not None and (best is None or m[0] < best[0]):
                        best = (m[0], k, m[1])
                if best is None:
                    break
                _, k, new = best
                ids[k:k + 2] = [new]
        self._cache[word] = ids
        return ids


# --------------------------------------------------------------------------
# post-processors and decoders
# --------------------------------------------------------------------------

def _post_processor(spec) -> Callable[[List[int]], List[int]]:
    if spec is None or spec.get("type") == "ByteLevel":
        return lambda ids: ids          # ByteLevel: offsets only
    if spec.get("type") == "TemplateProcessing":
        special = {k: v["ids"] for k, v in spec["special_tokens"].items()}
        template = []
        for item in spec["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A":
                    raise _unsupported("post_processor", spec)
                template.append(None)
            else:
                template.append(special[item["SpecialToken"]["id"]])

        def apply(ids):
            out = []
            for part in template:
                out += ids if part is None else part
            return out
        return apply
    raise _unsupported("post_processor", spec)


def _byte_fallback(tokens: List[str]) -> List[str]:
    """Runs of <0xXX> tokens as the UTF-8 text they spell, or one U+FFFD a
    byte where they spell none."""
    out, run = [], []

    def flush():
        if run:
            try:
                out.append(bytes(run).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in run)
            run.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                run.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _decoder(spec) -> Callable[[List[str]], List[str]]:
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "ByteLevel":
        def byte_level(tokens):
            data = bytearray()
            for t in tokens:
                if all(ch in CHAR_BYTE for ch in t):
                    data += bytes(CHAR_BYTE[ch] for ch in t)
                else:
                    data += t.encode()
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Sequence":
        parts = [_decoder(d) for d in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if kind == "Replace":
        old = _string_pattern(spec, "decoder")
        new = spec["content"]
        return lambda tokens: [t.replace(old, new) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                while len(t) - b < stop and b > a and t[b - 1] == content:
                    b -= 1
                out.append(t[a:b])
            return out
        return strip
    if kind == "Metaspace":
        rep = spec["replacement"]
        scheme = _prepend_scheme(spec, "decoder")
        # the first token loses every replacement character, the others
        # turn them into spaces (the library's rule)
        return lambda tokens: [
            t.replace(rep, "" if k == 0 and scheme != "never" else " ")
            for k, t in enumerate(tokens)]
    raise _unsupported("decoder", spec)


# --------------------------------------------------------------------------
# the tokenizer
# --------------------------------------------------------------------------

class AddedToken:
    def __init__(self, spec: dict):
        self.id = spec["id"]
        self.content = spec["content"]
        self.special = bool(spec.get("special", False))
        self.lstrip = bool(spec.get("lstrip", False))
        self.rstrip = bool(spec.get("rstrip", False))
        self.single_word = bool(spec.get("single_word", False))
        self.normalized = bool(spec.get("normalized", not self.special))


class Tokenizer:
    """Encode and decode as a ``tokenizers.Tokenizer`` built from the same
    file does, with the ``tokenizer_config.json`` settings
    ``transformers`` applies on top (``eos_token``,
    ``clean_up_tokenization_spaces``)."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, spec[key])
        for key, bad in (("add_eos_token", True), ("split_special_tokens",
                                                   True)):
            if config.get(key) == bad:
                raise ValueError(f"tokenizer_config.json: {key} {bad} is "
                                 f"not supported by the port's tokenizer "
                                 f"reader")
        self.model = BPE(spec["model"])
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.post_process = _post_processor(spec.get("post_processor"))
        self.decoder = _decoder(spec.get("decoder"))
        self.added = [AddedToken(t) for t in spec.get("added_tokens", [])]
        self.added_by_id = {t.id: t for t in self.added}
        self.added_by_content = {t.content: t for t in self.added}
        # raw tokens match the text; normalized ones match the normalized
        # pieces, each as the normalizer writes it
        self._raw = [(t.content, t) for t in self.added if not t.normalized]
        self._norm = [(self.normalize(t.content), t) for t in self.added
                      if t.normalized]
        eos = config.get("eos_token")
        self.eos_token = eos.get("content") if isinstance(eos, dict) else eos
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))

    # --- added tokens ---
    @staticmethod
    def _find(s: str, patterns) -> List[Tuple[int, int, AddedToken]]:
        """Non-overlapping leftmost-longest matches of the patterns."""
        out, i = [], 0
        while i < len(s) and patterns:
            best = None
            for pat, tok in patterns:
                if pat and s.startswith(pat, i) and (
                        best is None or len(pat) > len(best[0])):
                    best = (pat, tok)
            if best is None:
                i += 1
                continue
            out.append((i, i + len(best[0]), best[1]))
            i += len(best[0])
        return out

    def _split_added(self, s: str, patterns):
        """s as [(text, None) | (content, AddedToken)], each token's
        single_word, lstrip and rstrip applied."""
        if not s:
            return [(s, None)]
        out, offset = [], 0
        for start, stop, tok in self._find(s, patterns):
            if tok.single_word and (
                    (start > 0 and _is_word_char(s[start - 1]))
                    or (stop < len(s) and _is_word_char(s[stop]))):
                continue
            if tok.lstrip:
                k = start
                while k > 0 and s[k - 1] in WHITESPACE:
                    k -= 1
                start = max(k, offset)
            if tok.rstrip:
                while stop < len(s) and s[stop] in WHITESPACE:
                    stop += 1
            if offset < start:
                out.append((s[offset:start], None))
            out.append((s[start:stop], tok))
            offset = stop
        if offset != len(s):
            out.append((s[offset:], None))
        return out

    # --- encode / decode ---
    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        at = 0                       # the piece's offset in the text
        for raw, tok in self._split_added(text, self._raw):
            start, at = at, at + len(raw)
            if tok is not None:
                ids.append(tok.id)
                continue
            first = start == 0
            for part, tok2 in self._split_added(self.normalize(raw),
                                                self._norm):
                if tok2 is not None:
                    ids.append(tok2.id)
                else:
                    for word, _ in self.pre_tokenize([(part, first)]):
                        ids += self.model.tokenize(word)
                first = False
        return self.post_process(ids) if add_special_tokens else ids

    def __call__(self, text: str) -> List[int]:
        return self.encode(text)

    def id_to_token(self, i: int) -> Optional[str]:
        tok = self.added_by_id.get(i)
        return tok.content if tok is not None else self.model.inverse.get(i)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        """Ids outside the vocab are dropped, as the library drops them;
        bytes that spell no character decode to U+FFFD."""
        tokens = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None:
                continue
            added = self.added_by_content.get(t)
            if skip_special_tokens and added is not None and added.special:
                continue
            tokens.append(t)
        text = "".join(self.decoder(tokens))
        clean = (self.clean_up_tokenization_spaces
                 if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        if clean:
            for old, new in CLEAN_UP:
                text = text.replace(old, new)
        return text

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._token_id(tokens)
        return [self._token_id(t) for t in tokens]

    def _token_id(self, token: str) -> Optional[int]:
        tok = self.added_by_content.get(token)
        if tok is not None:
            return tok.id
        if token in self.model.vocab:
            return self.model.vocab[token]
        unk = self.model.unk_token
        return self.model.vocab.get(unk) if unk is not None else None

    @property
    def eos_token_id(self) -> Optional[int]:
        return (None if self.eos_token is None
                else self.convert_tokens_to_ids(self.eos_token))


def load_tokenizer(model_path: str) -> Tokenizer:
    """The tokenizer of a checkpoint directory: its tokenizer.json, with
    eos_token and clean_up_tokenization_spaces from tokenizer_config.json
    when that file is there."""
    path = os.path.join(model_path, "tokenizer.json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found: the port reads a checkpoint's "
            f"tokenizer.json and cannot read a SentencePiece-only "
            f"tokenizer.model")
    with open(path, encoding="utf-8") as f:
        spec = json.load(f)
    config = None
    cfg_path = os.path.join(model_path, "tokenizer_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path, encoding="utf-8") as f:
            config = json.load(f)
    return Tokenizer(spec, config)
