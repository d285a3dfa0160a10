"""The port's stdlib tokenizers against their references.

``dynamo_tpu_torch.tokenizer_json`` against HF ``tokenizers`` on four
``tokenizer.json`` files this test builds (no download): (a) byte-level
BPE trained with ``BpeTrainer`` on a seeded corpus, with the Llama-3 split
pattern, ``ignore_merges``, special tokens and a ``TemplateProcessing``
BOS; (b) Llama-2-style Metaspace + ``byte_fallback`` BPE with the
Replace / ByteFallback / Fuse / Strip decoder chain, and (b2) the same
model with the newer Prepend + Replace normalizer in place of the
pre-tokenizer; (c) ``tests/util.py``'s WordLevel; and (a2), (a) behind an
NFKC normalizer with added tokens that strip, match single words or match
normalized text. Components alone too: pre-tokenizers, normalizers and
decoders against their ``tokenizers`` counterparts. Encode ids and decode
text must be identical on a fixed corpus and on hypothesis strings;
``DecodeStream`` must equal the reference's. The ``sp_tokenizer`` copy must
equal ``dynamo_tpu.sp_tokenizer`` on ``tests/test_sp_tokenizer.py``'s
models.
"""

import functools
import json
import random

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers, processors, trainers

from dynamo_tpu import sp_tokenizer as ref_sp
from dynamo_tpu.tokenizer import TokenizerWrapper as RefWrapper
from dynamo_tpu_torch import sp_tokenizer as port_sp
from dynamo_tpu_torch.tokenizer import TokenizerWrapper as PortWrapper
from dynamo_tpu_torch.tokenizer_json import JsonTokenizer, onig_to_re
from tests import test_sp_tokenizer as sp_cases
from tests.util import make_test_tokenizer

LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>", "<|eot_id|>",
            "<|start_header_id|>", "<|end_header_id|>"]

WORDS = (
    "the quick brown fox jumps over the lazy dog while 42 wizards quietly "
    "hex 1234567 boxing frogs; don't you'll we've I'm THEY'RE it's "
    "naïve café résumé Größe straße Ωμέγα ελληνικά русский текст "
    "日本語のテキスト 中文分词 한국어 텍스트 عربي עברית हिन्दी "
    "emoji 😀 👍🏽 🇯🇵 tabs\tand\nnewlines\r\n  double  spaces "
    "<|eot_id|> <|begin_of_text|> x=y+z*(a-b)/c {json: [1, 2]} $100.50 "
).split(" ")


def corpus(n: int = 400, seed: int = 0) -> list[str]:
    rng = random.Random(seed)
    return [" ".join(rng.choice(WORDS) for _ in range(rng.randint(3, 30))) for _ in range(n)]


FIXED = [
    "", " ", "  ", "\n", "\n\n\n", "hello world", " hello", "hello  world ",
    "a <mask> b", "a<mask>b", "  <mask>  x", "fox foxes the fox. xfox", "the quick brown",
    "<|pad|> <|pad|>x  <|pad|>", "<|pad|><mask>fox",
    "Hello, World! It's 2024-01-01.", "don't STOP 'S 'll", "1234567890 12 3",
    "naïve café 日本語 😀👍🏽", "tabs\tand\nnewlines\r\n", "x" * 50,
    "<|begin_of_text|>hi<|eot_id|>", "a<|eot_id|>b", " <|eot_id|> ",
    "<|start_header_id|>user<|end_header_id|>\n\nhello<|eot_id|>",
    "emoji 🇯🇵🇯🇵 and ‍ joiners", " nbsp　ideographic",
    "a\x1cb\x1fc", "  leading and trailing  ", "ünïcödé ÇÀ", "Ǆ ǅ ǆ ﬁ",
    # code points Python's Unicode 15.0 tables normalize and HF's keep
    "\U0001e030 \u32ff x\U0001e030\u0301y \U00011938",
]


def _train(tok: Tokenizer, vocab_size: int, specials) -> None:
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=list(specials), show_progress=False,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet() if specials else [],
    )
    tok.train_from_iterator(corpus(), trainer=trainer)


@functools.cache
def byte_level_json() -> str:
    """(a) Llama-3-style: Split + ByteLevel, ignore_merges, specials, BOS."""
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    _train(tok, 600, SPECIALS)
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(
            single="<|begin_of_text|> $A", pair="<|begin_of_text|> $A $B",
            special_tokens=[("<|begin_of_text|>", tok.token_to_id("<|begin_of_text|>"))],
        ),
    ])
    return tok.to_str()


def _with_byte_fallback(data: str) -> str:
    d = json.loads(data)
    vocab = d["model"]["vocab"]
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab))
    d["model"]["byte_fallback"] = True
    d["model"]["fuse_unk"] = True
    return json.dumps(d)


LLAMA2_DECODER = decoders.Sequence([
    decoders.Replace("▁", " "), decoders.ByteFallback(), decoders.Fuse(), decoders.Strip(" ", 1, 0),
])


@functools.cache
def metaspace_json() -> str:
    """(b) Llama-2-style: Metaspace (prepend first) + byte_fallback BPE."""
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="first")
    tok.decoder = LLAMA2_DECODER
    tok.add_special_tokens(["<unk>", "<s>", "</s>"])
    trainer = trainers.BpeTrainer(vocab_size=500, special_tokens=["<unk>", "<s>", "</s>"],
                                  show_progress=False, limit_alphabet=120)
    tok.train_from_iterator(corpus(), trainer=trainer)
    tok.post_processor = processors.TemplateProcessing(
        single="<s> $A", special_tokens=[("<s>", tok.token_to_id("<s>"))])
    return _with_byte_fallback(tok.to_str())


@functools.cache
def prepend_json() -> str:
    """(b2) the same model behind a Prepend + Replace normalizer and no
    pre-tokenizer (the newer Llama-2 tokenizer.json layout)."""
    d = json.loads(metaspace_json())
    d["pre_tokenizer"] = None
    d["normalizer"] = json.loads(normalizers.Sequence([
        normalizers.Prepend("▁"), normalizers.Replace(" ", "▁")]).__getstate__())
    return json.dumps(d)


@functools.cache
def added_tokens_json() -> str:
    """(a2) the byte-level model behind an NFKC normalizer, with added
    tokens that use lstrip / rstrip, single_word and normalized matching."""
    from tokenizers import AddedToken

    tok = Tokenizer.from_str(byte_level_json())
    tok.normalizer = normalizers.NFKC()
    tok.add_tokens([
        AddedToken("<mask>", lstrip=True, rstrip=True, normalized=False),
        AddedToken("fox", single_word=True, normalized=False),
        AddedToken("ｑｕｉｃｋ", normalized=True),
    ])
    tok.add_special_tokens([AddedToken("<|pad|>", lstrip=True, special=True)])
    return tok.to_str()


@functools.cache
def word_level_json() -> str:
    """(c) tests/util.py's WordLevel + Whitespace tokenizer."""
    return make_test_tokenizer().to_json_str()


FAMILIES = {
    "byte_level_bpe": byte_level_json,
    "added_tokens": added_tokens_json,
    "metaspace_bpe": metaspace_json,
    "prepend_bpe": prepend_json,
    "word_level": word_level_json,
}


@functools.cache
def pair(family: str):
    data = FAMILIES[family]()
    return Tokenizer.from_str(data), JsonTokenizer(data)


def assert_same(family: str, text: str) -> None:
    ref, port = pair(family)
    for add in (True, False):
        want = ref.encode(text, add_special_tokens=add)
        got = port.encode(text, add_special_tokens=add)
        assert got.ids == want.ids, (family, text, add)
        assert got.tokens == want.tokens, (family, text, add)
    ids = want.ids
    for skip in (True, False):
        assert port.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_encode_decode_equal_hf_on_fixed_corpus(family):
    for text in FIXED + corpus(60, seed=1):
        assert_same(family, text)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_vocab_surface_equals_hf(family):
    ref, port = pair(family)
    assert port.get_vocab_size() == ref.get_vocab_size()
    for tok in SPECIALS + ["<unk>", "<s>", "the", "Ġthe", "▁the", "nope-not-there"]:
        assert port.token_to_id(tok) == ref.token_to_id(tok)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_of_any_ids_equals_hf(family):
    """Decoding arbitrary id runs: partial UTF-8 byte tokens, byte-fallback
    tokens, specials and ids past the vocab."""
    ref, port = pair(family)
    rng = random.Random(3)
    n = ref.get_vocab_size()
    for _ in range(300):
        ids = [rng.randrange(n + 3) for _ in range(rng.randint(0, 12))]
        for skip in (True, False):
            assert port.decode(ids, skip_special_tokens=skip) == ref.decode(ids, skip_special_tokens=skip)


# letters of many scripts, digits, punctuation, whitespace and newline runs,
# emoji, CJK and special-token text
ALPHABET = st.one_of(
    st.characters(categories=("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Nd", "No", "Pc", "Pd",
                              "Ps", "Pe", "Po", "Sm", "Sc", "So", "Zs")),
    st.sampled_from(list(" \t\n\r 　'") + list("日本語中文한국어😀👍🏽🇯🇵")),
)
TEXT = st.lists(st.one_of(st.text(ALPHABET, max_size=12), st.sampled_from(
    SPECIALS + ["  ", "\n\n", "'s", "<mask>", " <mask> ", "fox", " fox ", "ｑｕｉｃｋ", "quick", "<|pad|>"])),
                max_size=8).map("".join)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(text=TEXT)
def test_encode_decode_equal_hf_on_hypothesis_text(family, text):
    assert_same(family, text)


@pytest.mark.parametrize("family", ["byte_level_bpe", "word_level"])
def test_every_code_point_splits_and_encodes_like_hf(family):
    """Each code point below U+30000 between letters, digits, spaces and a
    newline, 512 code points per text, through the two families whose
    pre-tokenizers use Unicode classes (\\p{L} / \\p{N} / \\s of the
    split pattern, \\w / \\s of Whitespace). Left out: surrogates, and
    code points that Python's Unicode tables leave unassigned (category
    Cn) but the Rust crate's newer tables may assign (U+0897 is a mark
    there, unassigned in Unicode 15.0)."""
    import unicodedata

    ref, port = pair(family)
    cps = [c for c in range(1, 0x30000) if unicodedata.category(chr(c)) not in ("Cs", "Cn")]
    for i in range(0, len(cps), 512):
        text = "".join(f"a{chr(c)}b 1{chr(c)}2 {chr(c)}{chr(c)}\n{chr(c)} " for c in cps[i:i + 512])
        assert port.encode(text).ids == ref.encode(text).ids, hex(cps[i])


COMPONENT_TEXTS = FIXED + ["a1b22c333 4444", "x  y\t\tz", "▁pre▁spaced", "ＡＢＣ ①②③ ﬁ", "e\u0301 é"]


def _pre_tokenizer_cases():
    from tokenizers import pre_tokenizers as P

    cases = [
        P.Whitespace(), P.WhitespaceSplit(), P.Digits(individual_digits=True),
        P.Digits(individual_digits=False), P.ByteLevel(add_prefix_space=True),
        P.ByteLevel(add_prefix_space=False, use_regex=False),
        P.Metaspace(prepend_scheme="always"), P.Metaspace(prepend_scheme="never"),
        P.Metaspace(prepend_scheme="first", split=False),
        P.Sequence([P.Digits(individual_digits=True), P.Whitespace()]),
    ]
    for behavior in ("removed", "isolated", "merged_with_previous", "merged_with_next", "contiguous"):
        for invert in (False, True):
            cases.append(P.Split(" ", behavior, invert=invert))
            cases.append(P.Split(Regex(r"\p{N}+|\s"), behavior, invert=invert))
    return cases


@pytest.mark.parametrize("idx", range(len(_pre_tokenizer_cases())))
def test_pre_tokenizers_split_like_hf(idx):
    from dynamo_tpu_torch.tokenizer_json import _pre_tokenizer

    ref = _pre_tokenizer_cases()[idx]
    port = _pre_tokenizer(json.loads(ref.__getstate__()))
    for text in COMPONENT_TEXTS:
        assert [w for w, _ in port([(text, True)])] == [w for w, _ in ref.pre_tokenize_str(text)], text


@pytest.mark.parametrize("kind", ["NFC", "NFKC", "NFD", "NFKD", "Prepend", "Replace", "Sequence"])
def test_normalizers_normalize_like_hf(kind):
    from dynamo_tpu_torch.tokenizer_json import _normalizer

    ref = {"NFC": normalizers.NFC(), "NFKC": normalizers.NFKC(), "NFD": normalizers.NFD(),
           "NFKD": normalizers.NFKD(), "Prepend": normalizers.Prepend("▁"),
           "Replace": normalizers.Replace(Regex(r"\s+"), "_"),
           "Sequence": normalizers.Sequence([normalizers.NFKC(), normalizers.Replace(" ", "▁")])}[kind]
    port = _normalizer(json.loads(ref.__getstate__()))
    for text in COMPONENT_TEXTS:
        assert port(text) == ref.normalize_str(text), text


DECODER_TOKENS = [
    [], ["▁hi", "▁▁there", "▁"], ["<0xE2>", "<0x82>", "<0xAC>", "x", "<0xE2>"], ["Ġa", "Ċ", "Ġ", "ĠÃ©"],
    ["  sp  ", "▁", "<0x41>", "<0xZZ>", "<0x4>"], ["▁▁", "a▁b▁", "▁"],
]


@pytest.mark.parametrize("kind", ["metaspace_always", "metaspace_first", "metaspace_never", "byte_level",
                                  "byte_fallback", "fuse", "strip", "replace", "sequence"])
def test_decoders_decode_like_hf(kind):
    from dynamo_tpu_torch.tokenizer_json import _decoder

    ref = {
        "metaspace_always": decoders.Metaspace(prepend_scheme="always"),
        "metaspace_first": decoders.Metaspace(prepend_scheme="first"),
        "metaspace_never": decoders.Metaspace(prepend_scheme="never"),
        "byte_level": decoders.ByteLevel(), "byte_fallback": decoders.ByteFallback(),
        "fuse": decoders.Fuse(), "strip": decoders.Strip(" ", 2, 1),
        "replace": decoders.Replace("▁", " "), "sequence": LLAMA2_DECODER,
    }[kind]
    port = _decoder(json.loads(ref.__getstate__()))
    for tokens in DECODER_TOKENS:
        assert "".join(port(list(tokens))) == ref.decode(list(tokens)), tokens


def test_unknown_components_raise_at_load():
    d = json.loads(byte_level_json())
    for key, comp in (("normalizer", {"type": "Lowercase"}), ("pre_tokenizer", {"type": "BertPreTokenizer"}),
                      ("decoder", {"type": "WordPiece"}), ("post_processor", {"type": "RobertaProcessing"}),
                      ("model", {"type": "Unigram", "vocab": []})):
        bad = dict(d, **{key: comp})
        with pytest.raises(ValueError, match=comp["type"]):
            JsonTokenizer(json.dumps(bad))


def test_onig_rewrite_keeps_plain_escapes_and_refuses_what_it_cannot_express():
    assert onig_to_re(r"'s|\r\n|\d+") == r"'s|\r\n|\d+"
    with pytest.raises(ValueError):
        onig_to_re(r"[^\S\p{L}]")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_decode_stream_equals_reference(family):
    data = FAMILIES[family]()
    ref = RefWrapper.from_json_str(data)
    port = PortWrapper.from_json_str(data)
    for text in FIXED[:16] + corpus(10, seed=2):
        ids = ref.encode(text, add_special_tokens=False).ids
        rs, ps = ref.decode_stream(), port.decode_stream()
        assert [ps.step(i) for i in ids] == [rs.step(i) for i in ids], text
    # a random id walk: partial characters held back, then released
    rng = random.Random(5)
    rs, ps = ref.decode_stream(), port.decode_stream()
    for _ in range(200):
        i = rng.randrange(ref.vocab_size)
        assert ps.step(i) == rs.step(i)


# --------------------------------------------------------- sp_tokenizer


def _negative_bos_model() -> bytes:
    """test_negative_trainer_ids_parse_as_disabled's model: bos_id -1."""
    blob = b"".join(sp_cases._piece(*p) for p in sp_cases.BASE)
    trainer = sp_cases._vi(3, 1) + sp_cases._vi(40, 0) + sp_cases._vi(41, (1 << 64) - 1) + sp_cases._vi(42, 2)
    norm = sp_cases._vi(3, 1) + sp_cases._vi(4, 1) + sp_cases._vi(5, 1)
    return blob + sp_cases._ld(2, trainer) + sp_cases._ld(4, norm)


# test_bpe_encode_merges_by_score's pieces
BPE_PIECES = [
    ("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
    ("▁", -5.0, 1), ("a", -6.0, 1), ("b", -6.0, 1),
    ("ab", -1.0, 1), ("▁ab", -0.5, 1), ("abab", -2.0, 1),
] + [(f"<0x{b:02X}>", -20.0, 6) for b in range(256)]

SP_MODELS = {
    "unigram": lambda: sp_cases.make_model(sp_cases.BASE),
    "unigram_no_prefix": lambda: sp_cases.make_model(sp_cases.BASE, add_dummy_prefix=False),
    "bpe": lambda: sp_cases.make_model(sp_cases.BASE, model_type=2),
    "bpe_by_score": lambda: sp_cases.make_model(BPE_PIECES, model_type=2),
    "negative_bos": _negative_bos_model,
}
SP_TEXTS = ["hello world", "hello", "héllo", "abab", "ab ab abab", "helloworld", "  hello   world ",
            "hé wörld ☃", "", "drew"]


@pytest.mark.parametrize("name", sorted(SP_MODELS))
def test_sp_tokenizer_copy_equals_reference(name):
    blob = SP_MODELS[name]()
    ref = ref_sp.SentencePieceTokenizer(ref_sp.parse_model_proto(blob))
    port = port_sp.SentencePieceTokenizer(port_sp.parse_model_proto(blob))
    for text in SP_TEXTS:
        for add in (True, False):
            a, b = ref.encode(text, add_special_tokens=add), port.encode(text, add_special_tokens=add)
            assert (b.ids, b.tokens) == (a.ids, a.tokens)
            for skip in (True, False):
                assert port.decode(b.ids, skip_special_tokens=skip) == ref.decode(a.ids, skip_special_tokens=skip)
    assert port_sp.serialize_model_proto(port.model) == ref_sp.serialize_model_proto(ref.model)
    assert port.get_vocab_size() == ref.get_vocab_size()
    ref_w, port_w = RefWrapper.from_sp_bytes(blob), PortWrapper.from_sp_bytes(blob)
    assert port_w.eos_token_ids == ref_w.eos_token_ids
    assert port_w.kind == ref_w.kind == "sp"


def test_sp_model_dir_wrappers_agree(tmp_path):
    """test_tokenizer_wrapper_from_sp_model_dir's directory: tokenizer.model
    only, EOS from the model, streaming decode."""
    (tmp_path / "tokenizer.model").write_bytes(sp_cases.make_model(sp_cases.BASE))
    ref, port = RefWrapper.from_model_dir(str(tmp_path)), PortWrapper.from_model_dir(str(tmp_path))
    assert port.eos_token_ids == ref.eos_token_ids and port.vocab_size == ref.vocab_size
    ids = ref.encode("hello world", add_special_tokens=False).ids
    assert port.encode("hello world", add_special_tokens=False).ids == ids
    rs, ps = ref.decode_stream(), port.decode_stream()
    assert [ps.step(i) for i in ids] == [rs.step(i) for i in ids]
