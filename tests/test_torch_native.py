# -*- coding: utf-8 -*-
"""The port's native WordPiece tokenizer (``drin_tpu_torch/native``): its ids
equal the port's Python path and ``drin_tpu``'s tokenizer (its Python path,
and its native one where that library is built) over a seeded corpus of
punctuation, accents, CJK, control characters, astral code points and long
words; the source is the JAX package's own; the build is keyed by the
source, atomic under concurrent builds, and raises with the compiler's
output when it fails."""

import threading

import numpy as np
import pytest

from drin_tpu.text import wordpiece as jwp
from drin_tpu_torch import native
from drin_tpu_torch.text import wordpiece as twp

WORDS = ["Paris", "river", "walking", "walked", "runs", "Obama", "U.S.", "state-of-art", "x86",
         "(note)", "naïve", "Café", "Müller", "ÉCOLE", "东京", "日本語", "k-pop", "zzqx",
         "über", "façade", "3:45", "e-mail", "C++", "«quoted»", "don't", "–dash–"]
ODD = ["\x00", "\x07", "\x1b", "​", "�", "\xa0", "　", "\t", "\n", "🙂", "𝒜",
       "\ud800", "ﬁ", "ＡＢＣ", "a" * 101, "b" * 100, "!!!", "--", "__", "́"]


def _corpus(seed):
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(60):
        parts = [str(rng.choice(WORDS)) for _ in range(rng.integers(0, 14))]
        if rng.random() < 0.4:  # one odd character, glued to a word or apart
            odd = str(rng.choice(ODD))
            at = int(rng.integers(0, len(parts) + 1))
            parts.insert(at, odd)
        sep = "" if rng.random() < 0.15 else " "
        texts.append(sep.join(parts))
    return texts + ["", "   ", "emoji 🙂 astral 𝒜", "nul\x00byte", "a" * 101, "b" * 100]


def _vocab(corpus):
    basic = jwp.BasicTokenizer(False)
    words = sorted({w for t in corpus for w in basic.tokenize(t)})
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    # a third of the words whole; the rest split into pieces or become [UNK]
    for w in words[::3] + ["walk", "##ing", "##ed", "run", "##s", "Par", "##is", "b" * 100,
                           "##e", "##a", "##r", "ü", "##ber"]:
        vocab.setdefault(w, len(vocab))
    return vocab


@pytest.mark.parametrize("seed", range(3))
def test_native_ids_equal_python_and_jax(seed):
    corpus = _corpus(seed)
    vocab = _vocab(corpus)
    ours = twp.BertTokenizer(vocab=vocab, model_max_length=16)
    assert ours._native is not None  # the native pass is taken, not skipped
    python = twp.BertTokenizer(vocab=vocab, model_max_length=16)
    python._native = None
    theirs = jwp.BertTokenizer(vocab=vocab, model_max_length=16)
    jax_py = jwp.BertTokenizer(vocab=vocab, model_max_length=16)
    jax_py._native = None
    refs = [python, jax_py] + ([theirs] if theirs._native is not None else [])
    rows = ours._native.encode_ids_batch([str(t) for t in corpus])
    assert sum(r is None for r in rows) >= 3  # astral, removed, surrogate: per-text Python
    assert sum(r is not None for r in rows) >= 40
    for ref in refs:
        for trunc in (False, True):
            assert ours.encode_batch(corpus, truncation=trunc) == ref.encode_batch(
                corpus, truncation=trunc)
        for text in corpus[:20]:
            assert ours.encode(text, truncation=True) == ref.encode(text, truncation=True)
        for kw in (dict(), dict(padding="max_length", truncation=True),
                   dict(padding="max_length", truncation=True, max_length=24)):
            got, want = ours(corpus, **kw), ref(corpus, **kw)
            for key in want:
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key], err_msg=f"{kw} {key}")


def test_wordpiece_native_matches_python():
    corpus = _corpus(7)
    vocab = _vocab(corpus)
    words = [w for t in corpus for w in jwp.BasicTokenizer(False).tokenize(t)]
    wp = native.WordPieceNative(native.vocab_buffer(vocab), unk_id=vocab["[UNK]"])
    py = twp.WordPieceTokenizer(vocab)
    assert wp.tokenize_ids(words) == [vocab[t] for w in words for t in py.tokenize(w)]
    assert wp.tokenize_ids([]) == []


def test_which_path_is_taken():
    vocab = _vocab(_corpus(0))
    assert twp.BertTokenizer(vocab=vocab)._native is not None
    assert twp.BertTokenizer(vocab=vocab, do_lower_case=True)._native is None
    # ids not 0..n-1, or a token holding a newline: the vocab cannot be handed
    # to the native pass, and the Python rules give the ids
    gap = dict(vocab, extra=len(vocab) + 3)
    assert native.vocab_buffer(gap) is None and native.vocab_buffer({"a\nb": 0}) is None
    tok = twp.BertTokenizer(vocab=gap)
    assert tok._native is None
    assert tok.encode("Paris walking") == jwp.BertTokenizer(vocab=gap).encode("Paris walking")


def test_source_is_the_jax_packages():
    from pathlib import Path

    theirs = Path(jwp.__file__).resolve().parents[1] / "native" / "src" / "wordpiece.cpp"
    assert native.SRC.read_bytes() == theirs.read_bytes()


def test_build_is_keyed_by_the_source_and_atomic(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    other = tmp_path / "wordpiece.cpp"
    other.write_bytes(native.SRC.read_bytes() + b"\n// another source\n")
    assert native.library_path() != native.library_path(other)
    assert native.library_path(other).parent == tmp_path / "build"
    # four builds of one source at once: each compiles into a file of its
    # own and renames it into place, and every one of them ends with a loadable
    # library under the one name
    outs, errors = [], []

    def build_once():
        try:
            outs.append(native.build(other))
        except Exception as e:  # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build_once) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(outs)) == 1 and outs[0].exists()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [outs[0].name]
    import ctypes

    assert ctypes.CDLL(str(outs[0])).drin_wp_build


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    broken = tmp_path / "wordpiece.cpp"
    broken.write_text(native.SRC.read_text() + "\nint broken( {\n")
    with pytest.raises(RuntimeError, match="building the native tokenizer failed") as err:
        native.build(broken)
    assert "error" in str(err.value) and "broken" in str(err.value)
    assert not native.library_path(broken).exists()
    assert [p for p in (tmp_path / "build").iterdir()] == []  # no temporary left behind
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.build(broken)
