"""The port's native text reader (data/native.py, csrc/textproc.cpp) against
its plain version, the port's Python reader, and against the JAX package's
``data/native.py``: the same vocabulary, ids and labels, bit for bit (the
cases of tests/test_native.py:24-98).
"""
import numpy as np
import pytest

from vae_lagging_encoder_tpu.data import MonoTextData as JaxText
from vae_lagging_encoder_tpu.data import Vocab as JaxVocab
from vae_lagging_encoder_tpu.data import native as jax_native
from vae_lagging_encoder_tpu.data.synthetic import generate_synthetic_corpus
from vae_lagging_encoder_tpu_torch.data import MonoTextData, Vocab, native
from vae_lagging_encoder_tpu_torch.data.vocab import BOS_ID, EOS_ID, UNK_ID


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    sents, topics = generate_synthetic_corpus(num_sentences=500, vocab_size=80, min_len=3,
                                              max_len=25, seed=9)
    path = tmp_path_factory.mktemp("corpus") / "train.txt"
    path.write_text("".join(f"{t}\t{' '.join(s)}\n" for t, s in zip(topics, sents)))
    return str(path), sents, topics


def _same(a, b):
    assert a.vocab.word2id == b.vocab.word2id
    assert a.data == b.data
    assert a.labels == b.labels


def test_native_builds_into_build_dir():
    path = native.build()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("textproc-") and path.suffix == ".so"
    assert native.library() is native.library()


def test_vocab_parity(corpus_file):
    path, sents, _ = corpus_file
    v = Vocab.from_file(path, label=True)
    assert v.word2id == Vocab.from_file(path, label=True, native=False).word2id
    assert v.word2id == Vocab.from_corpus(sents).word2id
    assert v.word2id == JaxVocab.from_file(path, label=True).word2id


def test_encode_parity(corpus_file):
    path, sents, topics = corpus_file
    d = MonoTextData(path, label=True)
    _same(d, MonoTextData(path, label=True, native=False))
    assert d.labels == list(topics) and len(d) == len(sents)
    j = JaxText(path, label=True)
    assert jax_native.available()
    assert (d.vocab.word2id, d.data, d.labels) == (j.vocab.word2id, j.data, j.labels)


def test_unk_mapping(corpus_file, tmp_path):
    path, _, _ = corpus_file
    v = Vocab.from_file(path, label=True)
    other = tmp_path / "other.txt"
    other.write_text("0\tw0 NEVERSEENWORD w1\n")
    d = MonoTextData(str(other), label=True, vocab=v)
    assert d.data[0] == [BOS_ID, v["w0"], UNK_ID, v["w1"], EOS_ID]
    _same(d, MonoTextData(str(other), label=True, vocab=v, native=False))


def test_no_label_mode(tmp_path):
    p = tmp_path / "plain.txt"
    p.write_text("a b c\nb c d\n\n")  # an empty line is skipped
    d = MonoTextData(str(p))
    assert len(d) == 2 and d.labels is None
    assert d.data[0][1:-1] == [d.vocab["a"], d.vocab["b"], d.vocab["c"]]
    _same(d, MonoTextData(str(p), native=False))
    assert d.data == JaxText(str(p)).data


def test_edge_lines_match_python_and_jax(tmp_path):
    """Labeled lines with an empty or blank body are dropped, a non-numeric
    label parses as 0 (strtol), a line without a tab has label -1, a blank
    line is skipped, and U+00A0 is no separator."""
    path = str(tmp_path / "edge.txt")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("3\thello world\n")
        fh.write("7\t\n")
        fh.write("7\t   \n")
        fh.write("pos\tgreat movie\n")
        fh.write("\n")
        fh.write("no tab line\n")
        fh.write("-2\tfoo bar baz\n")
        fh.write("9\tlast one\n")
    d = MonoTextData(path, label=True)
    _same(d, MonoTextData(path, label=True, native=False))
    assert d.labels == [3, 0, -1, -2, 9]
    assert "foo bar" in d.vocab.word2id
    j = JaxText(path, label=True)
    assert (d.vocab.word2id, d.data, d.labels) == (j.vocab.word2id, j.data, j.labels)


def test_nul_and_non_ascii_bytes_inside_words(tmp_path):
    """A word may hold a NUL byte (a docstring's literal ``\\0``) or
    non-ASCII UTF-8; the vocabulary blob is read by length, not up to a
    NUL, so the native reader keeps both as the Python reader does."""
    path = tmp_path / "odd.txt"
    path.write_bytes("0\thello w\x00rld foo\n1\tbär foo caf\u00e9\n".encode("utf-8"))
    d = MonoTextData(str(path), label=True)
    _same(d, MonoTextData(str(path), label=True, native=False))
    assert "w\x00rld" in d.vocab.word2id and "bär" in d.vocab.word2id


def test_batches_equal_python_reader(corpus_file):
    path, _, _ = corpus_file
    for a, b in zip(MonoTextData(path, label=True).create_data_batch(16),
                    MonoTextData(path, label=True, native=False).create_data_batch(16)):
        for x, y in zip((a.tokens, a.mask, a.row_weight), (b.tokens, b.mask, b.row_weight)):
            np.testing.assert_array_equal(x, y)


def test_failed_read_raises(tmp_path):
    with pytest.raises(OSError, match="tp_count_vocab"):
        native.count_vocab(str(tmp_path / "missing.txt"), True)
    with pytest.raises(OSError, match="tp_encode_corpus"):
        native.encode_corpus(str(tmp_path / "missing.txt"), True, ["a"], UNK_ID, 4)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent switch to the Python reader: a build that fails raises."""
    bad = tmp_path / "textproc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", [])
    with pytest.raises(RuntimeError, match="build failed"):
        MonoTextData(str(bad), label=False)
