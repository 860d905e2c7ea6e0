"""data/english.py of the port against the JAX package's.

On a fixture package tree in ``tmp_path`` (two packages of prose and markup
docstrings, as tests/test_english.py builds it), both packages'
``generate_english_corpus`` give identical documents and labels,
``ensure_english_dataset`` writes byte-identical split files, the prose
filter and the tokenizer agree line for line, the harvest's exhaustion is
refused, and the module's ``__main__`` writes the same files. Exact
comparisons: the harvest is deterministic numpy and string code.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from test_english import PROSE, _make_tree
from vae_lagging_encoder_tpu.data import english as jax_english
from vae_lagging_encoder_tpu_torch.data import english

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("kw", [dict(num_sentences=40, vocab_keep=20, mean_len=60.0,
                                     std_len=10.0, seed=7),
                                dict(num_sentences=25, vocab_keep=200, mean_len=30.0,
                                     std_len=12.0, seed=3)])
def test_generate_matches_jax(tmp_path, kw):
    _make_tree(str(tmp_path))
    docs, labels = english.generate_english_corpus(**kw, root=str(tmp_path))
    want_docs, want_labels = jax_english.generate_english_corpus(**kw, root=str(tmp_path))
    assert docs == want_docs and labels == want_labels
    assert len(docs) == kw["num_sentences"]


def test_prose_filter_and_tokenizer_match_jax():
    doc = (">>> code()\n:param x: nope\nThis sentence is real prose "
           "with :class:`Foo.bar` and snake_case and 123 numbers.\nshort\n"
           "        indented_code = 1\n" + PROSE + "\nnaïve café résumé text is here too\n")
    assert list(english._prose_lines(doc)) == list(jax_english._prose_lines(doc))
    for line in doc.splitlines():
        assert english._tokenize(line) == jax_english._tokenize(line)


def test_ensure_dataset_writes_identical_files(tmp_path):
    src = tmp_path / "site"
    _make_tree(str(src))
    got = english.ensure_english_dataset(root=str(tmp_path / "port"), num_sentences=44,
                                         source_root=str(src))
    want = jax_english.ensure_english_dataset(root=str(tmp_path / "jax"), num_sentences=44,
                                              source_root=str(src))
    assert sorted(got) == sorted(want) == ["test", "train", "valid"]
    for split in got:
        assert Path(got[split]).read_bytes() == Path(want[split]).read_bytes(), split
    assert len(Path(got["train"]).read_text().splitlines()) == 40
    before = os.path.getmtime(got["train"])  # idempotent on a complete corpus
    assert english.ensure_english_dataset(root=str(tmp_path / "port"), num_sentences=44,
                                          source_root=str(src)) == got
    assert os.path.getmtime(got["train"]) == before


def test_exhaustion_raises(tmp_path):
    _make_tree(str(tmp_path), n_files=2, n_docs=1)
    with pytest.raises(RuntimeError, match="exhausted"):
        english.generate_english_corpus(num_sentences=10_000, root=str(tmp_path))


def test_main_writes_the_jax_files(tmp_path):
    src = tmp_path / "site"
    _make_tree(str(src))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-m", "vae_lagging_encoder_tpu_torch.data.english",
                        "--num_sentences", "44", "--root", str(tmp_path / "out"),
                        "--source_root", str(src)], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "docs_english" in r.stdout
    want = jax_english.ensure_english_dataset(root=str(tmp_path / "jax"), num_sentences=44,
                                              source_root=str(src))
    for split, path in want.items():
        got = tmp_path / "out" / f"docs_english.{split}.txt"
        assert got.read_bytes() == Path(path).read_bytes(), split
