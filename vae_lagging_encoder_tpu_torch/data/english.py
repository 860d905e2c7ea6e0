"""Real-English corpus harvested from installed-package docstrings.

The port's own copy of ``vae_lagging_encoder_tpu/data/english.py`` (numpy
only; the same source tree and seed give identical documents, labels and
files). The reference trains on real natural language (Yahoo Answers, Yelp
reviews: ~20k-word vocabulary, ~80-100-token documents), which cannot be
fetched offline. This module builds a corpus of real English from the
docstrings of the installed Python packages: AST-extracted, filtered to
prose lines, tokenized Yahoo-style (lowercased, punctuation split out,
digit runs collapsed to ``_num``), packed into ~100-token documents, and
vocab-capped with a literal ``_unk`` token.

The harvest is deterministic for a fixed installed-package set: files are
walked in sorted order, shuffled with a seeded RNG, and parsed until the
document budget is met. ``ensure_english_dataset`` writes the splits once
(same idempotent / refuse-partial semantics as the synthetic corpora). The
training entry points do not build it; the counterpart of
``prepare_data.py --dataset docs_english`` is

    python -m vae_lagging_encoder_tpu_torch.data.english [--num_sentences N]
        [--root datasets/docs_english_data] [--source_root DIR]
"""
from __future__ import annotations

import ast
import os
import re
import sysconfig
import warnings
from collections import Counter
from typing import Iterator, List, Tuple

import numpy as np

from .synthetic import _ensure_splits

# Lines that open rst/sphinx fields, doctests, or directives — never prose.
_MARKUP = re.compile(
    r"^\s*(>>>|\.\.\.|\.\. |:[a-zA-Z]+ ?[a-zA-Z_0-9*]*:|@|Args:|Returns:|"
    r"Raises:|Attributes:|Parameters$|-{3,}|={3,}|\*{3,}|#|\|)")
_WORD = re.compile(r"[a-z]+|[0-9]+|[^\sa-z0-9]")


def _prose_lines(doc: str) -> Iterator[str]:
    """Keep docstring lines that read as English prose.

    Drops doctest/code blocks (8+ space indent), rst field lists and
    directives, and symbol-heavy lines (signatures, tables, ascii art).
    """
    for line in doc.splitlines():
        if _MARKUP.match(line) or line.startswith("        "):
            continue
        stripped = line.strip()
        words = re.findall(r"[A-Za-z]{2,}", stripped)
        if len(words) < 4:
            continue
        # prose is mostly alphabetic: require word chars to dominate
        if sum(len(w) for w in words) < 0.55 * len(stripped.replace(" ", "")):
            continue
        yield stripped


def _tokenize(text: str) -> List[str]:
    """Yahoo-preprocessing-style tokens: lowercase, punctuation as its own
    token, digit runs collapsed to ``_num`` (underscores and backticks are
    identifier/markup glue, not prose punctuation — dropped).

    Known limitation (kept: the corpora written so far are pinned to this
    tokenizer): the word class is ASCII-only, so the occasional accented
    word fragments ('naïve' -> 'na', 'ï', 've'); frequency ranking keeps
    such fragments out of the vocab head, so the effect on the 20k vocab
    is marginal."""
    text = re.sub(r":[a-zA-Z~._]+:", " ", text)  # sphinx inline roles
    toks = _WORD.findall(text.replace("_", " ").replace("`", " ").lower())
    return ["_num" if t[0].isdigit() else t for t in toks]


def _iter_prose_tokens(root: str, seed: int) -> Iterator[Tuple[str, List[str]]]:
    """Yield (top_level_package, tokens) per docstring, files in seeded
    random order so packages interleave."""
    files = []
    for dirpath, _dirs, fs in os.walk(root):
        files.extend(os.path.join(dirpath, f) for f in fs
                     if f.endswith(".py"))
    files.sort()
    np.random.RandomState(seed).shuffle(files)
    for path in files:
        pkg = os.path.relpath(path, root).split(os.sep)[0]
        try:
            with open(path, encoding="utf-8", errors="replace") as fh, \
                    warnings.catch_warnings():
                # old sources' invalid escapes: a warning per file, no effect
                warnings.simplefilter("ignore", SyntaxWarning)
                tree = ast.parse(fh.read())
        except (SyntaxError, ValueError, OSError):
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
                doc = ast.get_docstring(node)
                if not doc:
                    continue
                toks = _tokenize(" ".join(_prose_lines(doc)))
                if len(toks) >= 8:
                    yield pkg, toks


def generate_english_corpus(
    num_sentences: int = 22000,
    vocab_keep: int = 19996,
    mean_len: float = 100.0,
    std_len: float = 28.0,
    seed: int = 783435,
    root: str | None = None,
) -> Tuple[List[List[str]], List[int]]:
    """Harvest ``num_sentences`` real-English documents of ~``mean_len``
    tokens from installed-package docstrings.

    Documents pack consecutive docstrings (from the seeded-shuffled file
    stream) up to a per-document target length ~N(mean_len, std_len) —
    mirroring the reference corpora's document-length distribution — so
    each document is locally coherent (one package's prose) while the
    corpus spans hundreds of packages. Tokens outside the ``vocab_keep``
    most frequent become the literal ``_unk`` (the reference corpora ship
    pre-UNKed at ~20k vocab). Labels = frequency rank of the document's
    source package (top 9 packages → 1..9, rest 0); like the reference's
    topic labels they ride along in the file format and are unused by
    training."""
    root = root or sysconfig.get_paths()["purelib"]
    rng = np.random.RandomState(seed)
    lens = np.clip(rng.normal(mean_len, std_len, num_sentences),
                   max(12, mean_len - 2.7 * std_len),
                   mean_len + 2.9 * std_len).astype(int)

    docs: List[List[str]] = []
    pkgs: List[str] = []
    cur: List[str] = []
    cur_pkg = ""
    for pkg, toks in _iter_prose_tokens(root, seed):
        if not cur:
            # a document is labeled by the package that STARTS it; a doc
            # crossing a file boundary can contain a second package's
            # prose, so labels are approximate (unused by training —
            # cfg.label defaults to auto; kept for the reference's --label
            # surface, not for classification-grade supervision)
            cur_pkg = pkg
        cur.extend(toks)
        if len(cur) >= lens[len(docs)]:
            docs.append(cur[: int(lens[len(docs)])])
            pkgs.append(cur_pkg)
            cur = []
            if len(docs) == num_sentences:
                break
    if len(docs) < num_sentences:
        raise RuntimeError(
            f"harvest exhausted {root} at {len(docs)}/{num_sentences} "
            "documents; lower num_sentences or point root at more text")

    counts = Counter(t for d in docs for t in d)
    keep = {w for w, _ in counts.most_common(vocab_keep)}
    docs = [[t if t in keep else "_unk" for t in d] for d in docs]

    top = [p for p, _ in Counter(pkgs).most_common(9)]
    labels = [top.index(p) + 1 if p in top else 0 for p in pkgs]
    order = rng.permutation(num_sentences)
    return [docs[i] for i in order], [labels[i] for i in order]


def ensure_english_dataset(name: str = "docs_english",
                           root: str | None = None,
                           seed: int = 783435,
                           num_sentences: int = 22000,
                           source_root: str | None = None) -> dict:
    """Write the harvested real-English corpus under
    ``datasets/<name>_data/`` (20k/1k/1k split at the default size), the
    same layout the yahoo/yelp configs expect. Idempotent on a complete
    corpus; refuses to overwrite a partial one (``_ensure_splits``)."""
    root = root or f"datasets/{name}_data"
    n_eval = max(1, num_sentences // 22)
    splits = {"train": slice(0, num_sentences - 2 * n_eval),
              "valid": slice(num_sentences - 2 * n_eval,
                             num_sentences - n_eval),
              "test": slice(num_sentences - n_eval, num_sentences)}
    return _ensure_splits(
        root, name, splits,
        lambda: generate_english_corpus(num_sentences=num_sentences,
                                        seed=seed, root=source_root))


def main(argv: List[str] | None = None) -> int:
    """Write the corpus splits (``ensure_english_dataset``) and print their paths."""
    import argparse

    p = argparse.ArgumentParser(description="build the docs_english corpus")
    p.add_argument("--num_sentences", type=int, default=22000)
    p.add_argument("--seed", type=int, default=783435)
    p.add_argument("--root", type=str, default=None,
                   help="output directory (default datasets/docs_english_data)")
    p.add_argument("--source_root", type=str, default=None,
                   help="package tree to harvest (default: this Python's site-packages)")
    a = p.parse_args(argv)
    paths = ensure_english_dataset(root=a.root, seed=a.seed, num_sentences=a.num_sentences,
                                   source_root=a.source_root)
    print(f"docs_english (harvested real-English corpus) -> {paths['train']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
