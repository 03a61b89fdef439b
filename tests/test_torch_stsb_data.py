"""The port's STS-B data layer held equal to the JAX package's on the CPU:
the endless batch streams and nested batches of ``data/batching.py``, the
Treebank tokenizer copy against NLTK's, and ``load_tsv``, ``build_vocab``,
``index_and_pad``, ``load_glove`` and ``load_stsb_datasets`` (with its
cache) on TSVs the test writes. Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
from torch_stsb_tiny import WORDS, write_tiny_tsvs

from imbalanced_regression_tpu.data import batching as jbatching
from imbalanced_regression_tpu.data import stsb as jstsb
from imbalanced_regression_tpu.tasks.stsb import STSConfig as JSTSConfig
from imbalanced_regression_tpu_torch.data import batching, stsb
from imbalanced_regression_tpu_torch.data.treebank import treebank_tokenize
from imbalanced_regression_tpu_torch.tasks.stsb import STSConfig

HARD_STRINGS = [
    'He said, "I can\'t go."',
    "They'll save and invest more.",
    "hi, my name can't hello,",
    "We're gonna wanna gimme lemme gotta do it cannot.",
    "'Tis the season; 'twas the night.",
    "Good muffins cost $3.88\nin New York.  Please buy me\ntwo of them.\nThanks.",
    "(roughly 3,36 euros) [brackets] {braces} <angles>",
    "Wait... what?! Really -- yes.",
    "The dog's bone, the dogs' bones, I'd, I'm, you've, we'd, she's.",
    "``Quoted'' and 'single' quotes 'here' .",
    "50% off: only $5 @ store #1 & co.",
    "Mr. Smith went to Washington.",
    "He said 'no.'",
    "D'ye ken more'n gonna?",
    "A trailing period after a quote.\"",
    "",
]


def _nested(n):
    return {
        "input": {"tokens1": np.arange(n * 3).reshape(n, 3), "mask1": np.ones((n, 3), np.float32),
                  "tokens2": np.arange(n * 2).reshape(n, 2), "mask2": np.ones((n, 2), np.float32)},
        "target": np.arange(n, dtype=np.float32)[:, None],
        "bucket_idx": np.arange(n) % 5,
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n,batch,seed,start", [(50, 8, 3, 0), (50, 8, 3, 13), (7, 16, 1, 0),
                                                (7, 16, 1, 5), (64, 16, 0, 9)])
def test_infinite_streams_match_jax(n, batch, seed, start):
    """Index and gathered streams over 3 epochs and more, restarts included;
    n < batch gives one short batch an epoch on both sides."""
    data = _nested(n)
    ours = batching.infinite_index_batches(n, batch, seed, start)
    theirs = jbatching.infinite_index_batches(n, batch, seed, start)
    ours_b = batching.infinite_batches(data, batch, seed, start)
    theirs_b = jbatching.infinite_batches(data, batch, seed, start)
    for _ in range(3 * max(n // batch, 1) + 2):
        (idx, e), (jidx, je) = next(ours), next(theirs)
        assert e == je
        np.testing.assert_array_equal(idx, jidx)
        (b, e), (jb, je) = next(ours_b), next(theirs_b)
        assert e == je
        _assert_tree_equal(b, jb)


def test_nested_batches_match_jax():
    data = _nested(10)
    ours = list(batching.batch_iterator(data, 4, rng=np.random.default_rng(2)))
    theirs = list(jbatching.batch_iterator(data, 4, rng=np.random.default_rng(2)))
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        _assert_tree_equal(a, b)
    ours, theirs = list(batching.eval_batches(data, 4)), list(jbatching.eval_batches(data, 4))
    assert [b["count"] for b in ours] == [4, 4, 2]
    for a, b in zip(ours, theirs):
        _assert_tree_equal(a, b)
    assert batching._num_examples(data) == 10


def test_tokenizer_copy_matches_nltk(tmp_path):
    nltk_tokenize = pytest.importorskip("nltk.tokenize").TreebankWordTokenizer().tokenize
    for text in HARD_STRINGS + [" ".join(WORDS)]:
        assert treebank_tokenize(text) == nltk_tokenize(text), text
    write_tiny_tsvs(str(tmp_path))
    for name in ("train_new.tsv", "dev_new.tsv", "test_new.tsv"):
        for line in (tmp_path / name).read_text().splitlines():
            for col in line.split("\t"):
                assert treebank_tokenize(col) == nltk_tokenize(col), col


@pytest.fixture
def tsvs(tmp_path, monkeypatch):
    """Tiny TSVs, and a fresh home for the JAX package's tokenization cache
    (the port's goes there too unless ``cache_dir`` is set)."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    # the JAX loader tokenizes with word_tokenize where punkt data is
    # installed; the port always runs the Treebank rules
    monkeypatch.setattr(jstsb, "_tokenizer", lambda: treebank_tokenize)
    data_dir = tmp_path / "data"
    write_tiny_tsvs(str(data_dir), n_train=30, n_eval=10)
    return data_dir


def test_tsv_vocab_index_match_jax(tsvs):
    path = str(tsvs / "train_new.tsv")
    for max_len in (40, 4):
        ours, theirs = stsb.load_tsv(path, max_len), jstsb.load_tsv(path, max_len)
        assert ours[0] == theirs[0] and ours[1] == theirs[1]
        np.testing.assert_array_equal(np.asarray(ours[2]), np.asarray(theirs[2]))
        assert len(ours[2]) == 30  # the two malformed rows are skipped
    s1, s2, _ = stsb.load_tsv(path)
    for cap in (30000, 5):
        vocab = stsb.build_vocab([s1, s2], cap)
        assert vocab == jstsb.build_vocab([s1, s2], cap)
        for max_len in (40, 3):
            for got, want in zip(stsb.index_and_pad(s1, vocab, max_len),
                                 jstsb.index_and_pad(s1, vocab, max_len)):
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype


def test_load_glove_matches_jax(tmp_path):
    vocab = {"@@PADDING@@": 0, "@@UNKNOWN@@": 1, "alpha": 2, "beta": 3, "gamma": 4}
    rng = np.random.default_rng(0)
    path = tmp_path / "glove.txt"
    lines = [w + " " + " ".join(f"{v:.5f}" for v in rng.normal(size=6)) for w in
             ("beta", "notinvocab", "alpha", "@@UNKNOWN@@")]
    path.write_text("\n".join(lines) + "\n")
    for p in (str(path), "", str(tmp_path / "missing.txt")):
        got, want = stsb.load_glove(vocab, p, d_word=6), jstsb.load_glove(vocab, p, d_word=6)
        np.testing.assert_array_equal(got, want)
        assert not got[0].any()  # the padding row is zeroed
    with_file = stsb.load_glove(vocab, str(path), d_word=6)
    np.testing.assert_array_equal(with_file[2], np.array(lines[2].split()[1:], np.float32))


def test_load_stsb_datasets_matches_jax(tsvs, tmp_path):
    kw = dict(max_seq_len=6, d_word=8, reweight="inverse", lds=True, word_embs_file="")
    ours = stsb.load_stsb_datasets(str(tsvs), STSConfig(**kw))
    theirs = jstsb.load_stsb_datasets(str(tsvs), dataclasses.replace(JSTSConfig(), **kw))
    for got, want in zip(ours[:3], theirs[:3]):
        _assert_tree_equal(got, want)
    np.testing.assert_array_equal(ours[3], theirs[3])
    assert ours[4] == theirs[4]
    assert set(ours[0]) == {"input", "target", "bucket_idx", "weight"}
    cache = tmp_path / "home" / ".cache" / "imbalanced_regression_tpu_torch"
    assert len(list(cache.glob("stsb_*.pkl"))) == 1
    # a second load reads the cache; a cache_dir moves it
    again = stsb.load_stsb_datasets(str(tsvs), STSConfig(**kw))
    _assert_tree_equal(again[0], ours[0])
    moved = stsb.load_stsb_datasets(str(tsvs), STSConfig(cache_dir=str(tmp_path / "c"), **kw))
    _assert_tree_equal(moved[0], ours[0])
    assert len(list((tmp_path / "c").glob("stsb_*.pkl"))) == 1
