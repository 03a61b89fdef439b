"""STS-B-DIR data pipeline: TSV loading, tokenization, vocabulary, GloVe
table, LDS weights, padded token arrays.

The JAX package's ``data/stsb.py`` (reference ``sts-b-dir/preprocess.py``,
``tasks.py``), in plain numpy:

- tokenization: the Treebank tokenizer (:mod:`data.treebank`, a copy of
  NLTK's), truncated to ``max_seq_len`` (``tasks.py:9-11``);
- vocabulary: ``@@PADDING@@`` = 0, ``@@UNKNOWN@@`` = 1, then the
  ``max_vocab_size`` most frequent train+val+test tokens
  (``preprocess.py:99-108``);
- embeddings: random normal, overwritten row by row from a GloVe text file
  when there is one, the padding row zeroed (``preprocess.py:110-125``);
- LDS weights by :func:`ops.lds.prepare_weights_hist` (``tasks.py:44-73``)
  and FDS bucket indices by :func:`ops.binning.bin_index_hist_np`;
- the tokenized splits and the vocabulary are cached in a pickle keyed by
  the TSVs' names, times and sizes.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
from collections import Counter

import numpy as np

from imbalanced_regression_tpu_torch.data.treebank import treebank_tokenize
from imbalanced_regression_tpu_torch.ops.binning import bin_index_hist_np
from imbalanced_regression_tpu_torch.ops.lds import prepare_weights_hist

logger = logging.getLogger(__name__)

PAD_TOKEN = "@@PADDING@@"
UNK_TOKEN = "@@UNKNOWN@@"
PAD_IDX = 0
UNK_IDX = 1
SPLIT_FILES = (("train", "train_new.tsv"), ("val", "dev_new.tsv"), ("test", "test_new.tsv"))


def load_tsv(path: str, max_seq_len: int = 40, s1_idx: int = 7, s2_idx: int = 8,
             targ_idx: int = 9, skip_rows: int = 1):
    """Parse one STS TSV into (sentence-1 tokens, sentence-2 tokens,
    targets); rows with an empty sentence or score, or too few columns,
    are skipped."""
    sent1s, sent2s, targs = [], [], []
    with open(path, encoding="utf-8") as fh:
        for _ in range(skip_rows):
            fh.readline()
        for row in fh:
            cols = row.rstrip("\n").split("\t")
            try:
                s1 = treebank_tokenize(cols[s1_idx])[:max_seq_len]
                if not cols[targ_idx] or not s1:
                    continue
                s2 = treebank_tokenize(cols[s2_idx])[:max_seq_len]
                if not s2:
                    continue
                sent1s.append(s1)
                sent2s.append(s2)
                targs.append(np.float32(cols[targ_idx]))
            except (IndexError, ValueError) as e:
                logger.info("skipping row in %s: %s", path, e)
    return sent1s, sent2s, targs


def build_vocab(token_lists, max_vocab_size: int = 30000) -> dict[str, int]:
    counts = Counter()
    for sents in token_lists:
        for sent in sents:
            counts.update(sent)
    vocab = {PAD_TOKEN: PAD_IDX, UNK_TOKEN: UNK_IDX}
    # a stable sort by count: ties keep the order of first appearance
    for word, _ in sorted(counts.items(), key=lambda kv: kv[1], reverse=True)[:max_vocab_size]:
        if word not in vocab:
            vocab[word] = len(vocab)
    return vocab


def load_glove(vocab: dict[str, int], path: str, d_word: int = 300, seed: int = 111) -> np.ndarray:
    """Random-normal table [len(vocab), d_word] with the GloVe rows of the
    vocabulary's words where ``path`` exists; the padding row zeroed."""
    table = np.random.RandomState(seed).randn(len(vocab), d_word).astype(np.float32)
    if path and os.path.exists(path):
        found = 0
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                word, vec = line.split(" ", 1)
                idx = vocab.get(word, UNK_IDX)
                if idx != UNK_IDX:
                    table[idx] = np.array(vec.split(), dtype=np.float32)
                    found += 1
        logger.info("GloVe: initialized %d/%d rows from %s", found, len(vocab), path)
    else:
        logger.info("GloVe file %r not found — training embeddings from scratch", path)
    table[PAD_IDX] = 0.0
    return table


def index_and_pad(sents, vocab, max_seq_len: int = 40):
    """Token ids [N, max_seq_len] int32 (0 = padding, 1 = unknown) and the
    mask [N, max_seq_len] float32."""
    tokens = np.full((len(sents), max_seq_len), PAD_IDX, np.int32)
    mask = np.zeros((len(sents), max_seq_len), np.float32)
    for i, sent in enumerate(sents):
        for j, w in enumerate(sent[:max_seq_len]):
            tokens[i, j] = vocab.get(w, UNK_IDX)
            mask[i, j] = 1.0
    return tokens, mask


def _cache_path(data_dir: str, max_seq_len: int, max_vocab: int, cache_dir: str = "") -> str:
    files = [os.path.join(data_dir, f) for _, f in SPLIT_FILES]
    sig = json.dumps([max_seq_len, max_vocab] +
                     [[f, os.path.getmtime(f), os.path.getsize(f)] for f in files])
    digest = hashlib.sha1(sig.encode()).hexdigest()[:16]
    cache_dir = cache_dir or os.path.join(os.path.expanduser("~"), ".cache",
                                          "imbalanced_regression_tpu_torch")
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"stsb_{digest}.pkl")


def _load_and_tokenize(data_dir: str, max_seq_len: int, max_vocab: int, cache_dir: str = ""):
    """Tokenized splits, targets and vocabulary, cached on disk."""
    cache = _cache_path(data_dir, max_seq_len, max_vocab, cache_dir)
    if os.path.exists(cache):
        with open(cache, "rb") as fh:
            logger.info("STS-B preprocessing cache hit: %s", cache)
            return pickle.load(fh)
    sents, targets = {}, {}
    for split, fname in SPLIT_FILES:
        s1, s2, targs = load_tsv(os.path.join(data_dir, fname), max_seq_len)
        sents[split] = (s1, s2)
        targets[split] = np.asarray(targs, np.float32)
        logger.info("%s: %d pairs", split, len(targs))
    vocab = build_vocab([sents[s][i] for s in ("train", "val", "test") for i in (0, 1)], max_vocab)
    payload = (sents, targets, vocab)
    try:
        with open(cache, "wb") as fh:
            pickle.dump(payload, fh)
    except OSError as e:
        logger.info("STS-B cache write failed (%s)", e)
    return payload


def load_stsb_datasets(data_dir: str, config) -> tuple[dict, dict, dict, np.ndarray, dict]:
    """Returns (train, val, test, embedding table, vocab). Each split is
    ``{"input": {"tokens1", "mask1", "tokens2", "mask2"}, "target" [N, 1],
    "bucket_idx" [N]}``, the train split also with ``"weight"`` [N, 1]. The
    preprocessing cache lives in ``config.cache_dir`` when it is set, else
    under ``~/.cache/imbalanced_regression_tpu_torch``."""
    max_seq_len = getattr(config, "max_seq_len", 40)
    sents, splits, vocab = _load_and_tokenize(
        data_dir, max_seq_len, getattr(config, "max_word_v_size", 30000),
        getattr(config, "cache_dir", ""))
    emb = load_glove(vocab, getattr(config, "word_embs_file", ""), getattr(config, "d_word", 300))

    out = {}
    for split, _ in SPLIT_FILES:
        t1, m1 = index_and_pad(sents[split][0], vocab, max_seq_len)
        t2, m2 = index_and_pad(sents[split][1], vocab, max_seq_len)
        targs = splits[split]
        out[split] = {
            "input": {"tokens1": t1, "mask1": m1, "tokens2": t2, "mask2": m2},
            "target": targs[:, None],
            "bucket_idx": bin_index_hist_np(targs, config.bucket_num, config.bucket_start),
        }

    w = prepare_weights_hist(
        splits["train"], config.reweight, bucket_num=config.bucket_num,
        lds=config.lds, lds_kernel=config.lds_kernel, lds_ks=config.lds_ks,
        lds_sigma=config.lds_sigma,
    )
    n = len(splits["train"])
    out["train"]["weight"] = w[:, None] if w is not None else np.ones((n, 1), np.float32)
    return out["train"], out["val"], out["test"], emb, vocab
