"""Corpus-internal word embeddings for STS-B (a GloVe stand-in that needs
no download).

The counterpart of the JAX package's ``tools/corpus_embeddings.py``, which
the port copies (it imports nothing of JAX but its ``load_tsv``; here the
port's ``data/stsb.py``). The reference initializes its frozen embedding
table from GloVe 840B.300d (``sts-b-dir/preprocess.py:110-125``); this tool
builds vectors from the train split itself by the count-based recipe of
Levy, Goldberg & Dagan (TACL 2015): positional co-occurrence counts → PPMI
with context-distribution smoothing → truncated SVD.

The output is a GloVe-format text file (``word v1 .. v300`` a line) for the
frozen-embedding path: ``--glove 1 --word_embs_file <out>``
(``data/stsb.py::load_glove`` fills the matching vocabulary rows). Only the
train split feeds the counts.

Recipe (the paper's recommendations): a window of ±5 with 1/distance
weights; PPMI with context-distribution smoothing alpha = 0.75; a rank-300
truncated SVD, embeddings U * S^0.5; rows rescaled so the mean L2 norm is
``--target_norm`` (GloVe-like, ~5).

Usage::

    python -m imbalanced_regression_tpu_torch.tools.corpus_embeddings \
        --data_dir <dir with train_new.tsv> --out runs/sts_emb/corpus_vectors.txt
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from collections import Counter

import numpy as np

from imbalanced_regression_tpu_torch.data.stsb import load_tsv

logger = logging.getLogger(__name__)


def cooccurrence_counts(sentences, window: int = 5, min_count: int = 2):
    """(vocab list, sparse-dict counts): harmonically weighted symmetric
    co-occurrence counts within ``window`` tokens, over words with corpus
    frequency >= ``min_count``."""
    freq = Counter()
    for sent in sentences:
        freq.update(sent)
    words = sorted(w for w, c in freq.items() if c >= min_count)
    index = {w: i for i, w in enumerate(words)}
    counts: Counter = Counter()
    for sent in sentences:
        ids = [index.get(w, -1) for w in sent]
        for i, wi in enumerate(ids):
            if wi < 0:
                continue
            for d in range(1, window + 1):
                j = i + d
                if j >= len(ids):
                    break
                wj = ids[j]
                if wj < 0:
                    continue
                w = 1.0 / d  # harmonic distance weighting (GloVe)
                counts[(wi, wj)] += w
                counts[(wj, wi)] += w
    return words, counts


def ppmi_matrix(n: int, counts, cds: float = 0.75):
    """Dense PPMI matrix with context-distribution smoothing.

    PPMI(w, c) = max(0, log( p(w,c) / (p(w) * p_alpha(c)) )) with
    p_alpha(c) = #(c)^alpha / sum_c #(c)^alpha — the smoothing that rescues
    rare-context PMI estimates (Levy et al. 2015, §3.2)."""
    m = np.zeros((n, n), np.float64)
    for (i, j), c in counts.items():
        m[i, j] = c
    total = m.sum()
    if total == 0:
        return m.astype(np.float32)
    row = m.sum(axis=1) / total
    col = m.sum(axis=0) ** cds
    col = col / col.sum()
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log((m / total) / np.outer(row, col))
    pmi[~np.isfinite(pmi)] = 0.0
    return np.maximum(pmi, 0.0).astype(np.float32)


def svd_embeddings(ppmi: np.ndarray, dim: int, seed: int = 0) -> np.ndarray:
    """Rank-``dim`` embeddings U * S^0.5 from the PPMI matrix (deterministic)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.linalg import svds

    k = min(dim, ppmi.shape[0] - 1)
    rng = np.random.RandomState(seed)
    u, s, _ = svds(csr_matrix(ppmi.astype(np.float64)), k=k,
                   v0=rng.rand(ppmi.shape[0]))
    order = np.argsort(-s)  # svds returns ascending singular values
    u, s = u[:, order], s[order]
    emb = (u * np.sqrt(s)).astype(np.float32)
    if k < dim:  # tiny corpora: zero-pad to the requested width
        emb = np.pad(emb, ((0, 0), (0, dim - k)))
    return emb


def build_corpus_embeddings(sentences, dim: int = 300, window: int = 5,
                            min_count: int = 2, cds: float = 0.75,
                            target_norm: float = 5.0, seed: int = 0):
    """Full pipeline: sentences -> (words, [len(words), dim] float32)."""
    words, counts = cooccurrence_counts(sentences, window, min_count)
    logger.info("corpus embeddings: %d words (min_count=%d), %d nonzero pairs",
                len(words), min_count, len(counts))
    emb = svd_embeddings(ppmi_matrix(len(words), counts, cds), dim, seed)
    norms = np.linalg.norm(emb, axis=1)
    mean_norm = norms[norms > 0].mean() if np.any(norms > 0) else 1.0
    emb *= target_norm / mean_norm
    return words, emb


def write_glove_format(path: str, words, emb: np.ndarray) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        for w, vec in zip(words, emb):
            fh.write(w + " " + " ".join(f"{v:.5f}" for v in vec) + "\n")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data_dir", required=True,
                   help="directory containing train_new.tsv")
    p.add_argument("--out", required=True, help="output text file (GloVe format)")
    p.add_argument("--dim", type=int, default=300)
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--min_count", type=int, default=2)
    p.add_argument("--cds", type=float, default=0.75)
    p.add_argument("--target_norm", type=float, default=5.0)
    p.add_argument("--max_seq_len", type=int, default=40,
                   help="match the model's truncation (sts-b-dir/tasks.py:9-11)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s | %(message)s")
    s1, s2, _ = load_tsv(os.path.join(args.data_dir, "train_new.tsv"),
                         args.max_seq_len)
    sentences = s1 + s2
    logger.info("train corpus: %d sentences", len(sentences))
    words, emb = build_corpus_embeddings(
        sentences, dim=args.dim, window=args.window, min_count=args.min_count,
        cds=args.cds, target_norm=args.target_norm, seed=args.seed)
    write_glove_format(args.out, words, emb)
    logger.info("wrote %d x %d vectors to %s", len(words), emb.shape[1], args.out)
    return args.out


if __name__ == "__main__":
    main(sys.argv[1:])
