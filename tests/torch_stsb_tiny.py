"""Tiny STS-B inputs shared by the ``tests/test_torch_stsb_*.py`` files: TSVs
in the GLUE STS-B layout and token arrays made from a seed."""

import os

import numpy as np

WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta", "can't",
         "(iota)", "kappa,", "\"lambda\"", "mu.", "$5", "10%", "gonna", "nu...", "xi's"]


def write_tiny_tsvs(data_dir, n_train=24, n_eval=8, seed=0):
    """GLUE STS-B layout: 10 tab-separated columns, sentence 1, sentence 2
    and score at 7, 8, 9, one header row; words with quotes, contractions,
    parentheses, ellipses, ``$`` and ``%`` for the tokenizer; one row with
    an empty score and one with too few columns, which the loader skips."""
    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)

    def rows(n):
        out = []
        for _ in range(n):
            s1 = " ".join(rng.choice(WORDS, rng.integers(3, 9))) + "."
            s2 = " ".join(rng.choice(WORDS, rng.integers(3, 9)))
            score = float(np.round(rng.uniform(0, 5), 3))
            out.append("\t".join(["x"] * 7 + [s1, s2, str(score)]))
        return out + ["\t".join(["x"] * 7 + ["no score", "here", ""]), "too\tfew"]

    for fname, n in (("train_new.tsv", n_train), ("dev_new.tsv", n_eval), ("test_new.tsv", n_eval)):
        with open(os.path.join(data_dir, fname), "w", encoding="utf-8") as fh:
            fh.write("header\n" + "\n".join(rows(n)) + "\n")


def token_batch(rng, n, steps, vocab_size):
    """Token ids and masks [n, steps] with lengths 1..steps (row 0 the full
    length), ids in [2, vocab_size) on the valid prefix and 0 after it."""
    lengths = rng.integers(1, steps + 1, n)
    lengths[0] = steps
    mask = (np.arange(steps)[None] < lengths[:, None]).astype(np.float32)
    tokens = rng.integers(2, vocab_size, (n, steps)).astype(np.int32) * mask.astype(np.int32)
    return tokens, mask


def pair_input(rng, n, steps1, steps2, vocab_size):
    """A pair batch whose two columns are padded to different lengths."""
    t1, m1 = token_batch(rng, n, steps1, vocab_size)
    t2, m2 = token_batch(rng, n, steps2, vocab_size)
    return {"tokens1": t1, "mask1": m1, "tokens2": t2, "mask2": m2}
