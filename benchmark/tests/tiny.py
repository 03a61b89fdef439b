"""Small sizes of each cell for the CPU tests: the same code paths at a
few rows (ResNet-50 at 32 x 32, the BiLSTM at 8 hidden units)."""

TINY = {
    "age-r50-agedb.b256": {"data": {"train": 96, "val": 21}, "model": {"img_size": 32},
                           "batch_size": 8, "setup_pass_batches": 1},
    "stsb-bilstm.b128": {"data": {"train": 120, "corpus": {"words": 300}},
                         "recipe": {"d_hid": 8, "d_word": 16}, "batch_size": 8,
                         "setup_pass_batches": 1},
}
SEED = 2 ** 31 + 12345  # more than 32 signed bits hold
