"""Build the age suites' meta CSVs from the raw corpora.

The counterpart of the JAX package's ``tools/create_age_meta.py`` (the
reference's ``imdb-wiki-dir/data/create_imdb_wiki.py`` and
``agedb-dir/data/create_agedb.py``), with no pandas: rows are written by the
``csv`` module.

- IMDB-WIKI: the age from the Matlab date-of-birth ordinal and the photo's
  year (a photo taken mid-year), rows kept where the face score reaches
  ``--min_score``, there is no second face, and the age is in [0, 200];
- AgeDB: the age parsed from the ``<id>_<name>_<age>_<gender>.jpg`` name.

Writes ``<data_path>/meta/{imdb_wiki,agedb}.csv`` (``age,path``), the input
of ``tools/make_balanced_splits.py``.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.create_age_meta imdb_wiki \\
        --data_path ./data [--min_score 1.0]
    python -m imbalanced_regression_tpu_torch.tools.create_age_meta agedb --data_path ./data
"""

from __future__ import annotations

import argparse
import csv
import os
from datetime import datetime

import numpy as np


def calc_age(photo_year: int, dob_ordinal: float) -> int:
    """Age at photo time from a Matlab serial date number; photos assumed
    taken mid-year (``create_imdb_wiki.py:10-16``)."""
    birth = datetime.fromordinal(max(int(dob_ordinal) - 366, 1))
    return photo_year - birth.year - (0 if birth.month < 7 else 1)


def write_rows(path: str, fields, rows) -> str:
    """``rows`` (dicts) as a CSV with a header of ``fields``, ``\\n`` line
    ends as pandas writes them."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(fields), lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    return path


def create_imdb_or_wiki(data_path: str, db: str, min_score: float = 1.0) -> list[dict]:
    """The kept rows of ``<db>_crop/<db>.mat`` as ``{"age", "path"}``."""
    from scipy.io import loadmat

    meta = loadmat(os.path.join(data_path, f"{db}_crop", f"{db}.mat"))[db][0, 0]
    full_path = meta["full_path"][0]
    dob = meta["dob"][0]
    photo_taken = meta["photo_taken"][0]
    face_score = meta["face_score"][0]
    second_face_score = meta["second_face_score"][0]

    rows = []
    for i in range(len(face_score)):
        if face_score[i] < min_score:
            continue
        if not np.isnan(second_face_score[i]) and second_face_score[i] > 0.0:
            continue
        age = calc_age(photo_taken[i], dob[i])
        if not 0 <= age <= 200:
            continue
        rows.append({"age": age, "path": full_path[i][0]})
    return rows


def create_imdb_wiki(data_path: str, min_score: float = 1.0) -> str:
    rows = []
    for db in ("imdb", "wiki"):
        rows += [{"age": r["age"], "path": f"{db}_crop/{r['path']}"}
                 for r in create_imdb_or_wiki(data_path, db, min_score)]
    return write_rows(os.path.join(data_path, "meta", "imdb_wiki.csv"), ("age", "path"), rows)


def create_agedb(data_path: str) -> str:
    rows = []
    for filename in sorted(os.listdir(os.path.join(data_path, "AgeDB"))):
        parts = filename.split(".")[0].split("_")
        if len(parts) != 4:
            continue
        rows.append({"age": parts[2], "path": f"AgeDB/{filename}"})
    return write_rows(os.path.join(data_path, "meta", "agedb.csv"), ("age", "path"), rows)


def main(argv=None):
    parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("dataset", choices=["imdb_wiki", "agedb"])
    parser.add_argument("--data_path", type=str, default="./data")
    parser.add_argument("--min_score", type=float, default=1.0)
    args = parser.parse_args(argv)
    if args.dataset == "imdb_wiki":
        out = create_imdb_wiki(args.data_path, args.min_score)
    else:
        out = create_agedb(args.data_path)
    print(f"Wrote {out}")
    return out


if __name__ == "__main__":
    main()
