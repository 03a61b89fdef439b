"""Render a ``# %%`` cell script into an executed .ipynb.

The port's counterpart of the JAX package's ``tools/make_notebook.py``,
with neither ``nbformat`` nor ``nbclient`` (the H100 machine has neither):
the script's cells (``# %% [markdown]`` blocks become markdown cells,
``# %%`` blocks code cells) are written as nbformat-v4 JSON with the
``json`` module, and the code cells run top to bottom in one namespace in
this process, with ``sys.argv`` set to ``[script, "--device", device]``;
each cell's standard output becomes its ``stream`` output. A cell that
raises stops the tool with a non-zero exit, and no notebook is written.

Usage::

    python -m imbalanced_regression_tpu_torch.tools.make_notebook \\
        imbalanced_regression_tpu_torch/tutorial/tutorial.py \\
        imbalanced_regression_tpu_torch/tutorial/tutorial.ipynb [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys

_CELL_RE = re.compile(r"^# %%(?: \[(\w+)\])?\s*$")


def parse_percent_script(text: str) -> list[tuple[str, str]]:
    """Split percent-format source into (kind, source) cells."""
    cells: list[tuple[str, list[str]]] = []
    kind = None
    for line in text.splitlines():
        m = _CELL_RE.match(line)
        if m:
            kind = m.group(1) or "code"
            cells.append((kind, []))
            continue
        if not cells:  # preamble before the first marker -> code cell
            cells.append(("code", []))
        cells[-1][1].append(line)

    out = []
    for kind, lines in cells:
        if kind == "markdown":
            # strip the comment prefix jupytext-style
            lines = [re.sub(r"^# ?", "", ln) for ln in lines]
        src = "\n".join(lines).strip("\n")
        if src:
            out.append((kind, src))
    return out


def build_notebook(cells: list[tuple[str, str]]) -> dict:
    """An nbformat-v4.5 notebook (a dict) of ``cells``, code cells without
    outputs."""
    nb_cells = []
    for i, (kind, src) in enumerate(cells):
        cell = {"cell_type": kind, "id": f"cell-{i}", "metadata": {},
                "source": src.splitlines(keepends=True)}
        if kind == "code":
            cell.update(execution_count=None, outputs=[])
        nb_cells.append(cell)
    return {"cells": nb_cells,
            "metadata": {"kernelspec": {"display_name": "Python 3", "language": "python",
                                        "name": "python3"},
                         "language_info": {"name": "python",
                                           "version": sys.version.split()[0]}},
            "nbformat": 4, "nbformat_minor": 5}


def execute(nb: dict, script: str, device: str) -> dict:
    """Run ``nb``'s code cells in order in one namespace, as ``script`` run
    with ``--device device``; each cell's standard output becomes its
    ``stream`` output. An exception in a cell propagates."""
    namespace = {"__name__": "__main__", "__file__": os.path.abspath(script)}
    argv = sys.argv
    sys.argv = [script, "--device", device]
    try:
        count = 0
        for cell in nb["cells"]:
            if cell["cell_type"] != "code":
                continue
            count += 1
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                exec(compile("".join(cell["source"]), f"<cell {count}>", "exec"), namespace)
            cell["execution_count"] = count
            text = out.getvalue()
            cell["outputs"] = [{"name": "stdout", "output_type": "stream",
                                "text": text.splitlines(keepends=True)}] if text else []
    finally:
        sys.argv = argv
    return nb


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--no-execute", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the device the script's cells run on")
    args = p.parse_args(argv)

    with open(args.src) as f:
        nb = build_notebook(parse_percent_script(f.read()))
    if not args.no_execute:
        execute(nb, args.src, args.device)
    with open(args.dst, "w") as f:
        json.dump(nb, f, indent=1, ensure_ascii=False)
        f.write("\n")
    n_out = sum(len(c.get("outputs", [])) for c in nb["cells"])
    print(f"wrote {args.dst}: {len(nb['cells'])} cells, {n_out} outputs")


if __name__ == "__main__":
    main(sys.argv[1:])
