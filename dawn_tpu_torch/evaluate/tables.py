"""LaTeX results tables over eval metrics (the PBnet paper-artifact layer).

A copy of ``dawn_tpu/evaluate/tables.py`` (the port imports nothing of the
JAX package); the same metrics files give the same LaTeX.

Capability parity with PBnet/src/evaluate/tables/ (12 generators —
maketable, archtable, kltable, losstable, latexmodel*, ...). They all share
one core: ``format_table`` (maketable.py:42-95) — per-metric formatter
selection with threshold-driven Green/Mahogany colorization against the
ground-truth value — wrapped in a standalone booktabs document with an
arrow header row (↑ higher-better, ↓ lower-better, → closer-to-GT-better,
maketable.py:11-19) and a ground-truth first row.

``format_table`` here is a semantics-exact port (parity-tested against the
executed reference function in tests/test_tables.py and
held to this copy in tests/test_torch_eval_metrics.py). The collector is
redesigned for this framework's artifact: instead of globbing torch
experiment folders for evaluation pickles (maketable.py:106-170), it takes
the ``metrics.json`` files written by ``python -m dawn_tpu_torch.scripts.eval_pbnet``
(evaluate/stgcn_eval.py's keys) — ``{seed: {metric: value}}`` with ``*_pred`` /
``*_gt`` suffix pairs — averages over seeds, and emits one row per run.

Usage: ``python -m dawn_tpu_torch.evaluate.tables run1/metrics.json
[run2/metrics.json ...] -o table.tex`` (run name = parent dir name).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Mapping, Optional, Sequence

UP = r"$\uparrow$"
DOWN = r"$\downarrow$"
RIGHT = r"$\rightarrow$"

# metric base name -> direction arrow (maketable.py:14-19; fid/accuracy from
# the action2motion group, l1 plays the reference's "rc" reconstruction
# role, smoothness is this framework's extra — closer-to-GT like
# acceleration)
ARROWS = {
    "accuracy": UP,
    "acceleration": RIGHT,
    "l1": DOWN,
    "rc": DOWN,
    "fid": DOWN,
    "diversity": RIGHT,
    "multimodality": RIGHT,
    "smoothness": RIGHT,
}

GREEN = "Green"
RED = "Mahogany"


def bold(string: str) -> str:
    return r"\textbf{{" + string + r"}}"


def colorize_template(string: str, color: str) -> str:
    return r"\textcolor{{" + color + r"}}{{" + string + r"}}"


def colorize_bold_template(string: str, color: str) -> str:
    return bold(colorize_template(string, color))


def format_table(val, gtval, mname: str) -> str:
    """One formatted cell — exact port of maketable.py:42-95.

    ``mname`` is the metric base name ('rc' and 'l1' share the
    reconstruction rules); colorization compares against ``gtval`` where
    the reference does.
    """
    value = float(val)

    try:
        exp = math.floor(math.log10(value))
    except ValueError:
        exp = 0
        value = 0

    if mname in ("rc", "l1"):
        formatter = "{:.1e}"
        if value >= 1:
            formatter = colorize_bold_template(formatter, RED)

    elif mname in ("diversity", "multimodality"):
        formatter = "{:.1e}" if exp < -1 else "{:.3g}"
        if gtval is not None:
            gtval = float(gtval)
            if value > 0.8 * gtval:
                formatter = colorize_bold_template(formatter, GREEN)
            elif value < 0.3 * gtval:
                formatter = colorize_bold_template(formatter, RED)

    elif mname == "accuracy":
        formatter = "{:.1%}"
        if value > 0.65:
            formatter = colorize_bold_template(formatter, GREEN)
        elif value < 0.35:
            formatter = colorize_bold_template(formatter, RED)

    elif mname == "acceleration":
        formatter = "{:.1e}"
        if gtval is not None:
            gtval = float(gtval)
            diff = math.log10(value / gtval)
            if diff < 0.05:
                formatter = colorize_bold_template(formatter, GREEN)
            elif diff > 0.3:
                formatter = colorize_bold_template(formatter, RED)

    else:
        formatter = "{:.2f}"

    formatter = bold(formatter)
    return formatter.format(value).replace("%", r"\%")


def _mean_over_seeds(metrics_json: Mapping) -> Dict[str, float]:
    """{seed: {metric: value}} (eval_pbnet.py layout) -> seed-mean metrics.
    A flat {metric: value} dict passes through unchanged."""
    vals = list(metrics_json.values())
    if not vals or not isinstance(vals[0], Mapping):
        return {k: float(v) for k, v in metrics_json.items()}
    out: Dict[str, float] = {}
    for key in vals[0]:
        nums = [float(m[key]) for m in vals if key in m]
        out[key] = sum(nums) / len(nums)
    return out


def _base_name(key: str) -> str:
    for prefix in ("stgcn_",):
        if key.startswith(prefix):
            key = key[len(prefix):]
    for suffix in ("_pred", "_gen", "_gt", "_test", "_train"):
        if key.endswith(suffix):
            key = key[: -len(suffix)]
    return key


def _columns(runs: Mapping[str, Mapping[str, float]]) -> Sequence[str]:
    """Ordered metric columns: every key that has a pred/gen value in any
    run, keeping first-seen order, GT-only keys excluded."""
    cols = []
    for metrics in runs.values():
        for key in metrics:
            if key.endswith("_gt") or key.endswith("_train"):
                continue
            if key not in cols:
                cols.append(key)
    return cols


def _gt_key(col: str) -> Optional[str]:
    for suffix in ("_pred", "_gen", "_test"):
        if col.endswith(suffix):
            return col[: -len(suffix)] + "_gt"
    return col + "_gt"


def make_table(runs: Mapping[str, Mapping[str, float]],
               title: str = "Evaluation") -> str:
    """Standalone booktabs LaTeX doc: arrow header row, ground-truth row,
    one row per run (the reference's table shape, maketable.py:171-249)."""
    cols = _columns(runs)
    any_run = next(iter(runs.values()))

    header = [""]
    gtrow = ["ground truth"]
    for col in cols:
        base = _base_name(col)
        header.append(f"{col.replace('_', r'\_')} {ARROWS.get(base, '')}")
        gt = None
        for metrics in runs.values():
            gt = metrics.get(_gt_key(col), gt)
        gtrow.append(format_table(gt, None, base) if gt is not None else "")

    body = [" & ".join(gtrow) + r"\\", r"\midrule"]
    for name, metrics in runs.items():
        row = [name.replace("_", r"\_")]
        for col in cols:
            if col in metrics:
                gt = metrics.get(_gt_key(col))
                row.append(format_table(metrics[col], gt, _base_name(col)))
            else:
                row.append("")
        body.append(" & ".join(row) + r"\\")
    body.append(r"\bottomrule")

    ncols = len(cols) + 1
    return "\n".join([
        r"\documentclass{standalone}",
        r"\usepackage{booktabs}",
        r"\usepackage[dvipsnames]{xcolor}",
        r"\begin{document}",
        r"\begin{tabular}{" + "l" + "c" * (ncols - 1) + "}",
        r"\multicolumn{" + str(ncols) + r"}{c}{" + title + r"} \\",
        " & ".join(header) + r"\\",
        r"\midrule",
        "\n".join(body),
        r"\end{tabular}",
        r"\end{document}",
    ]) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> str:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("metrics", nargs="+",
                    help="metrics.json files (eval_pbnet.py / stgcn_eval.py)")
    ap.add_argument("-o", "--out", default="table.tex")
    ap.add_argument("--title", default="Evaluation")
    args = ap.parse_args(argv)

    runs = {}
    for path in args.metrics:
        with open(path) as f:
            metrics = json.load(f)
        name = os.path.basename(os.path.dirname(os.path.abspath(path))) \
            or os.path.basename(path)
        runs[name] = _mean_over_seeds(metrics)

    tex = make_table(runs, title=args.title)
    with open(args.out, "w") as f:
        f.write(tex)
    print(f"Table saved at {args.out}")
    return args.out


if __name__ == "__main__":
    main()
