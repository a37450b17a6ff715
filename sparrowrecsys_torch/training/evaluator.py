"""Offline evaluator: the port of `sparrowrecsys_tpu/training/evaluator.py`
(`offline/spark/evaluate/Evaluator.scala` parity).

    python -m sparrowrecsys_torch.training.evaluator preds.csv
"""

from __future__ import annotations

import argparse
import csv
from typing import Dict

import numpy as np

from sparrowrecsys_torch.ops.metrics import exact_auc


def evaluate_predictions(scores: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """AUC-PR / AUC-ROC of (score, label) pairs, printed like the
    reference (Evaluator.scala:31-34)."""
    out = exact_auc(np.asarray(scores, np.float64), np.asarray(labels, np.float64))
    print(f"AUC under PR = {out['pr_auc']}")
    print(f"AUC under ROC = {out['roc_auc']}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("predictions_csv", help="CSV with prediction,label columns")
    args = ap.parse_args()
    scores, labels = [], []
    with open(args.predictions_csv, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        pi = header.index("prediction") if "prediction" in header else 0
        li = header.index("label") if "label" in header else 1
        for row in reader:
            scores.append(float(row[pi]))
            labels.append(float(row[li]))
    evaluate_predictions(np.asarray(scores), np.asarray(labels))


if __name__ == "__main__":
    main()
