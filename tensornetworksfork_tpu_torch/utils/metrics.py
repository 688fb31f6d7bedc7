"""Metrics and the results-file protocol (port of
tensornetworksfork_tpu/utils/metrics.py: rmse, r2_score, accuracy,
balanced_accuracy, error_rate, append_results_csv). Inputs are numpy arrays or anything np.asarray takes.
"""
from __future__ import annotations

import csv
import os
from datetime import datetime
from typing import Dict

import numpy as np


def rmse(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    return float(np.sqrt(np.mean((y_true - y_pred) ** 2)))


def r2_score(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - y_true.mean(axis=0)) ** 2)
    return float(1 - ss_res / ss_tot)


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.ndim > 1 and y_true.shape[-1] > 1:
        y_true = y_true.argmax(-1)
    if y_pred.ndim > 1 and y_pred.shape[-1] > 1:
        y_pred = y_pred.argmax(-1)
    return float(np.mean(y_true == y_pred))


def balanced_accuracy(y_true, y_pred) -> float:
    """The mean over the true classes of each class's accuracy."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.ndim > 1 and y_true.shape[-1] > 1:
        y_true = y_true.argmax(-1)
    if y_pred.ndim > 1 and y_pred.shape[-1] > 1:
        y_pred = y_pred.argmax(-1)
    accs = [np.mean(y_pred[y_true == c] == c) for c in np.unique(y_true)]
    return float(np.mean(accs))


def error_rate(y_true, y_pred) -> float:
    return 1.0 - accuracy(y_true, y_pred)


def append_results_csv(results: Dict, path: str) -> None:
    """Append one result row, creating the file and header when missing;
    a row with new keys rewrites the file under the extended header."""
    results = dict(results)
    results["timestamp"] = datetime.now().isoformat()
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    existing_fields = None
    if os.path.exists(path):
        with open(path, newline="") as f:
            existing_fields = next(csv.reader(f), None)
    # an existing but empty file reads a None header: treat it as missing
    has_header = existing_fields is not None
    # a copy, so that appending new keys leaves existing_fields as read
    fields = list(existing_fields) if has_header else list(results.keys())
    for k in results:
        if k not in fields:
            fields.append(k)
    rows = []
    rewrite = has_header and existing_fields != fields
    if rewrite:
        # rows longer than the header surface under DictReader's None key,
        # which DictWriter refuses: drop it
        with open(path, newline="") as f:
            rows = [{k: v for k, v in r.items() if k is not None}
                    for r in csv.DictReader(f)]
    mode = "a" if (has_header and not rewrite) else "w"
    with open(path, mode, newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        if mode == "w":
            writer.writeheader()
            for r in rows:
                writer.writerow(r)
        writer.writerow({k: results.get(k, "") for k in fields})
