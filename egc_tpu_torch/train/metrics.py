"""Task metrics on the host, in numpy (counterpart of
``egc_tpu.train.metrics``; the reference delegates them to the OGB
evaluators).

- ``accuracy``: ogbn-arxiv / mag evaluator semantics (exact-match rate).
- ``roc_auc``: ogbg-molhiv evaluator (binary ROC-AUC) by the Mann-Whitney
  U statistic with average tie ranks, as ``sklearn.roc_auc_score`` gives
  on binary labels.
- ``sequence_f1``: ogbg-code2 evaluator: per-sample set-overlap precision,
  recall and F1 of the decoded token sequences, averaged.
- ``split_accuracies``: the full-graph evaluation, the argmax accuracy of
  each split's rows, computed on the tensors' device and read once.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def accuracy(pred_labels, true_labels) -> float:
    return float((np.asarray(pred_labels) == np.asarray(true_labels)).mean())


def roc_auc(scores, labels) -> float:
    """Binary ROC-AUC (labels in {0, 1}), average ranks for ties; NaN with
    one class only."""
    scores = np.asarray(scores, dtype=np.float64).ravel()
    labels = np.asarray(labels).ravel()
    pos = labels == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def sequence_f1(seq_pred: Sequence[List], seq_ref: Sequence[List]) -> float:
    """OGB code2 F1: set-overlap precision, recall and F1 per sample,
    averaged (0 for no samples)."""
    f1s = []
    for p, r in zip(seq_pred, seq_ref):
        ps, rs = set(p), set(r)
        tp = len(ps & rs)
        prec = tp / len(ps) if ps else 0.0
        rec = tp / len(rs) if rs else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0)
    return float(np.mean(f1s)) if f1s else 0.0


def split_accuracies(out: torch.Tensor, y: torch.Tensor,
                     masks: dict) -> dict:
    """``{split}_acc`` for train / val / test: the share of each split's
    rows whose argmax over ``out [N, C]`` is the label (0 for an empty
    split), with one read from the device."""
    splits = ("train", "val", "test")
    hit = out.argmax(dim=-1) == y
    accs = torch.stack([(hit & masks[s]).sum() / masks[s].sum().clamp(min=1)
                        for s in splits])
    return {f"{s}_acc": float(v) for s, v in zip(splits, accs.cpu())}
