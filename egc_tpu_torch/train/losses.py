"""Loss helpers (counterpart of ``egc_tpu.train.losses``)."""

from __future__ import annotations

import torch


def gather_label_scores(out: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """``out[i, labels[i]]`` for scores ``out [N, C]``; returns [N]."""
    return out.gather(1, labels.long()[:, None])[:, 0]


def nll_scores(out: torch.Tensor, labels: torch.Tensor, *,
               log_probs: bool = True) -> torch.Tensor:
    """Per-row NLL: ``-out[y]`` for log-probabilities, ``lse(out) - out[y]``
    for raw logits."""
    s = gather_label_scores(out, labels)
    if log_probs:
        return -s
    return torch.logsumexp(out, dim=-1) - s
