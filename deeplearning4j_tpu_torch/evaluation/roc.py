"""ROC / AUC evaluation — the port's numpy copy of
`deeplearning4j_tpu/evaluation/roc.py`
(`org.nd4j.evaluation.classification.ROC`, `ROCBinary`,
`ROCMultiClass`): streaming (probability, label) pairs; the ROC curve
and AUC, the precision-recall curve and AUPRC; an exact mode
(``threshold_steps=0``: every score kept, a trapezoid over every
distinct threshold) and a thresholded one (a fixed-width histogram).
Inputs are numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import as_numpy


_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2 fallback


def _auc_trapezoid(x: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(x, kind="stable")
    return float(_trapezoid(y[order], x[order]))


class ROC:
    """Binary ROC. `threshold_steps=0` → exact mode (stores all scores)."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        if threshold_steps == 0:
            self._scores: list[np.ndarray] = []
            self._labels: list[np.ndarray] = []
        else:
            # per-bin positive/negative counts; bin i covers
            # [i/steps, (i+1)/steps)
            self._pos = np.zeros(threshold_steps, dtype=np.int64)
            self._neg = np.zeros(threshold_steps, dtype=np.int64)
        self._count = 0

    def eval(self, labels: np.ndarray, predictions: np.ndarray, mask=None) -> None:
        """labels: {0,1} [N] or one-hot [N,2]; predictions: P(class 1), [N] or [N,2]."""
        labels = as_numpy(labels)
        predictions = as_numpy(predictions)
        if labels.ndim > 1 and labels.shape[-1] == 2:
            labels = np.argmax(labels, axis=-1)
        if predictions.ndim > 1 and predictions.shape[-1] == 2:
            predictions = predictions[..., 1]
        labels = labels.reshape(-1).astype(np.int64)
        predictions = predictions.reshape(-1).astype(np.float64)
        if mask is not None:
            m = as_numpy(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        self._count += labels.shape[0]
        if self.threshold_steps == 0:
            self._labels.append(labels)
            self._scores.append(predictions)
        else:
            bins = np.clip(
                (predictions * self.threshold_steps).astype(np.int64),
                0,
                self.threshold_steps - 1,
            )
            np.add.at(self._pos, bins[labels == 1], 1)
            np.add.at(self._neg, bins[labels == 0], 1)

    # -- curves ------------------------------------------------------------
    def _counts_by_threshold(self):
        """Returns (thresholds desc, cum TP, cum FP, total P, total N)."""
        if self.threshold_steps == 0:
            scores = np.concatenate(self._scores) if self._scores else np.empty(0)
            labels = np.concatenate(self._labels) if self._labels else np.empty(0, np.int64)
            if scores.size == 0:
                return scores, np.empty(0, np.int64), np.empty(0, np.int64), 0, 0
            order = np.argsort(-scores, kind="stable")
            scores, labels = scores[order], labels[order]
            tp = np.cumsum(labels == 1)
            fp = np.cumsum(labels == 0)
            # keep the last index of each distinct score
            distinct = np.r_[scores[1:] != scores[:-1], True]
            return scores[distinct], tp[distinct], fp[distinct], int((labels == 1).sum()), int((labels == 0).sum())
        steps = self.threshold_steps
        thresholds = (np.arange(steps)[::-1]) / steps
        tp = np.cumsum(self._pos[::-1])
        fp = np.cumsum(self._neg[::-1])
        return thresholds, tp, fp, int(self._pos.sum()), int(self._neg.sum())

    def roc_curve(self):
        """(fpr, tpr, thresholds) arrays, ascending fpr, endpoints included."""
        thr, tp, fp, p, n = self._counts_by_threshold()
        tpr = tp / p if p else np.zeros_like(tp, dtype=np.float64)
        fpr = fp / n if n else np.zeros_like(fp, dtype=np.float64)
        fpr = np.r_[0.0, fpr, 1.0]
        tpr = np.r_[0.0, tpr, 1.0]
        thr = np.r_[np.inf, thr, -np.inf]
        return fpr, tpr, thr

    def precision_recall_curve(self):
        thr, tp, fp, p, _ = self._counts_by_threshold()
        denom = tp + fp
        prec = np.where(denom > 0, tp / np.maximum(denom, 1), 1.0)
        rec = tp / p if p else np.zeros_like(tp, dtype=np.float64)
        return np.r_[0.0, rec], np.r_[1.0, prec], np.r_[np.inf, thr]

    def calculate_auc(self) -> float:
        fpr, tpr, _ = self.roc_curve()
        return _auc_trapezoid(fpr, tpr)

    def calculate_auprc(self) -> float:
        rec, prec, _ = self.precision_recall_curve()
        return _auc_trapezoid(rec, prec)

    def stats(self) -> str:
        return (
            f"ROC ({'exact' if self.threshold_steps == 0 else f'{self.threshold_steps} steps'}, "
            f"{self._count} examples)\n"
            f"AUC:   {self.calculate_auc():.4f}\n"
            f"AUPRC: {self.calculate_auprc():.4f}"
        )


class ROCBinary:
    """Per-output independent binary ROC (multi-label) — `ROCBinary` role."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: list[ROC] | None = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray, mask=None) -> None:
        labels = as_numpy(labels).reshape(-1, as_numpy(labels).shape[-1])
        predictions = as_numpy(predictions).reshape(labels.shape)
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in range(labels.shape[1])]
        for i, roc in enumerate(self._rocs):
            col_mask = None
            if mask is not None:
                m = as_numpy(mask)
                col_mask = m[:, i] if m.ndim == 2 else m
            roc.eval(labels[:, i], predictions[:, i], mask=col_mask)

    @property
    def num_outputs(self) -> int:
        return len(self._rocs) if self._rocs else 0

    def calculate_auc(self, output: int) -> float:
        return self._rocs[output].calculate_auc()

    def calculate_auprc(self, output: int) -> float:
        return self._rocs[output].calculate_auprc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs])) if self._rocs else 0.0

    def stats(self) -> str:
        lines = [f"ROCBinary ({self.num_outputs} outputs)"]
        for i, r in enumerate(self._rocs or []):
            lines.append(f"  output {i}: AUC {r.calculate_auc():.4f}  AUPRC {r.calculate_auprc():.4f}")
        lines.append(f"  average AUC: {self.calculate_average_auc():.4f}")
        return "\n".join(lines)


class ROCMultiClass:
    """One-vs-all ROC per class over softmax outputs — `ROCMultiClass` role."""

    def __init__(self, threshold_steps: int = 0):
        self.threshold_steps = threshold_steps
        self._rocs: list[ROC] | None = None

    def eval(self, labels: np.ndarray, predictions: np.ndarray, mask=None) -> None:
        predictions = as_numpy(predictions)
        k = predictions.shape[-1]
        predictions = predictions.reshape(-1, k)
        labels = as_numpy(labels)
        if labels.ndim == predictions.ndim and labels.shape[-1] == k:
            labels = np.argmax(labels.reshape(-1, k), axis=-1)
        labels = labels.reshape(-1).astype(np.int64)
        if self._rocs is None:
            self._rocs = [ROC(self.threshold_steps) for _ in range(k)]
        for c, roc in enumerate(self._rocs):
            roc.eval((labels == c).astype(np.int64), predictions[:, c], mask=mask)

    @property
    def num_classes(self) -> int:
        return len(self._rocs) if self._rocs else 0

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs])) if self._rocs else 0.0

    def stats(self) -> str:
        lines = [f"ROCMultiClass ({self.num_classes} classes)"]
        for i, r in enumerate(self._rocs or []):
            lines.append(f"  class {i}: AUC {r.calculate_auc():.4f}")
        lines.append(f"  average AUC: {self.calculate_average_auc():.4f}")
        return "\n".join(lines)
