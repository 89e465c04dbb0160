"""Classification evaluation — the port's numpy copy of
`deeplearning4j_tpu/evaluation/evaluation.py` (the
`org.nd4j.evaluation.classification.Evaluation` role).

Streaming confusion-matrix accumulation over batches; accuracy, per-class
precision/recall/F1, macro averages, top-N accuracy — the reference's
stats() surface.  The port keeps its own copy although the JAX module
imports only numpy: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import as_numpy


class Evaluation:
    def __init__(self, num_classes: int | None = None, top_n: int = 1):
        self.num_classes = num_classes
        self.top_n = top_n
        self._confusion: np.ndarray | None = None
        self._top_n_correct = 0
        self._count = 0

    def _ensure(self, n: int) -> None:
        if self._confusion is None:
            k = self.num_classes or n
            self._confusion = np.zeros((k, k), dtype=np.int64)
            self.num_classes = k

    def eval(self, labels: np.ndarray, predictions: np.ndarray, mask=None) -> None:
        """labels: one-hot [N,K] or int [N]; predictions: probabilities [N,K]."""
        labels = as_numpy(labels)
        predictions = as_numpy(predictions)
        self._ensure(predictions.shape[-1])
        if labels.ndim == predictions.ndim:
            true = np.argmax(labels, axis=-1)
        else:
            true = labels.astype(np.int64)
        pred = np.argmax(predictions, axis=-1)
        true, pred = true.reshape(-1), pred.reshape(-1)
        probs2d = predictions.reshape(-1, predictions.shape[-1])
        if mask is not None:
            m = as_numpy(mask).reshape(-1).astype(bool)
            true, pred, probs2d = true[m], pred[m], probs2d[m]
        np.add.at(self._confusion, (true, pred), 1)
        self._count += true.shape[0]
        if self.top_n > 1:
            top = np.argsort(-probs2d, axis=-1)[:, : self.top_n]
            self._top_n_correct += int(np.sum(top == true[:, None]))
        else:
            self._top_n_correct += int(np.sum(pred == true))

    # -- metrics -----------------------------------------------------------
    @property
    def confusion_matrix(self) -> np.ndarray:
        return self._confusion if self._confusion is not None else np.zeros((0, 0))

    def accuracy(self) -> float:
        c = self.confusion_matrix
        total = c.sum()
        return float(np.trace(c) / total) if total else 0.0

    def top_n_accuracy(self) -> float:
        return self._top_n_correct / self._count if self._count else 0.0

    def _per_class(self):
        c = self.confusion_matrix.astype(np.float64)
        tp = np.diag(c)
        fp = c.sum(axis=0) - tp
        fn = c.sum(axis=1) - tp
        with np.errstate(divide="ignore", invalid="ignore"):
            prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
            rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
            f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
        return prec, rec, f1, c.sum(axis=1)

    def precision(self, cls: int | None = None) -> float:
        prec, _, _, support = self._per_class()
        if cls is not None:
            return float(prec[cls])
        present = support > 0
        return float(prec[present].mean()) if present.any() else 0.0

    def recall(self, cls: int | None = None) -> float:
        _, rec, _, support = self._per_class()
        if cls is not None:
            return float(rec[cls])
        present = support > 0
        return float(rec[present].mean()) if present.any() else 0.0

    def f1(self, cls: int | None = None) -> float:
        _, _, f1, support = self._per_class()
        if cls is not None:
            return float(f1[cls])
        present = support > 0
        return float(f1[present].mean()) if present.any() else 0.0

    def stats(self) -> str:
        prec, rec, f1, support = self._per_class()
        lines = [
            f"# examples: {self._count}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f} (macro)",
            f"Recall:    {self.recall():.4f} (macro)",
            f"F1:        {self.f1():.4f} (macro)",
        ]
        if self.top_n > 1:
            lines.append(f"Top-{self.top_n} accuracy: {self.top_n_accuracy():.4f}")
        lines.append("Per-class (precision / recall / f1 / support):")
        for i in range(self.num_classes or 0):
            lines.append(
                f"  class {i}: {prec[i]:.4f} / {rec[i]:.4f} / {f1[i]:.4f} / {int(support[i])}"
            )
        return "\n".join(lines)
