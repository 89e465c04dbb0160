"""Multi-label binary evaluation and calibration — the port's numpy copy
of `deeplearning4j_tpu/evaluation/binary.py`
(`org.nd4j.evaluation.classification.EvaluationBinary`: per-output
binary confusion counts at a settable decision threshold;
`EvaluationCalibration`: reliability diagram, probability histograms,
expected calibration error).  Inputs are numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import as_numpy


class EvaluationBinary:
    """Independent binary classification stats per output column."""

    def __init__(self, num_outputs: int | None = None, decision_threshold: float = 0.5):
        self.decision_threshold = decision_threshold
        self._n = num_outputs
        self._tp: np.ndarray | None = None

    def _ensure(self, n: int) -> None:
        if self._tp is None:
            self._n = self._n or n
            self._tp = np.zeros(self._n, dtype=np.int64)
            self._fp = np.zeros(self._n, dtype=np.int64)
            self._tn = np.zeros(self._n, dtype=np.int64)
            self._fn = np.zeros(self._n, dtype=np.int64)

    def eval(self, labels: np.ndarray, predictions: np.ndarray, mask=None) -> None:
        labels = as_numpy(labels)
        labels = labels.reshape(-1, labels.shape[-1]).astype(bool)
        predictions = as_numpy(predictions).reshape(labels.shape)
        pred = predictions >= self.decision_threshold
        self._ensure(labels.shape[1])
        if mask is not None:
            m = as_numpy(mask)
            m = m.reshape(-1, 1).astype(bool) if m.ndim == 1 else m.astype(bool)
            valid = np.broadcast_to(m, labels.shape)
        else:
            valid = np.ones_like(labels, dtype=bool)
        self._tp += (labels & pred & valid).sum(axis=0)
        self._fp += (~labels & pred & valid).sum(axis=0)
        self._tn += (~labels & ~pred & valid).sum(axis=0)
        self._fn += (labels & ~pred & valid).sum(axis=0)

    @property
    def num_outputs(self) -> int:
        return self._n or 0

    def true_positives(self, i: int) -> int:
        return int(self._tp[i])

    def false_positives(self, i: int) -> int:
        return int(self._fp[i])

    def true_negatives(self, i: int) -> int:
        return int(self._tn[i])

    def false_negatives(self, i: int) -> int:
        return int(self._fn[i])

    def _rates(self):
        tp, fp, tn, fn = (a.astype(np.float64) for a in (self._tp, self._fp, self._tn, self._fn))
        total = tp + fp + tn + fn
        acc = np.where(total > 0, (tp + tn) / np.maximum(total, 1), 0.0)
        prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-30), 0.0)
        return acc, prec, rec, f1

    def accuracy(self, i: int | None = None) -> float:
        acc, _, _, _ = self._rates()
        return float(acc[i]) if i is not None else float(acc.mean())

    def precision(self, i: int | None = None) -> float:
        _, p, _, _ = self._rates()
        return float(p[i]) if i is not None else float(p.mean())

    def recall(self, i: int | None = None) -> float:
        _, _, r, _ = self._rates()
        return float(r[i]) if i is not None else float(r.mean())

    def f1(self, i: int | None = None) -> float:
        _, _, _, f = self._rates()
        return float(f[i]) if i is not None else float(f.mean())

    def stats(self) -> str:
        acc, prec, rec, f1 = self._rates()
        lines = [f"EvaluationBinary ({self.num_outputs} outputs, threshold {self.decision_threshold}):"]
        for i in range(self.num_outputs):
            lines.append(
                f"  output {i}: acc {acc[i]:.4f}  prec {prec[i]:.4f}  "
                f"rec {rec[i]:.4f}  f1 {f1[i]:.4f}"
            )
        return "\n".join(lines)


class EvaluationCalibration:
    """Reliability diagram + ECE over predicted class probabilities."""

    def __init__(self, reliability_bins: int = 10, histogram_bins: int = 50):
        self.reliability_bins = reliability_bins
        self.histogram_bins = histogram_bins
        self._bin_conf = np.zeros(reliability_bins, dtype=np.float64)
        self._bin_correct = np.zeros(reliability_bins, dtype=np.int64)
        self._bin_count = np.zeros(reliability_bins, dtype=np.int64)
        self._prob_hist_all = np.zeros(histogram_bins, dtype=np.int64)
        self._prob_hist_label = np.zeros(histogram_bins, dtype=np.int64)

    def eval(self, labels: np.ndarray, predictions: np.ndarray, mask=None) -> None:
        predictions = as_numpy(predictions, np.float64)
        k = predictions.shape[-1]
        probs = predictions.reshape(-1, k)
        labels = as_numpy(labels)
        if labels.ndim == predictions.ndim and labels.shape[-1] == k:
            true = np.argmax(labels.reshape(-1, k), axis=-1)
        else:
            true = labels.reshape(-1).astype(np.int64)
        if mask is not None:
            m = as_numpy(mask).reshape(-1).astype(bool)
            probs, true = probs[m], true[m]
        conf = probs.max(axis=-1)
        pred = probs.argmax(axis=-1)
        bins = np.clip((conf * self.reliability_bins).astype(np.int64), 0, self.reliability_bins - 1)
        np.add.at(self._bin_conf, bins, conf)
        np.add.at(self._bin_correct, bins, (pred == true).astype(np.int64))
        np.add.at(self._bin_count, bins, 1)
        hb = np.clip((probs * self.histogram_bins).astype(np.int64), 0, self.histogram_bins - 1)
        np.add.at(self._prob_hist_all, hb.reshape(-1), 1)
        np.add.at(self._prob_hist_label, hb[np.arange(true.shape[0]), true], 1)

    def reliability_diagram(self):
        """(mean confidence per bin, empirical accuracy per bin, counts)."""
        count = np.maximum(self._bin_count, 1)
        return self._bin_conf / count, self._bin_correct / count, self._bin_count.copy()

    def expected_calibration_error(self) -> float:
        conf, acc, counts = self.reliability_diagram()
        total = counts.sum()
        if total == 0:
            return 0.0
        return float(np.sum(counts / total * np.abs(conf - acc)))

    def probability_histogram(self, label_class_only: bool = False) -> np.ndarray:
        return (self._prob_hist_label if label_class_only else self._prob_hist_all).copy()

    def stats(self) -> str:
        conf, acc, counts = self.reliability_diagram()
        lines = [f"EvaluationCalibration (ECE {self.expected_calibration_error():.4f}):"]
        for i in range(self.reliability_bins):
            lines.append(f"  bin {i}: conf {conf[i]:.3f}  acc {acc[i]:.3f}  n {int(counts[i])}")
        return "\n".join(lines)
