"""Regression evaluation — the port's numpy copy of
`deeplearning4j_tpu/evaluation/regression.py`
(`org.nd4j.evaluation.regression.RegressionEvaluation`): streaming
per-column MSE / MAE / RMSE / RSE / Pearson correlation / R², from
running sums.  Inputs are numpy arrays or tensors.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import as_numpy


class RegressionEvaluation:
    def __init__(self, num_columns: int | None = None, column_names: list[str] | None = None):
        self.column_names = column_names
        self._n_cols = num_columns
        self._count: np.ndarray | None = None

    def _ensure(self, n: int) -> None:
        if self._count is None:
            self._n_cols = self._n_cols or n
            z = lambda: np.zeros(self._n_cols, dtype=np.float64)
            self._count = z()
            self._sum_err_sq = z()
            self._sum_abs_err = z()
            self._sum_label = z()
            self._sum_label_sq = z()
            self._sum_pred = z()
            self._sum_pred_sq = z()
            self._sum_label_pred = z()

    def eval(self, labels: np.ndarray, predictions: np.ndarray, mask=None) -> None:
        labels = as_numpy(labels, np.float64)
        predictions = as_numpy(predictions, np.float64)
        labels = labels.reshape(-1, labels.shape[-1])
        predictions = predictions.reshape(labels.shape)
        self._ensure(labels.shape[1])
        if mask is not None:
            m = as_numpy(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        err = predictions - labels
        self._count += labels.shape[0]
        self._sum_err_sq += (err**2).sum(axis=0)
        self._sum_abs_err += np.abs(err).sum(axis=0)
        self._sum_label += labels.sum(axis=0)
        self._sum_label_sq += (labels**2).sum(axis=0)
        self._sum_pred += predictions.sum(axis=0)
        self._sum_pred_sq += (predictions**2).sum(axis=0)
        self._sum_label_pred += (labels * predictions).sum(axis=0)

    @property
    def num_columns(self) -> int:
        return self._n_cols or 0

    def _col(self, arr: np.ndarray, column: int | None) -> float:
        return float(arr[column]) if column is not None else float(arr.mean())

    def mean_squared_error(self, column: int | None = None) -> float:
        return self._col(self._sum_err_sq / np.maximum(self._count, 1), column)

    def mean_absolute_error(self, column: int | None = None) -> float:
        return self._col(self._sum_abs_err / np.maximum(self._count, 1), column)

    def root_mean_squared_error(self, column: int | None = None) -> float:
        return self._col(np.sqrt(self._sum_err_sq / np.maximum(self._count, 1)), column)

    def _label_var_sum(self) -> np.ndarray:
        n = np.maximum(self._count, 1)
        return self._sum_label_sq - self._sum_label**2 / n

    def relative_squared_error(self, column: int | None = None) -> float:
        denom = self._label_var_sum()
        rse = np.where(denom > 0, self._sum_err_sq / np.maximum(denom, 1e-30), 0.0)
        return self._col(rse, column)

    def r_squared(self, column: int | None = None) -> float:
        denom = self._label_var_sum()
        r2 = np.where(denom > 0, 1.0 - self._sum_err_sq / np.maximum(denom, 1e-30), 0.0)
        return self._col(r2, column)

    def pearson_correlation(self, column: int | None = None) -> float:
        n = np.maximum(self._count, 1)
        cov = self._sum_label_pred - self._sum_label * self._sum_pred / n
        var_l = self._sum_label_sq - self._sum_label**2 / n
        var_p = self._sum_pred_sq - self._sum_pred**2 / n
        denom = np.sqrt(np.maximum(var_l * var_p, 0))
        corr = np.where(denom > 0, cov / np.maximum(denom, 1e-30), 0.0)
        return self._col(corr, column)

    def stats(self) -> str:
        names = self.column_names or [f"col{i}" for i in range(self.num_columns)]
        lines = ["RegressionEvaluation (MSE / MAE / RMSE / R^2 / corr):"]
        for i, name in enumerate(names):
            lines.append(
                f"  {name}: {self.mean_squared_error(i):.6f} / "
                f"{self.mean_absolute_error(i):.6f} / "
                f"{self.root_mean_squared_error(i):.6f} / "
                f"{self.r_squared(i):.4f} / {self.pearson_correlation(i):.4f}"
            )
        return "\n".join(lines)
