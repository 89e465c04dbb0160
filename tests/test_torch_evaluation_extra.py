"""The port's evaluation classes (`deeplearning4j_tpu_torch/evaluation/`:
`ROC`, `ROCBinary`, `ROCMultiClass`, `RegressionEvaluation`,
`EvaluationBinary`, `EvaluationCalibration`) on the JAX package's own
evaluation cases (`tests/test_evaluation.py`, every case with the port's
classes), then against the JAX package's classes on the same seeded
arrays: every metric within 1e-12, masks included, and the same results
from tensors as from numpy arrays.  Numpy only: no card is involved.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import evaluation as jev
from deeplearning4j_tpu_torch.evaluation import (
    ROC,
    Evaluation,
    EvaluationBinary,
    EvaluationCalibration,
    ROCBinary,
    ROCMultiClass,
    RegressionEvaluation,
)


class TestROC:
    def test_perfect_separation_auc_1(self):
        roc = ROC()
        roc.eval(np.array([0, 0, 1, 1]), np.array([0.1, 0.2, 0.8, 0.9]))
        assert roc.calculate_auc() == pytest.approx(1.0)
        assert roc.calculate_auprc() == pytest.approx(1.0)

    def test_random_scores_auc_half(self):
        rng = np.random.default_rng(0)
        labels = rng.integers(0, 2, 20000)
        scores = rng.random(20000)
        roc = ROC()
        roc.eval(labels, scores)
        assert roc.calculate_auc() == pytest.approx(0.5, abs=0.02)

    def test_known_auc(self):
        # scores: 0.9(1) 0.8(0) 0.7(1) 0.6(0) -> pairs: (1>0): of 4 pairs
        # concordant: (0.9,0.8),(0.9,0.6),(0.7,0.6) = 3; discordant (0.7,0.8)=1
        # AUC = 3/4
        roc = ROC()
        roc.eval(np.array([1, 0, 1, 0]), np.array([0.9, 0.8, 0.7, 0.6]))
        assert roc.calculate_auc() == pytest.approx(0.75)

    def test_streaming_equals_batch(self):
        rng = np.random.default_rng(1)
        labels = rng.integers(0, 2, 1000)
        scores = rng.random(1000)
        batch = ROC()
        batch.eval(labels, scores)
        stream = ROC()
        for i in range(0, 1000, 64):
            stream.eval(labels[i : i + 64], scores[i : i + 64])
        assert stream.calculate_auc() == pytest.approx(batch.calculate_auc())

    def test_thresholded_mode_approximates_exact(self):
        rng = np.random.default_rng(2)
        labels = rng.integers(0, 2, 5000)
        scores = np.clip(rng.normal(0.3 + 0.4 * labels, 0.2), 0, 1)
        exact, stepped = ROC(0), ROC(200)
        exact.eval(labels, scores)
        stepped.eval(labels, scores)
        assert stepped.calculate_auc() == pytest.approx(exact.calculate_auc(), abs=0.01)

    def test_two_column_probability_input(self):
        roc = ROC()
        probs = np.array([[0.9, 0.1], [0.2, 0.8]])
        roc.eval(np.array([[1, 0], [0, 1]]), probs)
        assert roc.calculate_auc() == pytest.approx(1.0)


class TestROCBinaryMulti:
    def test_roc_binary_per_output(self):
        rb = ROCBinary()
        labels = np.array([[1, 0], [0, 1], [1, 1], [0, 0]])
        # output 0 perfectly ranked, output 1 anti-ranked
        # (col-1 positives score 0.1/0.2, below every negative's 0.8/0.9)
        preds = np.array([[0.9, 0.9], [0.1, 0.2], [0.8, 0.1], [0.2, 0.8]])
        rb.eval(labels, preds)
        assert rb.num_outputs == 2
        assert rb.calculate_auc(0) == pytest.approx(1.0)
        assert rb.calculate_auc(1) == pytest.approx(0.0)
        assert rb.calculate_average_auc() == pytest.approx(0.5)

    def test_roc_multiclass_one_vs_all(self):
        rm = ROCMultiClass()
        labels = np.array([0, 1, 2, 0, 1, 2])
        preds = np.eye(3)[labels] * 0.8 + 0.1  # peaked on true class
        rm.eval(labels, preds)
        assert rm.num_classes == 3
        for c in range(3):
            assert rm.calculate_auc(c) == pytest.approx(1.0)


class TestRegressionEvaluation:
    def test_known_values(self):
        ev = RegressionEvaluation()
        labels = np.array([[1.0], [2.0], [3.0]])
        preds = np.array([[1.5], [2.0], [2.5]])
        ev.eval(labels, preds)
        assert ev.mean_squared_error(0) == pytest.approx((0.25 + 0 + 0.25) / 3)
        assert ev.mean_absolute_error(0) == pytest.approx(1.0 / 3)
        assert ev.root_mean_squared_error(0) == pytest.approx(np.sqrt(0.5 / 3))
        # R^2 = 1 - SSE/SST; SST = 2, SSE = 0.5
        assert ev.r_squared(0) == pytest.approx(1 - 0.5 / 2.0)
        assert ev.pearson_correlation(0) == pytest.approx(1.0)

    def test_streaming_equals_batch(self):
        rng = np.random.default_rng(3)
        labels = rng.normal(size=(500, 3))
        preds = labels + 0.1 * rng.normal(size=(500, 3))
        batch = RegressionEvaluation()
        batch.eval(labels, preds)
        stream = RegressionEvaluation()
        for i in range(0, 500, 37):
            stream.eval(labels[i : i + 37], preds[i : i + 37])
        for col in range(3):
            assert stream.mean_squared_error(col) == pytest.approx(batch.mean_squared_error(col))
            assert stream.r_squared(col) == pytest.approx(batch.r_squared(col))
        assert "RMSE" in batch.stats() or "RegressionEvaluation" in batch.stats()


class TestEvaluationBinary:
    def test_confusion_counts(self):
        eb = EvaluationBinary()
        labels = np.array([[1, 0], [1, 1], [0, 0], [0, 1]])
        preds = np.array([[0.9, 0.8], [0.2, 0.7], [0.3, 0.1], [0.6, 0.4]])
        eb.eval(labels, preds)
        # output 0: tp=1 (row0), fn=1 (row1), tn=1 (row2), fp=1 (row3)
        assert eb.true_positives(0) == 1
        assert eb.false_negatives(0) == 1
        assert eb.true_negatives(0) == 1
        assert eb.false_positives(0) == 1
        assert eb.accuracy(0) == pytest.approx(0.5)
        # output 1: tp=2 (rows 0,1... row0 label 0 -> no). labels col1: 0,1,0,1
        # preds col1>=0.5: 1,1,0,0 -> tp=1(row1), fp=1(row0), tn=1(row2), fn=1(row3)
        assert eb.true_positives(1) == 1
        assert eb.f1(1) == pytest.approx(0.5)

    def test_custom_threshold(self):
        eb = EvaluationBinary(decision_threshold=0.9)
        eb.eval(np.array([[1], [1]]), np.array([[0.95], [0.8]]))
        assert eb.true_positives(0) == 1
        assert eb.false_negatives(0) == 1


class TestEvaluationCalibration:
    def test_perfectly_calibrated_low_ece(self):
        rng = np.random.default_rng(4)
        n = 50000
        p = rng.uniform(0.5, 1.0, n)
        correct = rng.random(n) < p
        probs = np.stack([np.where(correct, p, 1 - p), np.where(correct, 1 - p, p)], axis=1)
        labels = np.zeros(n, dtype=np.int64)  # true class always 0
        ec = EvaluationCalibration()
        ec.eval(labels, probs)
        assert ec.expected_calibration_error() < 0.02

    def test_overconfident_high_ece(self):
        n = 1000
        probs = np.tile(np.array([[0.99, 0.01]]), (n, 1))
        labels = (np.arange(n) % 2).astype(np.int64)  # 50% accuracy
        ec = EvaluationCalibration()
        ec.eval(labels, probs)
        assert ec.expected_calibration_error() > 0.4
        assert ec.probability_histogram().sum() == 2 * n

    def test_stats_strings(self):
        for ev in (ROC(), ROCBinary(), ROCMultiClass(), EvaluationBinary(), EvaluationCalibration()):
            labels = np.array([[1, 0], [0, 1]])
            preds = np.array([[0.8, 0.2], [0.3, 0.7]])
            ev.eval(labels, preds)
            assert isinstance(ev.stats(), str)


class TestEmptyROC:
    def test_empty_roc_does_not_crash(self):
        roc = ROC()
        assert roc.calculate_auc() == pytest.approx(0.5)
        assert isinstance(roc.stats(), str)

    def test_fully_masked_eval(self):
        roc = ROC()
        roc.eval(np.array([0, 1]), np.array([0.2, 0.8]), mask=np.array([0, 0]))
        roc.calculate_auc()  # must not raise


class TestEvaluationMask:
    def test_mask_excludes_rows(self):
        ev = Evaluation()
        labels = np.array([0, 1, 1])
        preds = np.array([[0.9, 0.1], [0.2, 0.8], [0.9, 0.1]])
        ev.eval(labels, preds, mask=np.array([1, 1, 0]))
        assert ev.accuracy() == pytest.approx(1.0)


# -- against the JAX package's classes ---------------------------------------

def _arrays(seed, n=300, k=4):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, k))
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ids = rng.integers(0, k, n)
    onehot = np.eye(k)[ids]
    multi = (rng.random((n, k)) < 0.4).astype(np.float64)
    sig = 1 / (1 + np.exp(-logits))
    reg_labels = rng.normal(size=(n, k))
    reg_preds = reg_labels + 0.3 * rng.normal(size=(n, k))
    row_mask = (rng.random(n) < 0.8).astype(np.float64)
    col_mask = (rng.random((n, k)) < 0.8).astype(np.float64)
    return dict(probs=probs, ids=ids, onehot=onehot, multi=multi, sig=sig,
                reg_labels=reg_labels, reg_preds=reg_preds, row_mask=row_mask,
                col_mask=col_mask)


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def _feed(port, jax_ev, labels, preds, mask, batches, tensors):
    n = len(labels)
    step = -(-n // batches)
    for i in range(0, n, step):
        sl = slice(i, i + step)
        m = None if mask is None else mask[sl]
        jax_ev.eval(labels[sl], preds[sl], mask=m)
        if tensors:
            port.eval(torch.from_numpy(np.ascontiguousarray(labels[sl])),
                      torch.from_numpy(np.ascontiguousarray(preds[sl])),
                      mask=None if m is None else torch.from_numpy(m))
        else:
            port.eval(labels[sl], preds[sl], mask=m)


CASES = [(seed, masked, tensors) for seed in (0, 1) for masked in (False, True)
         for tensors in (False, True)]


@pytest.mark.parametrize("seed,masked,tensors", CASES)
def test_roc_curves_and_areas_match_jax(seed, masked, tensors):
    a = _arrays(seed)
    for steps in (0, 50):
        p, j = ROC(steps), jev.ROC(steps)
        labels = a["multi"][:, 0].astype(np.int64)
        _feed(p, j, labels, a["sig"][:, 0], a["row_mask"] if masked else None,
              3, tensors)
        _close(p.calculate_auc(), j.calculate_auc())
        _close(p.calculate_auprc(), j.calculate_auprc())
        for x, y in zip(p.roc_curve() + p.precision_recall_curve(),
                        j.roc_curve() + j.precision_recall_curve()):
            _close(x, y)
        assert p.stats() == j.stats()


@pytest.mark.parametrize("seed,masked,tensors", CASES)
def test_roc_binary_and_multiclass_match_jax(seed, masked, tensors):
    a = _arrays(seed)
    pb, jb = ROCBinary(), jev.ROCBinary()
    _feed(pb, jb, a["multi"], a["sig"], a["col_mask"] if masked else None, 2,
          tensors)
    for i in range(4):
        _close(pb.calculate_auc(i), jb.calculate_auc(i))
        _close(pb.calculate_auprc(i), jb.calculate_auprc(i))
    _close(pb.calculate_average_auc(), jb.calculate_average_auc())
    pm, jm = ROCMultiClass(20), jev.ROCMultiClass(20)
    _feed(pm, jm, a["onehot"], a["probs"], a["row_mask"] if masked else None, 2,
          tensors)
    for c in range(4):
        _close(pm.calculate_auc(c), jm.calculate_auc(c))
    _close(pm.calculate_average_auc(), jm.calculate_average_auc())
    assert pb.stats() == jb.stats() and pm.stats() == jm.stats()


@pytest.mark.parametrize("seed,masked,tensors", CASES)
def test_regression_evaluation_matches_jax(seed, masked, tensors):
    a = _arrays(seed)
    p, j = RegressionEvaluation(), jev.RegressionEvaluation()
    _feed(p, j, a["reg_labels"], a["reg_preds"], a["row_mask"] if masked else None,
          4, tensors)
    for col in (None, 0, 1, 2, 3):
        for name in ("mean_squared_error", "mean_absolute_error",
                     "root_mean_squared_error", "relative_squared_error",
                     "r_squared", "pearson_correlation"):
            _close(getattr(p, name)(col), getattr(j, name)(col))
    assert p.stats() == j.stats()


@pytest.mark.parametrize("seed,masked,tensors", CASES)
def test_evaluation_binary_and_calibration_match_jax(seed, masked, tensors):
    a = _arrays(seed)
    p, j = EvaluationBinary(decision_threshold=0.4), jev.EvaluationBinary(
        decision_threshold=0.4)
    _feed(p, j, a["multi"], a["sig"], a["col_mask"] if masked else None, 3,
          tensors)
    for i in (None, 0, 1, 2, 3):
        for name in ("accuracy", "precision", "recall", "f1"):
            _close(getattr(p, name)(i), getattr(j, name)(i))
    for i in range(4):
        for name in ("true_positives", "false_positives", "true_negatives",
                     "false_negatives"):
            assert getattr(p, name)(i) == getattr(j, name)(i)
    pc, jc = EvaluationCalibration(7, 13), jev.EvaluationCalibration(7, 13)
    _feed(pc, jc, a["ids"], a["probs"], a["row_mask"] if masked else None, 3,
          tensors)
    _close(pc.expected_calibration_error(), jc.expected_calibration_error())
    for x, y in zip(pc.reliability_diagram(), jc.reliability_diagram()):
        _close(x, y)
    for label_only in (False, True):
        _close(pc.probability_histogram(label_only),
               jc.probability_histogram(label_only))
    assert p.stats() == j.stats() and pc.stats() == jc.stats()
