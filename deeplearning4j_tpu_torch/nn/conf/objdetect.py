"""Object-detection output layer — `deeplearning4j_tpu/nn/conf/objdetect.py`,
the `Yolo2OutputLayer` role (the zoo's TinyYOLO and YOLO2 heads).

The YOLOv2 loss over an anchor-box grid: the responsible anchor's
coordinate regression, objectness with a no-object down-weight, and the
cell's class cross-entropy.  Maps stay NHWC: the raw grid reshapes to
(B, H, W, A, 5 + C) in place.  Ground truth is assigned on the host
(`build_targets`, numpy, as in the JAX package), so the loss on the
device is dense arithmetic under masks, with no data-dependent control
flow: it captures into the training step's CUDA graph.  `decode` runs
on the device; thresholds and non-maximum suppression
(`non_max_suppression`, `get_predicted_objects`) run on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig
from deeplearning4j_tpu_torch.utils import serde


@serde.register
@dataclasses.dataclass(frozen=True)
class Yolo2OutputLayer(LayerConfig):
    """YOLOv2 detection head over a conv feature map.

    Input: (B, H, W, A (5 + C)) activations, each anchor's raw layout
    [tx, ty, tw, th, conf, class logits...].  Labels: `build_targets`'s
    dense grid (B, H, W, A, 5 + C), [obj, x, y, log w, log h, class
    one-hot...] (x and y offsets within the cell, w and h as log ratios
    to the anchor).  The layer owns its loss (`compute_loss`): it has no
    ``loss`` attribute, and ``output()`` returns the raw grid.
    """

    anchors: Tuple[Tuple[float, float], ...] = ()   # (w, h) in grid units
    num_classes: int = 0
    lambda_coord: float = 5.0
    lambda_noobj: float = 0.5

    EXPECTS = "cnn"
    HAS_PARAMS = False
    REGULARIZED = ()

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)

    def _split(self, raw):
        b, h, w, _ = raw.shape
        g = raw.reshape(b, h, w, self.num_anchors, 5 + self.num_classes)
        return g[..., 0], g[..., 1], g[..., 2], g[..., 3], g[..., 4], g[..., 5:]

    def output_type(self, itype):
        h, w, c = itype.shape
        need = self.num_anchors * (5 + self.num_classes)
        if c != need:
            raise ValueError(
                f"Yolo2OutputLayer needs {need} input channels "
                f"({self.num_anchors} anchors x (5+{self.num_classes})), got {c}")
        return itype

    def apply(self, params, state, x, *, training=False, rng=None):
        return x, state

    def compute_loss(self, preds, labels, mask=None):
        """The batch's mean (or masked mean) of each image's summed loss,
        f32."""
        preds = preds.float()
        labels = labels.float()
        tx, ty, tw, th, tconf, tcls = self._split(
            preds.reshape(preds.shape[0], preds.shape[1], preds.shape[2], -1))
        obj = labels[..., 0]
        gx, gy, gw, gh = labels[..., 1], labels[..., 2], labels[..., 3], labels[..., 4]
        gcls = labels[..., 5:]
        px, py, pconf = torch.sigmoid(tx), torch.sigmoid(ty), torch.sigmoid(tconf)
        coord = obj * ((px - gx).square() + (py - gy).square()
                       + (tw - gw).square() + (th - gh).square())
        conf = (obj * (pconf - 1.0).square()
                + self.lambda_noobj * (1.0 - obj) * pconf.square())
        cls = obj * -(gcls * torch.log_softmax(tcls, dim=-1)).sum(dim=-1)
        per_image = (self.lambda_coord * coord + conf + cls).sum(dim=(1, 2, 3))
        if mask is not None:
            m = mask.reshape(-1).float()
            return (per_image * m).sum() / torch.clamp(m.sum(), min=1.0)
        return per_image.mean()

    def decode(self, preds) -> dict:
        """Raw grid -> boxes in grid units, on ``preds``' device: ``xy``
        (B, H, W, A, 2) centers, ``wh`` sizes, ``conf`` (B, H, W, A)
        objectness, ``class_probs`` (B, H, W, A, C)."""
        if not isinstance(preds, torch.Tensor):
            preds = torch.from_numpy(np.array(preds, dtype=np.float32))
        preds = preds.float()
        tx, ty, tw, th, tconf, tcls = self._split(preds)
        h, w = preds.shape[1], preds.shape[2]
        cx = torch.arange(w, dtype=torch.float32, device=preds.device).reshape(1, 1, w, 1)
        cy = torch.arange(h, dtype=torch.float32, device=preds.device).reshape(1, h, 1, 1)
        anchors = torch.tensor(self.anchors, dtype=torch.float32, device=preds.device)
        x = torch.sigmoid(tx) + cx
        y = torch.sigmoid(ty) + cy
        bw = torch.exp(tw) * anchors[:, 0]
        bh = torch.exp(th) * anchors[:, 1]
        return {"xy": torch.stack([x, y], dim=-1), "wh": torch.stack([bw, bh], dim=-1),
                "conf": torch.sigmoid(tconf), "class_probs": torch.softmax(tcls, dim=-1)}


def _iou_wh(wh1, wh2) -> float:
    """IoU of two boxes sharing a center (anchor matching reads w and h
    alone)."""
    inter = min(wh1[0], wh2[0]) * min(wh1[1], wh2[1])
    union = wh1[0] * wh1[1] + wh2[0] * wh2[1] - inter
    return inter / union if union > 0 else 0.0


def build_targets(boxes_per_image: Sequence[Sequence], grid_h: int, grid_w: int,
                  anchors: Sequence[Tuple[float, float]],
                  num_classes: int) -> np.ndarray:
    """The dense target grid, on the host.  ``boxes_per_image``: for each
    image a list of (class, cx, cy, w, h) in grid units; each box goes to
    its cell and its best-IoU anchor."""
    a, c = len(anchors), num_classes
    out = np.zeros((len(boxes_per_image), grid_h, grid_w, a, 5 + c), np.float32)
    for i, boxes in enumerate(boxes_per_image):
        for cls_idx, cx, cy, w, h in boxes:
            col = min(int(cx), grid_w - 1)
            row = min(int(cy), grid_h - 1)
            best = max(range(a), key=lambda k: _iou_wh((w, h), anchors[k]))
            out[i, row, col, best, 0] = 1.0
            out[i, row, col, best, 1] = cx - col
            out[i, row, col, best, 2] = cy - row
            out[i, row, col, best, 3] = np.log(max(w, 1e-6) / anchors[best][0])
            out[i, row, col, best, 4] = np.log(max(h, 1e-6) / anchors[best][1])
            out[i, row, col, best, 5 + int(cls_idx)] = 1.0
    return out


def non_max_suppression(boxes: np.ndarray, scores: np.ndarray,
                        iou_threshold: float = 0.45, score_threshold: float = 0.3,
                        max_out: int = 50):
    """Greedy NMS over (N, 4) (cx, cy, w, h) boxes and (N,) scores, on the
    host; the kept indices, best first."""
    keep = []
    order = np.argsort(-scores)
    order = order[scores[order] >= score_threshold]
    x1 = boxes[:, 0] - boxes[:, 2] / 2
    y1 = boxes[:, 1] - boxes[:, 3] / 2
    x2 = boxes[:, 0] + boxes[:, 2] / 2
    y2 = boxes[:, 1] + boxes[:, 3] / 2
    areas = (x2 - x1) * (y2 - y1)
    while order.size and len(keep) < max_out:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-9)
        order = order[1:][iou <= iou_threshold]
    return keep


@dataclasses.dataclass(frozen=True)
class DetectedObject:
    """One detection in grid units (the reference's DetectedObject)."""

    class_index: int
    confidence: float
    center_x: float
    center_y: float
    width: float
    height: float

    def top_left(self) -> tuple[float, float]:
        return (self.center_x - self.width / 2, self.center_y - self.height / 2)

    def bottom_right(self) -> tuple[float, float]:
        return (self.center_x + self.width / 2, self.center_y + self.height / 2)


def get_predicted_objects(layer: Yolo2OutputLayer, preds, *,
                          score_threshold: float = 0.3, iou_threshold: float = 0.45,
                          max_out: int = 50) -> list[list[DetectedObject]]:
    """`decode`, threshold and NMS within each class into `DetectedObject`
    lists, one an image, best first (YoloUtils.getPredictedObjects role).
    Score = objectness x best class probability."""
    d = {k: v.detach().cpu().numpy() for k, v in layer.decode(preds).items()}
    xy, wh, conf, cls_p = d["xy"], d["wh"], d["conf"], d["class_probs"]
    out = []
    for b in range(xy.shape[0]):
        boxes = np.concatenate([xy[b].reshape(-1, 2), wh[b].reshape(-1, 2)], axis=1)
        c = conf[b].reshape(-1)
        p = cls_p[b].reshape(-1, cls_p.shape[-1])
        best = p.argmax(axis=1)
        scores = c * p.max(axis=1)
        # within one class only: overlapping objects of different classes
        # do not suppress each other
        dets = []
        for cls_idx in np.unique(best[scores >= score_threshold]):
            sel = np.flatnonzero(best == cls_idx)
            keep = non_max_suppression(boxes[sel], scores[sel], iou_threshold=iou_threshold,
                                       score_threshold=score_threshold, max_out=max_out)
            dets.extend(DetectedObject(class_index=int(cls_idx), confidence=float(scores[i]),
                                       center_x=float(boxes[i, 0]), center_y=float(boxes[i, 1]),
                                       width=float(boxes[i, 2]), height=float(boxes[i, 3]))
                        for i in sel[keep])
        dets.sort(key=lambda d: -d.confidence)
        out.append(dets[:max_out])
    return out
