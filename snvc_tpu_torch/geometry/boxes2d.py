"""2D box utilities on [N, 4] xyxy numpy arrays (port of
snvc_tpu/geometry/boxes2d.py; the reference's BoxList / boxlist_ops,
snvc/utils/bounding_box.py:11-269 and boxlist_ops.py, as pure functions).

Host numpy in float64, as in JAX: no device work, so no ``device``.
"""

from __future__ import annotations

import numpy as np


def xywh_to_xyxy(boxes):
    boxes = np.asarray(boxes, dtype=np.float64)
    out = boxes.copy()
    out[..., 2] = boxes[..., 0] + boxes[..., 2]
    out[..., 3] = boxes[..., 1] + boxes[..., 3]
    return out


def xyxy_to_xywh(boxes):
    boxes = np.asarray(boxes, dtype=np.float64)
    out = boxes.copy()
    out[..., 2] = boxes[..., 2] - boxes[..., 0]
    out[..., 3] = boxes[..., 3] - boxes[..., 1]
    return out


def resize_boxes(boxes, from_size, to_size):
    """Scale boxes between image sizes (BoxList.resize semantics).

    sizes are (width, height)."""
    boxes = np.asarray(boxes, dtype=np.float64)
    sx = to_size[0] / from_size[0]
    sy = to_size[1] / from_size[1]
    return boxes * np.array([sx, sy, sx, sy])


def hflip_boxes(boxes, image_width):
    """Horizontal flip (BoxList.transpose(FLIP_LEFT_RIGHT))."""
    boxes = np.asarray(boxes, dtype=np.float64)
    out = boxes.copy()
    out[..., 0] = image_width - boxes[..., 2] - 1
    out[..., 2] = image_width - boxes[..., 0] - 1
    return out


def clip_boxes(boxes, image_size, remove_empty: bool = False):
    """Clip to the image (reference numpy_utils.clip_boxes:33-40).

    image_size: (width, height)."""
    boxes = np.asarray(boxes, dtype=np.float64).copy()
    w, h = image_size
    boxes[..., 0] = np.clip(boxes[..., 0], 0, w - 1)
    boxes[..., 1] = np.clip(boxes[..., 1], 0, h - 1)
    boxes[..., 2] = np.clip(boxes[..., 2], 0, w - 1)
    boxes[..., 3] = np.clip(boxes[..., 3], 0, h - 1)
    if remove_empty:
        keep = (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])
        return boxes[keep]
    return boxes


def box_area(boxes):
    boxes = np.asarray(boxes, dtype=np.float64)
    return np.clip(boxes[..., 2] - boxes[..., 0], 0, None) * np.clip(
        boxes[..., 3] - boxes[..., 1], 0, None
    )


def iou_matrix(a, b):
    """Pairwise IoU of xyxy boxes [N, 4] x [M, 4]
    (reference boxlist_iou, boxlist_ops.py:51-88)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    union = box_area(a)[:, None] + box_area(b)[None, :] - inter
    return inter / np.clip(union, 1e-9, None)


def nms_2d(boxes, scores, iou_threshold: float = 0.5):
    """Greedy 2D NMS (reference boxlist_nms via the unreleased snvc.layers;
    host-side numpy variant).  Returns kept indices in score order."""
    boxes = np.asarray(boxes, dtype=np.float64)
    order = np.argsort(-np.asarray(scores))
    iou = iou_matrix(boxes, boxes)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed |= iou[i] > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)
