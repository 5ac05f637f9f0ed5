"""Figures of training and validation (port of `sar_yolo_tpu/utils/plotting.py`): the
training curves, the PR curve, the detection confusion matrix, the dataset's label
statistics and the labelled batch mosaics.

The charts are drawn by `utils/chart.py` (the training machine has no matplotlib): the
same figure sizes, limits, ticks, labels and data as the JAX package's matplotlib
figures, with the port's own strokes and Hershey text. The mosaics are drawn by
`data/cv.py` as the JAX package draws them with OpenCV, pixel for pixel, and written through
`data/imageio.py::imwrite` (.jpg at quality 95, .png otherwise). One difference: a
rectangular batch (h != w) tiles in h x w cells, where the JAX package's square cells
raise and it writes no mosaic.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.data import cv
from sar_yolo_tpu_torch.data.imageio import imwrite
from sar_yolo_tpu_torch.utils import chart
from sar_yolo_tpu_torch.utils.metrics import box_iou_np

PALETTE = np.array([
    [56, 56, 255], [31, 112, 255], [29, 178, 255], [49, 210, 207], [10, 249, 72],
    [23, 204, 146], [134, 219, 61], [52, 147, 26], [187, 212, 0], [168, 153, 44],
], dtype=np.uint8)

# the figures the validators and the trainer write
FIGURES = ("confusion_matrix.png", "val_batch0_labels.jpg", "val_batch0_pred.jpg",
           "train_batch0.png", "labels.jpg", "labels_correlogram.jpg", "results.png")

# COCO's 17-keypoint skeleton
COCO_SKELETON = [(15, 13), (13, 11), (16, 14), (14, 12), (11, 12), (5, 11),
                 (6, 12), (5, 6), (5, 7), (6, 8), (7, 9), (8, 10), (1, 2),
                 (0, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 6)]


def plot_results(csv_path, save_path=None):
    """Training curves from results.csv: one panel a column but `epoch`, four a row;
    results.png beside the csv. Returns the path, or None without rows."""
    csv_path = Path(csv_path)
    if not csv_path.exists():
        return None
    with csv_path.open() as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    keys = [k for k in rows[0] if k not in ("epoch",)]
    epochs = [int(r["epoch"]) for r in rows]
    n = len(keys)
    cols = min(4, n)
    rows_n = (n + cols - 1) // cols
    fig, axes = chart.subplots(rows_n, cols, figsize=(4 * cols, 3 * rows_n), squeeze=False)
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        vals = [float(r[k]) if r[k] not in ("", "None") else np.nan for r in rows]
        ax.plot(epochs, vals, marker=".")
        ax.set_title(k, fontsize=9)
        ax.grid(alpha=0.3)
    for j in range(n, rows_n * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    out = Path(save_path or csv_path.with_name("results.png"))
    fig.savefig(out, dpi=120)
    return out


def plot_pr_curve(recall_grid, precisions, names=None, save_path="pr_curve.png"):
    """PR curves a class and their mean."""
    fig, ax = chart.subplots(figsize=(6, 5))
    precisions = np.atleast_2d(precisions)
    for i, p in enumerate(precisions):
        ax.plot(recall_grid, p, alpha=0.6, label=(names or {}).get(i, str(i)))
    ax.plot(recall_grid, precisions.mean(0), "b-", lw=2, label="mean")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    if len(precisions) <= 12:
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(save_path, dpi=120)
    return save_path


class ConfusionMatrix:
    """Detection confusion matrix, (nc + 1) x (nc + 1) [predicted, true] with the
    background row and column: detections at or over `conf` matched one to one to the
    ground truth at IoU >= `iou_thres`, best IoU first."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)

    def process_batch(self, dets, gt_boxes, gt_cls):
        """dets (n, >= 6) [x1 y1 x2 y2 conf cls]; gt xyxy boxes and classes."""
        if dets is not None and len(dets):
            dets = dets[dets[:, 4] >= self.conf]
        if len(gt_cls) == 0:
            for d in (dets if dets is not None else []):
                self.matrix[int(d[5]), self.nc] += 1  # false positive
            return
        if dets is None or len(dets) == 0:
            for c in gt_cls:
                self.matrix[self.nc, int(c)] += 1  # missed
            return
        iou = box_iou_np(gt_boxes, dets[:, :4])
        matched_g, matched_p = set(), set()
        gi, pi = np.nonzero(iou >= self.iou_thres)
        order = iou[gi, pi].argsort()[::-1]
        for g, p in zip(gi[order], pi[order]):
            if g in matched_g or p in matched_p:
                continue
            matched_g.add(g)
            matched_p.add(p)
            self.matrix[int(dets[p, 5]), int(gt_cls[g])] += 1
        for g in range(len(gt_cls)):
            if g not in matched_g:
                self.matrix[self.nc, int(gt_cls[g])] += 1
        for p in range(len(dets)):
            if p not in matched_p:
                self.matrix[int(dets[p, 5]), self.nc] += 1

    def plot(self, save_path="confusion_matrix.png", names=None):
        """The matrix normalized by column (true class), Blues, with a colorbar."""
        fig, ax = chart.subplots(figsize=(6, 5))
        m = self.matrix / np.maximum(self.matrix.sum(0, keepdims=True), 1)
        im = ax.imshow(m, cmap="Blues", vmin=0, vmax=1)
        labels = [(names or {}).get(i, str(i)) for i in range(self.nc)] + ["background"]
        ax.set_xticks(range(self.nc + 1))
        ax.set_yticks(range(self.nc + 1))
        ax.set_xticklabels(labels, rotation=90, fontsize=7)
        ax.set_yticklabels(labels, fontsize=7)
        ax.set_xlabel("True")
        ax.set_ylabel("Predicted")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(save_path, dpi=120)
        return save_path


def plot_labels(boxes, cls, names=None, save_dir="."):
    """Dataset label statistics, labels.jpg: the class histogram, the box centres' 2-D
    histogram, widths against heights, and up to 500 box outlines about (0.5, 0.5); then
    labels_correlogram.jpg, the pairwise histograms of x, y, width and height.
    boxes: (N, 4) normalized cxcywh; cls: (N,) ids."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    cls = np.asarray(cls).reshape(-1).astype(int)
    fig, axes = chart.subplots(2, 2, figsize=(10, 8))
    nc = int(cls.max()) + 1 if len(cls) else 1
    counts = np.bincount(cls, minlength=nc)
    axes[0][0].bar(range(nc), counts,
                   color=[PALETTE[i % len(PALETTE)] / 255.0 for i in range(nc)])
    axes[0][0].set_ylabel("instances")
    if names and nc <= 30:
        axes[0][0].set_xticks(range(nc))
        axes[0][0].set_xticklabels([str((names or {}).get(i, i)) for i in range(nc)],
                                   rotation=90, fontsize=7)
    if len(boxes):
        axes[0][1].hist2d(boxes[:, 0], boxes[:, 1], bins=50, cmap="Blues")
        axes[0][1].set_xlabel("x")
        axes[0][1].set_ylabel("y")
        axes[1][0].scatter(boxes[:, 2], boxes[:, 3], s=2, alpha=0.3)
        axes[1][0].set_xlabel("width")
        axes[1][0].set_ylabel("height")
        ax = axes[1][1]
        for b, c in list(zip(boxes, cls))[:500]:
            w2, h2 = b[2] / 2, b[3] / 2
            col = PALETTE[int(c) % len(PALETTE)] / 255.0
            ax.add_patch(chart.Rectangle((0.5 - w2, 0.5 - h2), b[2], b[3],
                                         fill=False, edgecolor=col, lw=0.5, alpha=0.5))
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1)
        ax.set_title("box shapes", fontsize=9)
    fig.tight_layout()
    out = Path(save_dir) / "labels.jpg"
    fig.savefig(out, dpi=120)
    if len(boxes):
        dims = ["x", "y", "width", "height"]
        fig, axes = chart.subplots(4, 4, figsize=(9, 9))
        for i in range(4):
            for j in range(4):
                ax = axes[i][j]
                if i == j:
                    ax.hist(boxes[:, i], bins=50, color="#3070ff")
                else:
                    ax.hist2d(boxes[:, j], boxes[:, i], bins=50, cmap="Blues")
                if i == 3:
                    ax.set_xlabel(dims[j], fontsize=8)
                if j == 0:
                    ax.set_ylabel(dims[i], fontsize=8)
                ax.tick_params(labelsize=6)
        fig.tight_layout()
        fig.savefig(Path(save_dir) / "labels_correlogram.jpg", dpi=120)
    return out


# ---- mosaics ----------------------------------------------------------------------------------

def _blend_mask(img, mask, color, alpha=0.45):
    """Alpha-blend a boolean instance mask (any resolution: OpenCV's INTER_NEAREST to the
    image) onto img in place, in float64, truncated to uint8."""
    h, w = img.shape[:2]
    m = np.asarray(mask)
    m = cv.resize_nearest_cv(m.astype(np.uint8), (w, h)).astype(bool) if m.shape != (h, w) \
        else m.astype(bool)
    img[m] = (img[m] * (1 - alpha) + np.asarray(color, np.float32) * alpha).astype(np.uint8)


def _draw_kpts(img, kpts, color, kpt_conf=0.25):
    """A (K, 2|3) keypoint set: dots of radius 2, and COCO's skeleton where K is 17."""
    kpts = np.asarray(kpts, np.float32)
    K = len(kpts)
    vis = kpts[:, 2] > kpt_conf if kpts.shape[1] > 2 else np.ones(K, bool)
    for (x, y), v in zip(kpts[:, :2], vis):
        if v and x > 0 and y > 0:
            cv.circle(img, (int(x), int(y)), 2, color, -1)
    if K == 17:
        for a, b in COCO_SKELETON:
            if vis[a] and vis[b] and kpts[a, :2].min() > 0 and kpts[b, :2].min() > 0:
                cv.line(img, (int(kpts[a, 0]), int(kpts[a, 1])),
                        (int(kpts[b, 0]), int(kpts[b, 1])), color, 1)


def _rbox_corners(cx, cy, w, h, r):
    """The 4 corners (int32) of a rotated box: centre, size and angle in radians."""
    cos, sin = np.cos(r), np.sin(r)
    dx = np.array([w / 2, w / 2, -w / 2, -w / 2])
    dy = np.array([h / 2, -h / 2, -h / 2, h / 2])
    xs = cx + dx * cos - dy * sin
    ys = cy + dx * sin + dy * cos
    return np.stack([xs, ys], -1).astype(np.int32)


def _canvas(imgs: np.ndarray, max_images: int) -> tuple:
    """(uint8 images, count drawn, columns, white canvas) of a mosaic in h x w cells."""
    if imgs.dtype != np.uint8:
        imgs = (np.asarray(imgs) * 255).clip(0, 255).astype(np.uint8)
    B = min(len(imgs), max_images)
    h, w = imgs.shape[1:3]
    cols = int(np.ceil(np.sqrt(B)))
    rows = int(np.ceil(B / cols))
    return imgs, B, cols, np.full((rows * h, cols * w, 3), 255, np.uint8)


def _tile(canvas, img, b: int, cols: int):
    h, w = img.shape[:2]
    r, c = divmod(b, cols)
    canvas[r * h:(r + 1) * h, c * w:(c + 1) * w] = img


def plot_predictions(imgs, dets, save_path="val_batch_pred.png", names=None,
                     max_images: int = 16, conf: float = 0.25, masks=None,
                     kpts=None, rotated: bool = False):
    """Prediction mosaic of a batch of RGB images: dets a list per image of (n, >= 6)
    [x1 y1 x2 y2 conf cls] rows in the images' pixels, or with rotated=True (n, 7)
    [cx cy w h r conf cls]; rows under conf are not drawn. masks: per image (n, mh, mw)
    bool masks aligned with the rows; kpts: per image (n, K, 2|3) keypoints in pixels.
    Written as BGR."""
    imgs, B, cols, canvas = _canvas(np.asarray(imgs), max_images)
    conf_c, cls_c = (5, 6) if rotated else (4, 5)
    for b in range(B):
        img = imgs[b].copy()
        d = np.asarray(dets[b]) if b < len(dets) and dets[b] is not None else np.zeros((0, 6))
        for ri, row in enumerate(d):
            if row[conf_c] < conf:
                continue
            c = int(row[cls_c])
            color = tuple(int(v) for v in PALETTE[c % len(PALETTE)])
            if rotated:
                pts = _rbox_corners(*(float(v) for v in row[:5]))
                cv.polylines(img, [pts], True, color, 1)
            else:
                cv.rectangle(img, (int(row[0]), int(row[1])), (int(row[2]), int(row[3])), color, 1)
            tx, ty = int(row[0]), max(10, int(row[1]) - 2)
            if masks is not None and b < len(masks) and masks[b] is not None \
                    and ri < len(masks[b]):
                _blend_mask(img, masks[b][ri], PALETTE[ri % len(PALETTE)])
            if kpts is not None and b < len(kpts) and kpts[b] is not None \
                    and ri < len(kpts[b]):
                _draw_kpts(img, kpts[b][ri], color)
            cv.put_text(img, f"{(names or {}).get(c, c)} {row[conf_c]:.2f}", (tx, ty), 0.35,
                        color, 1)
        _tile(canvas, img, b, cols)
    imwrite(save_path, canvas[..., ::-1])
    return save_path


def plot_images(batch, save_path="train_batch.png", max_images: int = 16, names=None):
    """Ground-truth mosaic of a batch dict: img (B, h, w, 3) RGB (uint8, or floats in
    [0, 1]), bboxes (B, M, 4) normalized cxcywh or (B, M, 5) with the angle, mask and cls
    (B, M); `masks` (B, mh, mw) instance-id overlap maps and `keypoints` (B, M, K, 2|3)
    normalized where present. Written as BGR."""
    imgs, B, cols, canvas = _canvas(np.asarray(batch["img"]), max_images)
    for b in range(B):
        img = imgs[b].copy()
        h, w = img.shape[:2]
        mask = np.asarray(batch["mask"][b]) > 0
        boxes = np.asarray(batch["bboxes"][b])[mask]
        cls = np.asarray(batch["cls"][b])[mask]
        rotated = boxes.shape[-1] == 5 if boxes.ndim == 2 else False
        if "masks" in batch:
            overlap = np.asarray(batch["masks"][b])
            for ii, gi in enumerate(np.nonzero(mask)[0]):
                _blend_mask(img, overlap == gi + 1, PALETTE[ii % len(PALETTE)])
        for box, c in zip(boxes, cls):
            color = tuple(int(v) for v in PALETTE[int(c) % len(PALETTE)])
            if rotated:
                cx, cy, bw, bh = box[0] * w, box[1] * h, box[2] * w, box[3] * h
                cv.polylines(img, [_rbox_corners(cx, cy, bw, bh, float(box[4]))], True, color, 1)
            else:
                cx, cy, bw, bh = box[:4] * [w, h, w, h]
                cv.rectangle(img, (int(cx - bw / 2), int(cy - bh / 2)),
                             (int(cx + bw / 2), int(cy + bh / 2)), color, 1)
        if "keypoints" in batch:
            for ii, kp in enumerate(np.asarray(batch["keypoints"][b])[mask]):
                kp = kp.copy().astype(np.float32)
                kp[..., 0] *= w
                kp[..., 1] *= h
                _draw_kpts(img, kp, tuple(int(v) for v in PALETTE[ii % len(PALETTE)]))
        _tile(canvas, img, b, cols)
    imwrite(save_path, canvas[..., ::-1])
    return save_path
