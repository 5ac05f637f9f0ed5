"""Detection, JDE, pose and segment datasets: YOLO-format folders on disk, class folders
and procedural data (port of `sar_yolo_tpu/data/dataset.py`: `check_det_dataset`,
`YOLODataset` with its box, keypoint and polygon branches, `SyntheticDataset` with its OBB
and classify branches, `ClassificationDataset`, YOLO-World's `GroundingDataset`)."""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from sar_yolo_tpu_torch.data import cv
from sar_yolo_tpu_torch.data.augment import (augment_hsv, copy_paste, letterbox, mixup, mosaic4,
                                             random_flip, random_perspective)
from sar_yolo_tpu_torch.data.imageio import image_shape, imread
from sar_yolo_tpu_torch.utils import LOGGER
from sar_yolo_tpu_torch.utils.dataset_yaml import load_yaml

_COLORS = [(220, 40, 40), (40, 220, 40), (40, 40, 220), (220, 220, 40), (220, 40, 220)]


class SyntheticDataset:
    """Coloured rectangles on noise, deterministic per index; no files needed.

    Each item: 'img' (s, s, 3) uint8, 'cls' (M,), 'bboxes' (M, 4) normalized
    xywh, 'mask' (M,), and for JDE 'tags' (M,) person ids, all float32 and
    padded to M = max_labels rows; 1-5 rectangles with sides 0.1-0.3 of the
    image. Under JDE a rectangle's colour follows its identity tag, so the
    embedding and state heads have a signal. Pose adds 'keypoints' (M, K, D): the
    first K of the rectangle's corners and centre (visibility 2), the rest zero;
    segment adds 'masks' (s/4, s/4): the rectangles at a quarter of the size, instance
    i + 1 where the i-th lies. OBB: 1-5 rotated rectangles (sides 0.12-0.3, centres in
    0.25-0.75 of the image, angle in [-pi/4, 3pi/4)) drawn by `cv.fill_poly` on their int32
    corners, 'bboxes' (M, 5) normalized xywh and the angle. Classify: one square of the
    class's colour in the middle, 'cls' a float32 scalar.
    """

    def __init__(self, n=64, imgsz=640, nc=3, max_labels=128, seed=0, task="detect",
                 kpt_shape=(5, 3)):
        if task not in ("detect", "jde", "pose", "segment", "obb", "classify"):
            raise ValueError(f"SyntheticDataset: task '{task}' is not part of this port yet")
        self.n, self.imgsz, self.nc, self.max_labels = n, imgsz, nc, max_labels
        self.seed, self.task, self.kpt_shape = seed, task, tuple(kpt_shape)
        self.device_augment = False  # the trainer's: augment these tiles on the device

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(self.seed * 100003 + i)
        s, M = self.imgsz, self.max_labels
        img = rng.uniform(0, 60, (s, s, 3)).astype(np.uint8)
        if self.task == "classify":
            c = int(rng.integers(0, self.nc))
            img[s // 4:3 * s // 4, s // 4:3 * s // 4] = _COLORS[c % 3]
            return {"img": img, "cls": np.float32(c)}
        n_obj = int(rng.integers(1, 6))
        if self.task == "obb":
            return self._obb_item(rng, img, n_obj)
        cls = np.zeros(M, np.float32)
        boxes = np.zeros((M, 4), np.float32)
        mask = np.zeros(M, np.float32)
        tags = np.zeros(M, np.float32)
        K, kd = self.kpt_shape
        kpts = np.zeros((M, K, kd), np.float32)
        seg = np.zeros((s // 4, s // 4), np.float32)
        for j in range(n_obj):
            c = int(rng.integers(0, self.nc))
            w = rng.uniform(0.1, 0.3) * s
            h = rng.uniform(0.1, 0.3) * s
            cx = rng.uniform(w / 2, s - w / 2)
            cy = rng.uniform(h / 2, s - h / 2)
            x1, y1, x2, y2 = int(cx - w / 2), int(cy - h / 2), int(cx + w / 2), int(cy + h / 2)
            tag = j % 4
            img[y1:y2, x1:x2] = _COLORS[(tag if self.task == "jde" else c) % len(_COLORS)]
            boxes[j] = [cx / s, cy / s, w / s, h / s]
            cls[j], mask[j], tags[j] = c, 1.0, tag
            if self.task == "pose":
                pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2), (cx, cy)][:K]
                for ki, (px, py) in enumerate(pts):
                    kpts[j, ki] = [px / s, py / s, 2.0][:kd]
            if self.task == "segment":
                seg[y1 // 4:y2 // 4, x1 // 4:x2 // 4] = j + 1
        out = {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}
        if self.task == "jde":
            out["tags"] = tags
        if self.task == "pose":
            out["keypoints"] = kpts
        if self.task == "segment":
            out["masks"] = seg
        return out


    def _obb_item(self, rng, img, n_obj: int) -> dict:
        s, M = self.imgsz, self.max_labels
        cls, mask = np.zeros(M, np.float32), np.zeros(M, np.float32)
        boxes5 = np.zeros((M, 5), np.float32)
        for j in range(n_obj):
            c = int(rng.integers(0, self.nc))
            w = rng.uniform(0.12, 0.3) * s
            h = rng.uniform(0.12, 0.3) * s
            cx = rng.uniform(0.25, 0.75) * s
            cy = rng.uniform(0.25, 0.75) * s
            r = rng.uniform(-np.pi / 4, 3 * np.pi / 4)
            cos, sin = np.cos(r), np.sin(r)
            pts = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
            corners = (pts @ np.array([[cos, sin], [-sin, cos]]) + [cx, cy]).astype(np.int32)
            cv.fill_poly(img, corners, _COLORS[c % 3])
            boxes5[j] = [cx / s, cy / s, w / s, h / s, r]
            cls[j], mask[j] = c, 1.0
        return {"img": img, "cls": cls, "bboxes": boxes5, "mask": mask}


IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}


def img2label_paths(img_paths) -> list[str]:
    """images/xxx.jpg -> labels/xxx.txt (the last `images` part of each path)."""
    out = []
    for p in img_paths:
        parts = list(Path(p).parts)
        for i in range(len(parts) - 1, -1, -1):
            if parts[i] == "images":
                parts[i] = "labels"
                break
        out.append(str(Path(*parts).with_suffix(".txt")))
    return out


def check_det_dataset(data) -> dict:
    """A dataset dict or YAML file -> {path, train, val, [test], names, nc, ...} with the
    splits as absolute paths (a YAML's relative `path` is taken from its folder)."""
    d = load_yaml(data) if isinstance(data, (str, Path)) else dict(data)
    root = Path(d.get("path", Path(data).parent if isinstance(data, (str, Path)) else "."))
    if not root.is_absolute() and isinstance(data, (str, Path)):
        root = (Path(data).parent / root).resolve()

    def _resolve(v):
        p = Path(v)
        return str(p if p.is_absolute() else root / p)

    for split in ("train", "val", "test"):
        if d.get(split):
            d[split] = [_resolve(v) for v in d[split]] \
                if isinstance(d[split], (list, tuple)) else _resolve(d[split])
    names = d.get("names", {})
    if isinstance(names, list):
        names = dict(enumerate(names))
    d["names"] = names
    d["nc"] = d.get("nc", len(names))
    return d


class YOLODataset:
    """Detection, JDE, pose and segment samples from an image folder (or list file) with
    YOLO txt labels (port of `sar_yolo_tpu/data/dataset.py::YOLODataset`).

    Each label row, normalized: `class cx cy w h [person_id]` (the 6th column becomes
    `tags` under JDE); pose `class cx cy w h x1 y1 v1 ... xK yK vK` (K x D values of
    `kpt_shape`); segment `class x1 y1 x2 y2 ...` (a polygon: an odd value count above 5;
    the box is the polygon's extent). Labels and image shapes are verified once and kept in
    `labels/<split>.cache.npz` under the JAX package's name, hash and layout, so either
    package reads a cache the other wrote. Images that cannot be read or are under
    10 px are dropped, as are unreadable label files.

    augment=True is the training path under `hyp`: with mosaic on, mosaic4 ->
    copy-paste -> affine; otherwise (and after close_mosaic) letterbox -> copy-paste ->
    affine; then HSV and flips. Each sample's draws come from
    `default_rng((hyp.seed, epoch, index))`. With device_augment as well, the host only
    letterboxes (upscaling, as training does) and the trainer augments on the device
    (`data/device_augment.py`). augment=False letterboxes to imgsz, or to the batch
    shapes of `init_rect`, and adds `ratio_pad`, `ori_shape` and `im_file`.
    Items are padded to `max_labels` rows, images uint8 HWC RGB; pose items carry
    'keypoints' (M, K, D) normalized, segment items 'masks' (imgsz/4, imgsz/4): each
    polygon drawn by `cv.fill_poly` at round(poly / 4) with its instance number (later
    ones over earlier ones), on a square map also in rect batches, as in the JAX package.
    `flip_idx` permutes the keypoints of a horizontal flip.
    """

    def __init__(self, img_path, imgsz=640, augment=False, hyp=None, use_tags=False,
                 max_labels=128, single_cls=False, fraction=1.0, task="detect",
                 kpt_shape=(17, 3), cache=False, device_augment=False, flip_idx=None):
        if task == "obb":
            raise NotImplementedError(
                "YOLODataset: task 'obb' is not part of this port: the JAX package has no OBB "
                "label branch either (a DOTA row 'class x1 y1 ... x4 y4' takes its detect branch "
                "and becomes a 4-column box, on which its obb_loss fails), so OBB trains and "
                "validates on data='synthetic' only")
        if task not in ("detect", "jde", "pose", "segment"):
            raise NotImplementedError(f"YOLODataset: task '{task}' is not part of this port yet")
        self.imgsz = imgsz
        self.flip_idx = flip_idx
        self.device_augment = bool(device_augment and augment)
        self.scaleup = augment
        self.augment = augment and not self.device_augment
        if self.augment and hyp is not None:
            for key in ("mosaic9", "perspective"):
                if float(getattr(hyp, key, 0) or 0) > 0:
                    raise NotImplementedError(f"{key} > 0 is not part of this port yet")
        self.hyp = hyp
        self.use_tags = use_tags or task == "jde"
        self.max_labels = max_labels
        self.single_cls = single_cls
        self.task = task
        self.kpt_shape = tuple(kpt_shape)
        self.mosaic_enabled = bool(self.augment and hyp is not None and getattr(hyp, "mosaic", 0) > 0)
        self.im_files = self._scan_images(img_path)
        if fraction < 1.0:
            self.im_files = self.im_files[: max(1, int(len(self.im_files) * fraction))]
        self.label_files = img2label_paths(self.im_files)
        self.shapes = None  # (n, 2) h, w per image, from the verify cache
        self._load_or_build_cache()
        self.seed = int(getattr(hyp, "seed", 0) or 0) if hyp is not None else 0
        self.epoch = 0  # set by DataLoader.set_epoch; keys the per-sample draws
        # 'ram' / True keeps decoded images in memory; 'disk' reads and writes .npy sidecars
        self.cache = bool(cache) and str(cache).lower() != "disk"
        self.cache_disk = str(cache).lower() == "disk"
        self._im_cache: dict[int, np.ndarray] = {}
        self.rect = False
        self.batch_shapes = None
        self.batch_index = None

    # ---- label cache + verification -------------------------------------
    def _cache_path(self) -> Path:
        lp = Path(self.label_files[0]).parent if self.label_files else Path(".")
        return lp.with_suffix(".cache.npz")

    def _cache_hash(self) -> str:
        h = hashlib.sha1()
        h.update(f"{self.task}|{self.kpt_shape}|{len(self.im_files)}".encode())
        for im, lf in zip(self.im_files, self.label_files):
            st = Path(lf).stat() if Path(lf).is_file() else None
            h.update(f"{im}|{lf}|{st.st_mtime_ns if st else 0}|{st.st_size if st else 0}".encode())
        return h.hexdigest()

    def _load_or_build_cache(self):
        """Parse and verify the labels once; kept in labels/<split>.cache.npz."""
        cache_file = self._cache_path()
        want = self._cache_hash()
        if cache_file.is_file():
            try:
                z = np.load(cache_file, allow_pickle=True)
                if str(z["hash"]) == want:
                    self.im_files = list(z["im_files"])
                    self.label_files = list(z["label_files"])
                    self.labels = list(z["labels"])
                    self.shapes = z["shapes"]
                    return
            except Exception:  # noqa: BLE001 — a stale or unreadable cache is rebuilt
                pass
        keep_im, keep_lf, labels, shapes, dropped = [], [], [], [], 0
        for im, lf in zip(self.im_files, self.label_files):
            shape = image_shape(im)
            if shape is None or min(shape) < 10:
                dropped += 1
                continue
            try:
                lb = self._load_label(lf)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning(f"corrupt label {lf}: {e}")
                dropped += 1
                continue
            keep_im.append(im)
            keep_lf.append(lf)
            labels.append(lb)
            shapes.append(shape)
        if dropped:
            LOGGER.warning(f"dropped {dropped} corrupt images/labels from {len(self.im_files)}")
        if not keep_im:
            raise FileNotFoundError("all images failed verification")
        self.im_files, self.label_files, self.labels = keep_im, keep_lf, labels
        self.shapes = np.array(shapes, np.int64)
        try:
            np.savez_compressed(
                cache_file, hash=want, im_files=np.array(self.im_files, object),
                label_files=np.array(self.label_files, object),
                labels=np.array(self.labels, object), shapes=self.shapes)
        except OSError:
            pass  # a read-only dataset folder: verified, not kept

    # ---- rect batching ---------------------------------------------------
    def init_rect(self, batch_size: int, stride: int = 32, pad: float = 0.5, quant: int = 64):
        """Rectangular eval batches: images sorted by aspect ratio, each batch the
        tightest stride multiple (plus half a stride) that covers its images, the short
        side rounded up to a multiple of `quant`."""
        n = len(self.im_files)
        ar = self.shapes[:, 0] / self.shapes[:, 1]  # h/w
        order = np.argsort(ar)
        self.im_files = [self.im_files[i] for i in order]
        self.label_files = [self.label_files[i] for i in order]
        self.labels = [self.labels[i] for i in order]
        self.shapes = self.shapes[order]
        ar = ar[order]
        nb = (n + batch_size - 1) // batch_size
        self.batch_index = np.floor(np.arange(n) / batch_size).astype(int)
        shapes = []
        for b in range(nb):
            arb = ar[self.batch_index == b]
            mini, maxi = float(arb.min()), float(arb.max())
            sh = [1.0, 1.0]
            if maxi < 1:
                sh = [maxi, 1.0]
            elif mini > 1:
                sh = [1.0, 1.0 / mini]
            hq = int(np.ceil(sh[0] * self.imgsz / stride + pad) * stride)
            wq = int(np.ceil(sh[1] * self.imgsz / stride + pad) * stride)
            if hq < wq:
                hq = min(int(np.ceil(hq / quant) * quant), wq)
            elif wq < hq:
                wq = min(int(np.ceil(wq / quant) * quant), hq)
            shapes.append((min(hq, self.imgsz + stride), min(wq, self.imgsz + stride)))
        self.batch_shapes = shapes
        self.rect = True
        LOGGER.info(f"rect val: {nb} batches over {len(set(shapes))} distinct shapes "
                    f"{sorted(set(shapes))}")

    @staticmethod
    def _scan_images(img_path) -> list[str]:
        files = []
        for p in ([img_path] if isinstance(img_path, (str, Path)) else img_path):
            p = Path(p)
            if p.is_dir():
                files += sorted(str(f) for f in p.rglob("*") if f.suffix[1:].lower() in IMG_FORMATS)
            elif p.is_file() and p.suffix == ".txt":
                base = p.parent
                for line in p.read_text().splitlines():
                    line = line.strip()
                    if line:
                        q = Path(line)
                        files.append(str(q if q.is_absolute() else base / q))
            elif p.is_file():
                files.append(str(p))
        if not files:
            raise FileNotFoundError(f"No images found in {img_path}")
        return files

    def _load_label(self, lf) -> dict:
        """One label file -> {cls, bboxes (normalized xywh), tags[, keypoints (n, K, D)]
        [, polygons (a list of (k, 2))]}."""
        lines = []
        if Path(lf).is_file():
            lines = [ln.split() for ln in Path(lf).read_text().splitlines() if ln.strip()]
        K, kd = self.kpt_shape
        cls, boxes, tags, kpts, polys = [], [], [], [], []
        for parts in lines:
            vals = [float(x) for x in parts]
            if self.task == "segment" and len(vals) > 5 and (len(vals) - 1) % 2 == 0:
                poly = np.array(vals[1:], np.float32).reshape(-1, 2)
                x1, y1 = poly.min(0)
                x2, y2 = poly.max(0)
                boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
                polys.append(poly)
                cls.append(vals[0])
                tags.append(0.0)
            elif self.task == "pose" and len(vals) >= 5 + K * kd:
                cls.append(vals[0])
                boxes.append(vals[1:5])
                kpts.append(np.array(vals[5:5 + K * kd], np.float32).reshape(K, kd))
                tags.append(0.0)
            elif len(vals) >= 5:
                cls.append(vals[0])
                boxes.append(vals[1:5])
                tags.append(vals[5] if len(vals) > 5 else 0.0)
        n = len(cls)
        out = {"cls": np.zeros(n, np.float32) if self.single_cls else np.array(cls, np.float32),
               "bboxes": np.array(boxes, np.float32).reshape(n, 4),
               "tags": np.array(tags, np.float32)}
        if self.task == "pose":
            out["keypoints"] = np.stack(kpts) if kpts else np.zeros((0, K, kd), np.float32)
        if self.task == "segment":
            out["polygons"] = polys
        return out

    def __len__(self):
        return len(self.im_files)

    def _load_item(self, i) -> dict:
        """Image i resized so that its long side is imgsz, labels in pixel xyxy."""
        img = self._im_cache.get(i) if self.cache else None
        if img is None and self.cache_disk:
            npy = Path(self.im_files[i]).with_suffix(".npy")
            if npy.is_file():
                img = np.load(npy)
        if img is None:
            img = imread(self.im_files[i])
            if img is None:
                raise FileNotFoundError(self.im_files[i])
            if self.cache:
                self._im_cache[i] = img
            elif self.cache_disk:
                try:
                    np.save(Path(self.im_files[i]).with_suffix(".npy"), img)
                except OSError:
                    pass  # a read-only dataset folder
        img = img.copy() if self.cache else img
        h0, w0 = img.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            img = cv.resize(img, (round(w0 * r), round(h0 * r)))
        h, w = img.shape[:2]
        lb = self.labels[i]
        boxes = lb["bboxes"].copy()
        if len(boxes):
            cx, cy, bw, bh = boxes[:, 0] * w, boxes[:, 1] * h, boxes[:, 2] * w, boxes[:, 3] * h
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
        item = {"img": img, "cls": lb["cls"].copy(), "bboxes": boxes.astype(np.float32),
                "ori_shape": np.array([h0, w0], np.float32), "r0": float(r),
                "im_file": self.im_files[i]}
        if self.use_tags:
            item["tags"] = lb["tags"].copy()
        if self.task == "pose" and "keypoints" in lb:
            k = lb["keypoints"].copy()
            if len(k):
                k[..., 0] *= w
                k[..., 1] *= h
            item["keypoints"] = k
        if self.task == "segment":
            item["polygons"] = [p * np.array([w, h], np.float32) for p in lb.get("polygons", [])]
        return item

    def _item_rng(self, i):
        """Per-sample draws keyed by (seed, epoch, index): the same whatever the worker
        count or order."""
        return np.random.default_rng((self.seed, self.epoch, i))

    def __getitem__(self, i):
        hyp = self.hyp
        rng = self._item_rng(i)
        if self.augment and self.mosaic_enabled and rng.random() < getattr(hyp, "mosaic", 1.0):
            def one_mosaic():
                idxs = [i] + list(rng.integers(0, len(self), 3))
                it = mosaic4([self._load_item(j) for j in idxs], self.imgsz, rng=rng)
                border = it.pop("mosaic_border")
                if getattr(hyp, "copy_paste", 0):
                    it = copy_paste(it, p=hyp.copy_paste, rng=rng)
                return random_perspective(it, degrees=hyp.degrees, translate=hyp.translate,
                                          scale=hyp.scale, shear=hyp.shear,
                                          perspective=hyp.perspective, border=border, rng=rng)
            item = one_mosaic()
            if getattr(hyp, "mixup", 0) and rng.random() < hyp.mixup:
                item = mixup(item, one_mosaic(), rng=rng)
        else:
            item = self._load_item(i)
            shape = self.batch_shapes[self.batch_index[i]] if self.rect else self.imgsz
            img, r, (padx, pady) = letterbox(item["img"], shape, scaleup=self.scaleup)
            if not self.scaleup:  # val batches only: the native-pixel mapping of predictions
                item["ratio_pad"] = np.array([item["r0"] * r, padx, pady], np.float32)
            if len(item["bboxes"]):
                item["bboxes"] = item["bboxes"] * r
                item["bboxes"][:, [0, 2]] += padx
                item["bboxes"][:, [1, 3]] += pady
            if "keypoints" in item and len(item["keypoints"]):
                item["keypoints"][..., 0] = item["keypoints"][..., 0] * r + padx
                item["keypoints"][..., 1] = item["keypoints"][..., 1] * r + pady
            if "polygons" in item:
                item["polygons"] = [p * r + np.array([padx, pady], np.float32)
                                    for p in item["polygons"]]
            item["img"] = img
            if self.augment:
                if getattr(hyp, "copy_paste", 0):
                    item = copy_paste(item, p=hyp.copy_paste, rng=rng)
                item = random_perspective(item, degrees=hyp.degrees, translate=hyp.translate,
                                          scale=hyp.scale, shear=hyp.shear,
                                          perspective=hyp.perspective, rng=rng)
        if self.augment:
            item["img"] = augment_hsv(item["img"], hyp.hsv_h, hyp.hsv_s, hyp.hsv_v, rng=rng)
            item = random_flip(item, fliplr=hyp.fliplr, flipud=hyp.flipud, rng=rng,
                               flip_idx=self.flip_idx)
        return self._format(item)

    def _format(self, item) -> dict:
        """Training arrays: img uint8 HWC RGB, labels padded to max_labels (normalized xywh)."""
        img = item["img"]
        h, w = img.shape[:2]
        img = np.ascontiguousarray(img[..., ::-1])  # BGR -> RGB
        M = self.max_labels
        n = min(len(item["bboxes"]), M)
        cls = np.zeros(M, np.float32)
        boxes = np.zeros((M, 4), np.float32)
        mask = np.zeros(M, np.float32)
        tags = np.zeros(M, np.float32)
        if n:
            b = item["bboxes"][:n]
            cx = (b[:, 0] + b[:, 2]) / 2 / w
            cy = (b[:, 1] + b[:, 3]) / 2 / h
            bw = (b[:, 2] - b[:, 0]) / w
            bh = (b[:, 3] - b[:, 1]) / h
            boxes[:n] = np.stack([cx, cy, bw, bh], 1)
            cls[:n] = item["cls"][:n]
            mask[:n] = 1.0
            if self.use_tags:
                tags[:n] = item["tags"][:n]
        out = {"img": img, "cls": cls, "bboxes": boxes, "mask": mask}
        if "ratio_pad" in item:  # val path: native-space mapping metadata
            out["ratio_pad"] = item["ratio_pad"]
            out["ori_shape"] = item["ori_shape"]
            out["im_file"] = item["im_file"]
        if self.use_tags:
            out["tags"] = tags
        if self.task == "pose":
            K, kd = self.kpt_shape
            kp = np.zeros((M, K, kd), np.float32)
            if n and "keypoints" in item and len(item["keypoints"]):
                kk = item["keypoints"][:n].copy()
                kk[..., 0] /= w
                kk[..., 1] /= h
                kp[:n] = kk
            out["keypoints"] = kp
        if self.task == "segment":
            ms = self.imgsz // 4
            seg = np.zeros((ms, ms), np.float32)
            for j, poly in enumerate(item.get("polygons", [])[:n]):
                cv.fill_poly(seg, np.round(poly / 4).astype(np.int32), float(j + 1))
            out["masks"] = seg
        return out


class GroundingDataset(YOLODataset):
    """Detection samples of a grounding annotation (port of the JAX package's
    `GroundingDataset`): images under `img_path`, labels from ONE COCO-style json whose
    per-image `caption` and each annotation's `tokens_positive` spans name its class.

    Each image's phrases number its classes in order of first appearance ("object" where an
    annotation has no span); the phrase list rides on the label as `texts`. Crowd
    annotations, boxes without area and exact duplicate rows are dropped; images missing on
    disk are skipped; shapes come from the json's height and width. Detect only.
    """

    def __init__(self, img_path, json_file, task: str = "detect", fraction: float = 1.0,
                 **kwargs):
        if task != "detect":
            raise ValueError("GroundingDataset only supports task='detect'")
        self.json_file = json_file
        self._fraction = fraction
        super().__init__(img_path, task=task, **kwargs)

    def _scan_images(self, img_path) -> list[str]:
        self._img_root = Path(img_path)
        return []  # filled from the json by _load_or_build_cache

    def _load_or_build_cache(self):
        with open(self.json_file) as f:
            ann_json = json.load(f)
        images = {int(x["id"]): x for x in ann_json["images"]}
        by_img: dict[int, list] = {}
        for ann in ann_json["annotations"]:
            by_img.setdefault(int(ann["image_id"]), []).append(ann)
        self.im_files, self.label_files, self.labels, shapes = [], [], [], []
        for img_id, anns in by_img.items():
            img = images[img_id]
            h, w = img["height"], img["width"]
            im_file = self._img_root / img["file_name"]
            if not im_file.exists():
                continue
            caption = img.get("caption", "")
            cat2id, texts, rows = {}, [], []
            for ann in anns:
                if ann.get("iscrowd"):
                    continue
                x, y, bw, bh = (float(v) for v in ann["bbox"])  # xywh, top-left, pixels
                box = np.array([(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h], np.float32)
                if box[2] <= 0 or box[3] <= 0:
                    continue
                phrase = " ".join(caption[t0:t1] for t0, t1 in
                                  ann.get("tokens_positive", [])) or "object"
                if phrase not in cat2id:
                    cat2id[phrase] = len(cat2id)
                    texts.append([phrase])
                row = [float(cat2id[phrase]), *box.tolist()]
                if row not in rows:
                    rows.append(row)
            lb = np.array(rows, np.float32) if rows else np.zeros((0, 5), np.float32)
            self.im_files.append(str(im_file))
            self.label_files.append(str(self.json_file))
            self.labels.append({"cls": lb[:, 0], "bboxes": lb[:, 1:5],
                                "tags": np.zeros(len(lb), np.float32), "texts": texts})
            shapes.append((h, w))
        if not self.im_files:
            raise FileNotFoundError(f"no images from {self.json_file} exist under {self._img_root}")
        if self._fraction < 1.0:
            k = max(1, int(len(self.im_files) * self._fraction))
            self.im_files, self.label_files = self.im_files[:k], self.label_files[:k]
            self.labels, shapes = self.labels[:k], shapes[:k]
        self.shapes = np.array(shapes, np.int64)


class ClassificationDataset:
    """Class-folder samples: root/<class name>/<image>, the class ids in the sorted order of
    the folder names, each class's images (PNG or JPEG, `imageio.imread`) in sorted order
    of their paths under it.

    augment=True: a random resized crop (up to 10 draws of an area of 0.25-1 of the image
    and an aspect ratio of 3/4-4/3; the whole image where none fits), resized to
    imgsz x imgsz (`cv.resize`: OpenCV's INTER_LINEAR), a horizontal flip at 0.5, then
    `augment_hsv` with hyp's gains; the draws of item i come from
    `default_rng((seed, epoch, i))`. augment=False: the shorter side resized to imgsz (the
    other round(side x r), Python's rounding), then the centre imgsz x imgsz crop. Items:
    'img' (imgsz, imgsz, 3) uint8 RGB and 'cls' a float32 scalar.
    """

    def __init__(self, root, imgsz=224, augment=False, hyp=None, seed=0):
        self.root, self.imgsz, self.augment, self.hyp = Path(root), imgsz, augment, hyp
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class folders under {root}")
        self.names = dict(enumerate(classes))
        self.samples = [(str(f), ci) for ci, c in enumerate(classes)
                        for f in sorted((self.root / c).rglob("*"))
                        if f.suffix[1:].lower() in IMG_FORMATS]
        if not self.samples:
            raise FileNotFoundError(f"no images under {root}")
        self.seed = seed
        self.epoch = 0  # set by DataLoader.set_epoch; keys the per-item draws

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, self.epoch, i))
        path, ci = self.samples[i]
        img = imread(path)
        if img is None:
            raise FileNotFoundError(path)
        s = self.imgsz
        h, w = img.shape[:2]
        if self.augment:
            for _ in range(10):
                area = rng.uniform(0.25, 1.0) * h * w
                ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(area * ratio)))
                ch = int(round(np.sqrt(area / ratio)))
                if cw <= w and ch <= h:
                    x0 = int(rng.integers(0, w - cw + 1))
                    y0 = int(rng.integers(0, h - ch + 1))
                    img = img[y0:y0 + ch, x0:x0 + cw]
                    break
            img = cv.resize(img, (s, s))
            if rng.random() < 0.5:
                img = np.fliplr(img).copy()
            if self.hyp is not None:
                img = augment_hsv(img, self.hyp.hsv_h, self.hyp.hsv_s, self.hyp.hsv_v, rng=rng)
        else:
            r = s / min(h, w)
            img = cv.resize(img, (round(w * r), round(h * r)))
            hh, ww = img.shape[:2]
            y0, x0 = (hh - s) // 2, (ww - s) // 2
            img = img[y0:y0 + s, x0:x0 + s]
        return {"img": np.ascontiguousarray(img[..., ::-1]), "cls": np.float32(ci)}
