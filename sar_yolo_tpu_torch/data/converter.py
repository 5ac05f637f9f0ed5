"""Dataset converters to YOLO txt labels (port of `sar_yolo_tpu/data/converter.py`): COCO
json to box or polygon rows, DOTA's corner annotations to OBB rows, and the COCO 80 -> 91
class map. Image sizes come from the files' headers (`imageio.image_shape`, a JPEG's Exif
orientation applied as `cv2.imread` applies it)."""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

from sar_yolo_tpu_torch.data.imageio import _exif_orientation, _kind, image_shape
from sar_yolo_tpu_torch.utils import LOGGER

# COCO's 91-index category id -> its contiguous 80-class index
COCO80_MAP = {cid: i for i, cid in enumerate(
    c for c in range(1, 91) if c not in {12, 26, 29, 30, 45, 66, 68, 69, 71, 83})}


def convert_coco(annotations_json, save_dir="coco_converted", use_segments: bool = False,
                 cls91to80: bool = True):
    """A COCO annotation json -> one YOLO txt label file an image under save_dir/labels
    (crowd annotations skipped; `use_segments`: the first polygon of each annotation)."""
    save_dir = Path(save_dir)
    (save_dir / "labels").mkdir(parents=True, exist_ok=True)
    data = json.loads(Path(annotations_json).read_text())
    images = {im["id"]: im for im in data["images"]}
    per_image = defaultdict(list)
    for ann in data.get("annotations", []):
        if not ann.get("iscrowd"):
            per_image[ann["image_id"]].append(ann)
    for img_id, anns in per_image.items():
        im = images[img_id]
        w, h = im["width"], im["height"]
        lines = []
        for ann in anns:
            cid = ann["category_id"]
            cls = COCO80_MAP.get(cid, cid - 1) if cls91to80 else cid - 1
            if use_segments and ann.get("segmentation"):
                seg = ann["segmentation"][0]
                lines.append(" ".join([str(cls), *(f"{x / (w if i % 2 == 0 else h):.6f}"
                                                   for i, x in enumerate(seg))]))
            else:
                x, y, bw, bh = ann["bbox"]
                lines.append(f"{cls} {(x + bw / 2) / w:.6f} {(y + bh / 2) / h:.6f} "
                             f"{bw / w:.6f} {bh / h:.6f}")
        (save_dir / "labels" / (Path(im["file_name"]).stem + ".txt")).write_text("\n".join(lines))
    LOGGER.info(f"convert_coco: wrote {len(per_image)} label files to {save_dir / 'labels'}")
    return save_dir


DOTA_CLASSES = (
    "plane", "ship", "storage tank", "baseball diamond", "tennis court",
    "basketball court", "ground track field", "harbor", "bridge",
    "large vehicle", "small vehicle", "helicopter", "roundabout",
    "soccer ball field", "swimming pool", "container crane", "airport",
    "helipad")  # DOTA v1.0's 15 classes, then v1.5's and v2.0's


def _shape(path: Path):
    """(h, w) of an image as `cv2.imread` would decode it, or None."""
    hw = image_shape(path)
    data = path.read_bytes()
    if hw is not None and _kind(data[:16]) == "JPEG" and _exif_orientation(data) >= 5:
        hw = hw[::-1]  # orientations 5-8 transpose the image
    return hw


def convert_dota_to_yolo_obb(dota_root, version: str = "1.0"):
    """DOTA annotations -> YOLO-OBB labels.

    Reads `dota_root/images/{train,val}/<stem>.<png|jpg|jpeg|bmp|tif>` and
    `dota_root/labels/{train,val}_original/<stem>.txt` (rows `x1 y1 ... x4 y4 class_name
    difficulty`; headers and malformed rows skipped), and writes normalized
    `cls x1 y1 ... x4 y4` rows to `dota_root/labels/{train,val}/`.
    """
    root = Path(dota_root)
    nv = {"1.0": 15, "1.5": 16, "2.0": 18}.get(str(version), 15)
    cls_map = {name: i for i, name in enumerate(DOTA_CLASSES[:nv])}
    n = 0
    for split in ("train", "val"):
        orig = root / "labels" / f"{split}_original"
        if not orig.is_dir():
            continue
        out_dir = root / "labels" / split
        out_dir.mkdir(parents=True, exist_ok=True)
        img_dir = root / "images" / split
        for lf in sorted(orig.glob("*.txt")):
            img = next((p for ext in ("png", "jpg", "jpeg", "bmp", "tif")
                        for p in [img_dir / f"{lf.stem}.{ext}"] if p.is_file()), None)
            if img is None:
                LOGGER.warning(f"convert_dota: no image for {lf.stem}, skipped")
                continue
            hw = _shape(img)
            if hw is None:
                LOGGER.warning(f"convert_dota: unreadable image {img}, skipped")
                continue
            h, w = hw
            lines = []
            for row in lf.read_text().splitlines():
                parts = row.split()
                if len(parts) < 9:
                    continue
                try:
                    coords = [float(v) for v in parts[:8]]
                except ValueError:
                    continue
                name = " ".join(parts[8:-1]) if parts[-1].lstrip("-").isdigit() \
                    else " ".join(parts[8:])
                name = name.replace("-", " ")
                if name not in cls_map:
                    LOGGER.warning(f"convert_dota: unknown class '{name}' in {lf.name}")
                    continue
                norm = [coords[i] / (w if i % 2 == 0 else h) for i in range(8)]
                lines.append(" ".join([str(cls_map[name])] + [f"{v:.6g}" for v in norm]))
            (out_dir / lf.name).write_text("\n".join(lines))
            n += 1
    LOGGER.info(f"convert_dota_to_yolo_obb: wrote {n} label files under {root / 'labels'}")
    return root


def coco80_to_coco91_class() -> list:
    """The COCO json category id of each of the 80 contiguous classes."""
    return sorted(COCO80_MAP)
