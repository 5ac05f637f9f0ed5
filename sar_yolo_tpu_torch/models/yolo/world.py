"""YOLO-World: open-vocabulary detection (port of `sar_yolo_tpu/models/yolo/world.py`).

`set_classes(names)` swaps the vocabulary by replacing the graph's `text_embeddings` rows;
the convolutions keep their shapes and the head's class channels follow the row count.

Text encoder: the reference embeds prompts with CLIP. `clip_text_embeddings` needs the
`transformers` package and CLIP weights on disk; without them `set_classes` warns and uses
`offline_text_embeddings`, a sha256-seeded random projection (stable across runs and equal
to the JAX package's bit for bit, distinct per prompt, but with no semantic transfer), as
the JAX package does. Pass real embeddings (an array or a `.npz` of `save_text_embeddings`)
for true open-vocabulary use.
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from sar_yolo_tpu_torch.engine.model import YOLO
from sar_yolo_tpu_torch.utils import LOGGER, ROOT

CLIP_DIR = ROOT / "weights" / "clip"  # where clip_text_embeddings looks for CLIP weights


def offline_text_embeddings(names, dim: int = 512) -> np.ndarray:
    """(n, dim) float32 unit rows, each from a generator seeded with the first 8 bytes of
    the sha256 of its name (little-endian)."""
    out = np.zeros((len(names), dim), np.float32)
    for i, name in enumerate(names):
        seed = int.from_bytes(hashlib.sha256(str(name).encode()).digest()[:8], "little")
        v = np.random.default_rng(seed).normal(size=dim).astype(np.float32)
        out[i] = v / (np.linalg.norm(v) + 1e-9)
    return out


def clip_text_embeddings(names, model_id: str = "openai/clip-vit-base-patch32",
                         template: str = "a photo of a {}", cache_dir=CLIP_DIR) -> np.ndarray:
    """CLIP text embeddings of `template` around each name (unit rows), from the
    `transformers` package and weights under `cache_dir` (nothing is downloaded). Raises
    RuntimeError where either is missing."""
    if not Path(cache_dir).is_dir():
        raise RuntimeError(f"no CLIP weights under {cache_dir}; pass "
                           "set_classes(names, embeddings=<array or .npz>)")
    try:
        from transformers import CLIPTextModelWithProjection, CLIPTokenizer
    except ImportError as e:
        raise RuntimeError("clip_text_embeddings requires `transformers`; use "
                           "offline_text_embeddings or a precomputed .npz instead") from e
    try:
        tok = CLIPTokenizer.from_pretrained(model_id, cache_dir=str(cache_dir),
                                            local_files_only=True)
        enc = CLIPTextModelWithProjection.from_pretrained(model_id, cache_dir=str(cache_dir),
                                                          local_files_only=True)
    except Exception as e:
        raise RuntimeError(f"CLIP weights for '{model_id}' are not under {cache_dir}; pass "
                           "set_classes(names, embeddings=<array or .npz>)") from e
    with torch.no_grad():
        batch = tok([template.format(str(n)) for n in names], padding=True, return_tensors="pt")
        emb = enc(**batch).text_embeds.float().numpy()
    return emb / (np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-9)


def load_text_embeddings(path) -> tuple[list, np.ndarray]:
    """A `.npz` of {names: (n,) str, embeddings: (n, D) float32} -> (names, embeddings)."""
    z = np.load(path, allow_pickle=False)
    return [str(n) for n in z["names"]], np.asarray(z["embeddings"], np.float32)


def save_text_embeddings(path, names, embeddings=None):
    """Write names and their embeddings (default: `clip_text_embeddings`) as a `.npz` that
    `load_text_embeddings` and `set_classes(embeddings=path)` read. Returns path."""
    emb = clip_text_embeddings(names) if embeddings is None else np.asarray(embeddings, np.float32)
    np.savez(path, names=np.asarray([str(n) for n in names]), embeddings=emb)
    return path


class YOLOWorld(YOLO):
    """YOLO with a text-conditioned WorldDetect head.

    Examples:
        >>> m = YOLOWorld("yolov8s-world.yaml")             # on cuda; raises without CUDA
        >>> m.set_classes(["person", "boat", "car", "backpack"])
        >>> rows = m.predict_batched(frames_u8)               # (B, 300, 6), cls in 0..3
    """

    def __init__(self, model: str = "yolov8s-world.yaml", task: str | None = None, device=None):
        super().__init__(model, task="detect", device=device)

    def set_classes(self, names, embeddings=None) -> "YOLOWorld":
        """Swap the vocabulary: `names` and their text rows, from `embeddings` (an (n, E) array
        or a `.npz` path of `save_text_embeddings`), else CLIP, else (with a warning) the
        offline encoder. The serving caches are dropped."""
        self._ensure_variables()
        txt = getattr(self.model, "text_embeddings", None)
        if txt is None:
            raise ValueError("set_classes needs a World model (a graph with text_embeddings)")
        embed_dim = int(txt.shape[-1])
        if isinstance(embeddings, (str, bytes, Path)) or hasattr(embeddings, "read"):
            ref_names, emb = load_text_embeddings(embeddings)
            if [str(n) for n in names] != ref_names:
                raise ValueError(f"precomputed embeddings are for {ref_names}, not {list(names)}")
        elif embeddings is not None:
            emb = np.asarray(embeddings, np.float32)
        else:
            try:
                emb = clip_text_embeddings(names)
                if emb.shape[-1] != embed_dim:  # trim or pad to the head's width
                    emb = emb[:, :embed_dim] if emb.shape[-1] > embed_dim else np.pad(
                        emb, ((0, 0), (0, embed_dim - emb.shape[-1])))
                    emb /= np.linalg.norm(emb, axis=-1, keepdims=True) + 1e-9
            except Exception:  # CLIP is best effort, as in the JAX package
                LOGGER.warning("set_classes: CLIP weights unavailable — using the deterministic "
                               "offline hash encoder (no semantic transfer). Pass "
                               "embeddings=<arr|.npz> for true open-vocabulary use.")
                emb = offline_text_embeddings(names, embed_dim)
        emb = np.asarray(emb, np.float32)
        if emb.shape != (len(names), embed_dim):
            raise ValueError(f"embeddings must be ({len(names)}, {embed_dim}), got {emb.shape}")
        rows = torch.nn.Parameter(torch.from_numpy(emb).to(txt.device))
        self.model.text_embeddings = rows
        if self.fused:
            self._unfused["text_embeddings"] = rows.detach().clone()
        self.meta = {**self.meta, "nc": len(names),
                     "names": dict(enumerate(str(n) for n in names))}
        self._drop_caches()  # the vocabulary changed
        return self
