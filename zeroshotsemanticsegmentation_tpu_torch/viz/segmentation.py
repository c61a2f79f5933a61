"""Segmentation visualization tiles (reference vis_utils.py capabilities;
the JAX package's viz/segmentation.py).

Self-contained replacements for the pip ``fcn`` package utilities the
reference leans on (fcn.utils.label2rgb / get_tile_image, vis_utils.py:84-107):

* `label2rgb`: VOC-standard bit-interleaved colormap, optional image overlay
* `visualize_segmentation`: 2-row tile — (img, labels, overlay[, seenmask])
  for truth and prediction (vis_utils.py:34-109)
* `visualize_seenmask`: 1×3 tile (vis_utils.py:4-31)

Deviation: the reference fills unlabeled pixels with *random* RGB noise
(vis_utils.py:20,76); here they get a fixed mid-gray so outputs are
deterministic and testable.
"""

from __future__ import annotations

import numpy as np

UNLABELED_RGB = (96, 96, 96)


def voc_colormap(n: int) -> np.ndarray:
    """(n, 3) uint8 VOC-standard label colormap (bit-interleaving scheme)."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        cid = i
        for j in range(8):
            r |= ((cid >> 0) & 1) << (7 - j)
            g |= ((cid >> 1) & 1) << (7 - j)
            b |= ((cid >> 2) & 1) << (7 - j)
            cid >>= 3
        cmap[i] = (r, g, b)
    return cmap


def label2rgb(lbl: np.ndarray, img: np.ndarray | None = None, *,
              n_labels: int, alpha: float = 0.5) -> np.ndarray:
    """Label map -> RGB; with `img`, alpha-blends over the grayscale image."""
    cmap = voc_colormap(n_labels)
    safe = np.clip(lbl, 0, n_labels - 1)
    out = cmap[safe]
    out[lbl < 0] = UNLABELED_RGB
    if img is not None:
        gray = img.mean(axis=2, keepdims=True).astype(np.float64)
        out = (alpha * out + (1 - alpha) * gray).astype(np.uint8)
    return out


def make_seen_mask(lbl: np.ndarray, unseen, n_class: int) -> np.ndarray:
    """White = seen-class pixel, black = unseen (reference vis_utils.py:111-116)."""
    seen = [x for x in range(n_class) if x not in set(unseen)]
    mask = np.isin(lbl, seen).astype(np.uint8) * 255
    return np.repeat(mask[:, :, None], 3, axis=2)


def get_tile_image(imgs: list[np.ndarray],
                   grid: tuple[int, int] | None = None,
                   pad: int = 2) -> np.ndarray:
    """Tile equally-or-unequally sized RGB images into a grid."""
    n = len(imgs)
    if grid is None:
        cols = int(np.ceil(np.sqrt(n)))
        rows = int(np.ceil(n / cols))
    else:
        rows, cols = grid
    cell_h = max(im.shape[0] for im in imgs)
    cell_w = max(im.shape[1] for im in imgs)
    out = np.zeros((rows * (cell_h + pad) - pad,
                    cols * (cell_w + pad) - pad, 3), np.uint8)
    for idx, im in enumerate(imgs):
        r, c = divmod(idx, cols)
        y, x = r * (cell_h + pad), c * (cell_w + pad)
        out[y:y + im.shape[0], x:x + im.shape[1]] = im
    return out


def visualize_segmentation(*, lbl_pred: np.ndarray, lbl_true: np.ndarray,
                           img: np.ndarray, n_class: int,
                           unseen=None) -> np.ndarray:
    """2-row tile: (img | true labels | overlay [| true seenmask]) over
    (img | pred labels | overlay [| pred seenmask])."""
    lt = lbl_true.copy()
    unl = lt < 0
    rows = []
    for lbl in (lt, lbl_pred):
        shown = lbl.copy()
        shown[unl] = -1  # render unlabeled consistently in both rows
        cells = [img,
                 label2rgb(shown, n_labels=n_class),
                 label2rgb(shown, img, n_labels=n_class)]
        if unseen:
            sm = make_seen_mask(np.where(unl, 0, lbl), unseen, n_class)
            sm[unl] = UNLABELED_RGB
            cells.append(sm)
        rows.append(get_tile_image(cells, (1, len(cells))))
    return get_tile_image(rows, (2, 1))


def visualize_seenmask(*, lbl_pred: np.ndarray, lbl_true: np.ndarray,
                       img: np.ndarray, n_class: int, unseen=None
                       ) -> np.ndarray:
    """1×3 tile: img | binary true mask | binary pred mask (vis_utils.py:4-31)."""
    unl = lbl_true < 0
    cells = [img]
    for lbl in (lbl_true, lbl_pred):
        m = make_seen_mask(np.where(unl, 0, lbl), [0], 2)
        m[unl] = UNLABELED_RGB
        cells.append(m)
    return get_tile_image(cells, (1, 3))


def save_image(path: str, img: np.ndarray) -> None:
    """Write an RGB uint8 image; Pillow is imported here, on first use."""
    import PIL.Image
    PIL.Image.fromarray(img).save(path)
