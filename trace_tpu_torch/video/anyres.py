"""AnyRes image tiling utilities (aux image path; a copy of
trace_tpu/video/anyres.py).

Reference: select_best_resolution / process_anyres_image /
get_anyres_image_grid_shape (mm_utils.py:125-234) over the grid table in
constants (Grids, constants.py:9).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from trace_tpu_torch.constants import GRIDS


def select_best_resolution(
    original_size: Tuple[int, int],
    possible_resolutions: Sequence[Tuple[int, int]],
) -> Tuple[int, int]:
    """Pick the candidate maximizing effective resolution then minimizing
    waste (mm_utils.py:125-147)."""
    ow, oh = original_size
    best_fit = None
    max_eff = 0
    min_waste = float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = (w * h) - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff = eff
            min_waste = waste
            best_fit = (w, h)
    return best_fit


def get_anyres_image_grid_shape(
    image_size: Tuple[int, int], patch_size: int, grids=GRIDS
) -> Tuple[int, int]:
    """(cols, rows) of patches for the chosen resolution (mm_utils.py:197-212)."""
    possible = [(g[0] * patch_size, g[1] * patch_size) for g in grids]
    w, h = select_best_resolution(image_size, possible)
    return w // patch_size, h // patch_size


def divide_to_patches(image: np.ndarray, patch_size: int) -> List[np.ndarray]:
    """Split [H, W, 3] into row-major patch tiles (mm_utils.py:150-166)."""
    patches = []
    H, W = image.shape[:2]
    for i in range(0, H, patch_size):
        for j in range(0, W, patch_size):
            patches.append(image[i : i + patch_size, j : j + patch_size])
    return patches


def resize_and_pad(image: np.ndarray, target: Tuple[int, int]) -> np.ndarray:
    """Aspect-preserving resize onto a zero-padded canvas (mm_utils.py:169-194)."""
    from PIL import Image

    oh, ow = image.shape[:2]
    tw, th = target
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(int(np.ceil(oh * scale_w)), th)
    else:
        nw, nh = min(int(np.ceil(ow * scale_h)), tw), th
    resized = np.asarray(Image.fromarray(image).resize((nw, nh)))
    canvas = np.zeros((th, tw, 3), image.dtype)
    px, py = (tw - nw) // 2, (th - nh) // 2
    canvas[py : py + nh, px : px + nw] = resized
    return canvas


def process_anyres_image(
    image: np.ndarray, tile_size: int, grids=GRIDS
) -> List[np.ndarray]:
    """Tile an image at its best grid resolution + a downscaled global view
    (mm_utils.py:215-234)."""
    from PIL import Image

    possible = [(g[0] * tile_size, g[1] * tile_size) for g in grids]
    best = select_best_resolution((image.shape[1], image.shape[0]), possible)
    padded = resize_and_pad(image, best)
    patches = divide_to_patches(padded, tile_size)
    global_view = np.asarray(Image.fromarray(image).resize((tile_size, tile_size)))
    return [global_view] + patches
