"""Image preprocessing on the host, in NumPy.

Reference behaviour (minigpt4.cpp:2576-2651): decode -> RGB -> PIL-convention
bicubic resize to 224x224 (the reference vendors pillow-resize because
cv::resize's bicubic does not match PIL, minigpt4.cpp:2619-2623) -> /255 ->
CLIP mean/std normalize -> CHW f32.

PIL's resampling is a separable convolution with per-output-pixel windows:

    center  = (x_out + 0.5) * scale
    support = 2 * max(scale, 1)            (bicubic support = 2)
    taps    = bicubic((x + 0.5 - center) / max(scale, 1)),  normalized

which is two dense products ``rows @ img @ cols.T`` with weight matrices
built per input size (cached).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGE_SIZE = 224


def _bicubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic kernel (PIL's bicubic, a = -0.5)."""
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    w = np.where(
        ax <= 1,
        (a + 2) * ax3 - (a + 3) * ax2 + 1,
        np.where(ax < 2, a * ax3 - 5 * a * ax2 + 8 * a * ax - 4 * a, 0.0),
    )
    return w.astype(np.float64)


@lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] PIL-convention bicubic resampling matrix
    (antialiased when downscaling)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        xs = np.arange(xmin, xmax)
        k = _bicubic((xs + 0.5 - center) / filterscale)
        s = k.sum()
        if s != 0:
            k = k / s
        w[i, xmin:xmax] = k
    return w.astype(np.float32)


def resize_bicubic(img: np.ndarray, out_h: int = IMAGE_SIZE, out_w: int = IMAGE_SIZE) -> np.ndarray:
    """img [H, W, C] float -> [out_h, out_w, C], PIL-convention bicubic."""
    rows = resize_weights(img.shape[0], out_h)  # [oh, H]
    cols = resize_weights(img.shape[1], out_w)  # [ow, W]
    out = np.einsum("oh,hwc,pw->opc", rows, img.astype(np.float32), cols, optimize=True)
    return out.astype(np.float32)


def preprocess(img: np.ndarray, size: int = IMAGE_SIZE) -> np.ndarray:
    """uint8/float [H, W, 3] RGB -> f32 [3, size, size] normalized CHW
    (the C ABI's preprocessed-image contract, minigpt4.cpp:2624-2637)."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        from .utils import MiniGPT4Error, MiniGPT4TypedError

        raise MiniGPT4TypedError(
            MiniGPT4Error.IMAGE_CHANNELS_EXPECTED_RGB,
            f"expected [H, W, 3] RGB, got {img.shape}",
        )
    x = img.astype(np.float32)
    if img.dtype == np.uint8:
        x = x / 255.0
    x = resize_bicubic(x, size, size)
    x = (x - CLIP_MEAN) / CLIP_STD
    return np.ascontiguousarray(x.transpose(2, 0, 1))


def load_image(path: str) -> np.ndarray:
    """Decode an image file to uint8 RGB [H, W, 3] with PIL (the reference
    decodes with stb/OpenCV)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
