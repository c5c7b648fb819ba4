"""Image/mask transforms (PIL-based host-side augmentation).

The port's own copy of ``tramba_tpu/data/transforms.py``.  The static
resize is PIL's.  The JAX package's goes through its C++ library instead,
whose port (``data/native.py``) gives the same bytes; on the card's host
that route is the slower one (ROADMAP Queue 3, kept difference #26).

Reference semantics: ``data/custom_transforms.py`` + ``data/dataloader.py:22-39``.
Train: static_resize -> random_scale_crop [0.75,1.25] -> random_flip(lr) ->
random_rotate +-10deg -> random_image_enhance (contrast/sharpness/brightness
x[1,1.1]) -> normalize (ImageNet mean/std after /255).  Eval: resize +
normalize only (the part that matters for metric parity — PIL bilinear for
images, nearest for masks, BASELINE.md protocol).

All randomness flows through an explicit ``np.random.Generator`` so the
pipeline is reproducible from a single seed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

__all__ = [
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "static_resize",
    "random_scale_crop",
    "random_flip",
    "random_rotate",
    "random_image_enhance",
    "finalize",
    "train_transform",
    "eval_transform",
]


def static_resize(sample: Dict, size: int) -> Dict:
    sample["image"] = sample["image"].resize((size, size), Image.BILINEAR)
    if "gt" in sample:
        sample["gt"] = sample["gt"].resize((size, size), Image.NEAREST)
    return sample


def _center_crop(im: Image.Image, out_w: int, out_h: int) -> Image.Image:
    """Centered crop to (out_w, out_h); zero-pads first if the image is smaller.

    Note floor((W - out_w)/2) + out_w == floor((W + out_w)/2), so offset + size
    reproduces the usual symmetric-crop box exactly for odd differences too.
    """
    x0 = (im.size[0] - out_w) // 2
    y0 = (im.size[1] - out_h) // 2
    pad = max(0, -min(x0, y0))
    if pad:
        im = ImageOps.expand(im, border=pad)
    return im.crop((x0 + pad, y0 + pad, x0 + pad + out_w, y0 + pad + out_h))


def random_scale_crop(sample: Dict, rng: np.random.Generator, lo=0.75, hi=1.25) -> Dict:
    """Random zoom in/out, then center-crop back to the original size."""
    scale = rng.random() * (hi - lo) + lo
    if rng.random() < 0.5:
        for key in ("image", "gt"):
            if key not in sample:
                continue
            im = sample[key]
            w0, h0 = im.size
            zoomed = im.resize((int(round(w0 * scale)), int(round(h0 * scale))))
            sample[key] = _center_crop(zoomed, w0, h0)
    return sample


def random_flip(sample: Dict, rng: np.random.Generator, lr=True, ud=False) -> Dict:
    do_lr = rng.random() < 0.5 and lr
    do_ud = rng.random() < 0.5 and ud
    for key in ("image", "gt"):
        if key not in sample:
            continue
        a = np.array(sample[key])
        if do_lr:
            a = np.fliplr(a)
        if do_ud:
            a = np.flipud(a)
        sample[key] = Image.fromarray(a)
    return sample


def random_rotate(sample: Dict, rng: np.random.Generator, lo=-10, hi=10) -> Dict:
    """Small random rotation (expand), center-cropped back to original size."""
    deg = int(rng.integers(lo, hi)) % 360
    if rng.random() < 0.5:
        for key in ("image", "gt"):
            if key not in sample:
                continue
            im = sample[key]
            w0, h0 = im.size
            sample[key] = _center_crop(im.rotate(deg, expand=True), w0, h0)
    return sample


def random_image_enhance(sample: Dict, rng: np.random.Generator) -> Dict:
    methods = [ImageEnhance.Contrast, ImageEnhance.Brightness, ImageEnhance.Sharpness]
    rng.shuffle(methods)
    for method in methods:
        if rng.random() > 0.5:
            factor = float(1 + rng.random() / 10)
            sample["image"] = method(sample["image"]).enhance(factor)
    return sample


def finalize(sample: Dict) -> Dict:
    """PIL -> normalized NHWC float32 arrays (image (H,W,3), gt (H,W,1))."""
    img = np.asarray(sample["image"], np.float32) / 255.0
    img = (img - IMAGENET_MEAN) / IMAGENET_STD
    sample["image"] = img
    if "gt" in sample:
        gt = np.asarray(sample["gt"], np.float32) / 255.0
        sample["gt"] = gt[..., None]
    return sample


def train_transform(sample: Dict, img_size: int, rng: np.random.Generator) -> Dict:
    sample = static_resize(sample, img_size)
    sample = random_scale_crop(sample, rng)
    sample = random_flip(sample, rng)
    sample = random_rotate(sample, rng)
    sample = random_image_enhance(sample, rng)
    return finalize(sample)


def eval_transform(sample: Dict, img_size: int) -> Dict:
    return finalize(static_resize(sample, img_size))
