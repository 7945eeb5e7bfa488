"""Image IO and augmentation on the host, in numpy
(paddle_tpu/data/image.py; the reference's python/paddle/v2/image.py:111-290).

`load_image` and `load_image_bytes` decode through PIL, imported inside
them: nothing else here needs it. Images are HWC uint8 or float arrays
throughout; `to_chw` converts at the end for NCHW feeds.
`simple_transform` takes its draws from the caller's RandomState in the
JAX package's order (the crop's row, its column, then the mirror's coin),
so the same seed gives the same crops and flips.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "load_image", "load_image_bytes", "resize_short", "to_chw",
    "center_crop", "random_crop", "left_right_flip", "simple_transform",
    "load_and_transform", "batch_images_from_tar", "batch_reader",
]


def load_image_bytes(data: bytes, is_color: bool = True) -> np.ndarray:
    """Decode an encoded image from bytes → HWC (or HW) uint8."""
    import io

    from PIL import Image

    im = Image.open(io.BytesIO(data))
    im = im.convert("RGB" if is_color else "L")
    return np.asarray(im)


def load_image(file, is_color: bool = True) -> np.ndarray:
    """Load an image file → HWC (or HW for grayscale) uint8 array."""
    from PIL import Image

    im = Image.open(file)
    im = im.convert("RGB" if is_color else "L")
    return np.asarray(im)


def resize_short(im: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER edge equals `size` (aspect preserved).

    Bilinear, pure numpy (reference: cv2.resize at image.py:163-189)."""
    h, w = im.shape[:2]
    if h < w:
        new_h, new_w = size, int(round(w * size / h))
    else:
        new_h, new_w = int(round(h * size / w)), size
    return _bilinear_resize(im, new_h, new_w)


def _bilinear_resize(im: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    h, w = im.shape[:2]
    if (h, w) == (new_h, new_w):
        return im
    dtype = im.dtype
    ys = (np.arange(new_h) + 0.5) * h / new_h - 0.5
    xs = (np.arange(new_w) + 0.5) * w / new_w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if im.ndim == 3:
        wy = wy[..., None]
        wx = wx[..., None]
    imf = im.astype(np.float32)
    top = imf[y0][:, x0] * (1 - wx) + imf[y0][:, x1] * wx
    bot = imf[y1][:, x0] * (1 - wx) + imf[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(dtype, np.integer):
        out = np.clip(np.round(out), np.iinfo(dtype).min, np.iinfo(dtype).max)
    return out.astype(dtype)


def to_chw(im: np.ndarray, order=(2, 0, 1)) -> np.ndarray:
    """HWC → CHW (reference image.py:190)."""
    return im.transpose(order)


def center_crop(im: np.ndarray, size: int, is_color: bool = True) -> np.ndarray:
    h, w = im.shape[:2]
    h_start = (h - size) // 2
    w_start = (w - size) // 2
    return im[h_start : h_start + size, w_start : w_start + size]


def random_crop(im: np.ndarray, size: int, is_color: bool = True,
                rng: np.random.RandomState = None) -> np.ndarray:
    rng = rng or np.random
    h, w = im.shape[:2]
    h_start = rng.randint(0, h - size + 1)
    w_start = rng.randint(0, w - size + 1)
    return im[h_start : h_start + size, w_start : w_start + size]


def left_right_flip(im: np.ndarray) -> np.ndarray:
    """Horizontal mirror (reference image.py:270)."""
    return im[:, ::-1]


def simple_transform(
    im: np.ndarray,
    resize_size: int,
    crop_size: int,
    is_train: bool,
    is_color: bool = True,
    mean=None,
    rng: np.random.RandomState = None,
) -> np.ndarray:
    """The reference's standard pipeline (image.py:290-343): resize short
    edge → (train: random crop + coin-flip mirror | test: center crop) →
    CHW float32 → optional mean subtraction (scalar-per-channel or full
    image)."""
    rng = rng or np.random
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, rng=rng)
        if rng.randint(2) == 0:
            im = left_right_flip(im)
    else:
        im = center_crop(im, crop_size)
    if im.ndim == 2:
        im = im[:, :, None]
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:
            mean = mean[:, None, None]
        im -= mean
    return im


def load_and_transform(
    filename, resize_size, crop_size, is_train, is_color=True, mean=None
) -> np.ndarray:
    return simple_transform(
        load_image(filename, is_color), resize_size, crop_size, is_train,
        is_color, mean,
    )


def batch_images_from_tar(
    data_file: str,
    dataset_name: str,
    img2label: dict,
    num_per_batch: int = 1024,
) -> str:
    """Pre-batch a tar of images into batch files + a meta list.

    Reference: python/paddle/v2/image.py:48-109 (same contract: returns
    the meta file path listing batch files, in tar order; idempotent once
    complete). Batch files are .npz holding the encoded image bytes as
    one flat uint8 buffer + offsets (NOT an object array — object arrays
    make numpy pickle internally and re-open the reference's
    pickle-on-load code-execution hole). The meta file is written LAST:
    its presence marks the batching complete, so an interrupted run
    restarts instead of returning a half-written set. Read back with
    `batch_reader(meta_file)`.
    """
    import tarfile

    batch_dir = data_file + "_batch"
    out_path = os.path.join(batch_dir, dataset_name)
    meta_file = os.path.join(batch_dir, f"{dataset_name}.txt")
    if os.path.exists(meta_file):  # completion marker, not the dir
        return meta_file
    os.makedirs(out_path, exist_ok=True)

    paths: list = []

    def dump(data, labels, file_id):
        buf = np.frombuffer(b"".join(data), dtype=np.uint8)
        offsets = np.cumsum([0] + [len(d) for d in data]).astype(np.int64)
        p = os.path.join(out_path, f"batch_{file_id}.npz")
        np.savez(p, data=buf, offsets=offsets, label=np.asarray(labels))
        paths.append(os.path.abspath(p))

    data, labels, file_id = [], [], 0
    with tarfile.open(data_file) as tf:
        for mem in tf.getmembers():
            if mem.name not in img2label:
                continue
            data.append(tf.extractfile(mem).read())
            labels.append(img2label[mem.name])
            if len(data) == num_per_batch:
                dump(data, labels, file_id)
                file_id += 1
                data, labels = [], []
    if data:
        dump(data, labels, file_id)
    # written in production order (no listdir re-scan: lexicographic
    # order would interleave batch_10 between batch_1 and batch_2) and
    # atomically — a truncated meta would otherwise read as "complete"
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=batch_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as meta:
            meta.write("".join(p + "\n" for p in paths))
        os.replace(tmp, meta_file)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return meta_file


def batch_reader(meta_file: str, is_color: bool = True):
    """Reader over batch files produced by batch_images_from_tar:
    yields (decoded HWC image, label) samples in tar order."""

    def reader():
        with open(meta_file) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        for p in paths:
            with np.load(p) as d:  # no allow_pickle: plain arrays only
                buf, offsets = d["data"], d["offsets"]
                for j, label in enumerate(d["label"]):
                    raw = buf[offsets[j]:offsets[j + 1]].tobytes()
                    yield load_image_bytes(raw, is_color), label

    return reader
