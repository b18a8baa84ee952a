"""`mx.image` of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/image.py`): host-side image ops and the Python
``ImageIter``.  Decode and augment stay on the host, over uint8 numpy
arrays (HWC), with PIL's codec and resize; randomness draws from
numpy's global stream, as in the JAX package, so a seeded run picks the
same crops and flips.
"""
from __future__ import annotations

import numpy as onp

from .base import MXNetError

__all__ = ["imdecode", "imresize", "resize_short", "center_crop", "random_crop",
           "fixed_crop", "color_normalize", "HorizontalFlipAug", "CenterCropAug",
           "RandomCropAug", "CreateAugmenter", "ImageIter"]


def _pil():
    try:
        from PIL import Image

        return Image
    except ImportError as e:
        raise MXNetError("mx.image requires PIL in this build") from e


def _np(x) -> onp.ndarray:
    """A numpy view of ``x`` (numpy, a CPU tensor, or anything array-like)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def imdecode(buf, to_rgb=1, flag=1) -> onp.ndarray:
    import io as _io

    im = _pil().open(_io.BytesIO(bytes(buf)))
    if flag == 0:
        im = im.convert("L")
    elif to_rgb:
        im = im.convert("RGB")
    return onp.asarray(im)


def imresize(src, w, h, interp=1) -> onp.ndarray:
    im = _pil().fromarray(_np(src).astype("uint8"))
    return onp.asarray(im.resize((w, h)))


def resize_short(src, size, interp=1):
    h, w = _np(src).shape[:2]
    if h > w:
        new_w, new_h = size, size * h // w
    else:
        new_w, new_h = size * w // h, size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    out = _np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=1):
    h, w = _np(src).shape[:2]
    new_w, new_h = size
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=1):
    h, w = _np(src).shape[:2]
    new_w, new_h = size
    x0 = onp.random.randint(0, w - new_w + 1)
    y0 = onp.random.randint(0, h - new_h + 1)
    return fixed_crop(src, x0, y0, new_w, new_h), (x0, y0, new_w, new_h)


def _f32(x):
    """Python numbers and lists as float32 arrays (the JAX package's
    default float), arrays as they are."""
    return x if isinstance(x, onp.ndarray) else \
        onp.asarray(_np(x), dtype=onp.float32)


def color_normalize(src, mean, std=None):
    src = _np(src) - _f32(mean)
    if std is not None:
        src = src / _f32(std)
    return src


class Augmenter:
    def __call__(self, src):
        raise NotImplementedError


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src):
        if onp.random.rand() < self.p:
            return onp.flip(_np(src), axis=1)
        return src


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size)[0]


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_mirror=False,
                    mean=None, std=None, **kwargs):
    augs = []
    if rand_crop:
        augs.append(RandomCropAug((data_shape[2], data_shape[1])))
    else:
        augs.append(CenterCropAug((data_shape[2], data_shape[1])))
    if rand_mirror:
        augs.append(HorizontalFlipAug(0.5))
    return augs


class ImageIter:
    """Python-augmentation image iterator over .rec or file list
    (ref: mx.image.ImageIter); batches as `io.ImageRecordIter` emits
    them (``device`` and the other keywords go to it)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None, path_imgidx=None,
                 shuffle=False, aug_list=None, **kwargs):
        from .io import ImageRecordIter

        self._inner = ImageRecordIter(path_imgrec, data_shape, batch_size,
                                      path_imgidx=path_imgidx, shuffle=shuffle, **kwargs)
        self.aug_list = aug_list or []

    def __iter__(self):
        return self

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    __next__ = next
