"""Vision transforms of the PyTorch/CUDA port (counterpart of
`incubator_mxnet_tpu/gluon/data/vision/transforms.py`; ref
`python/mxnet/gluon/data/vision/transforms.py`): Compose, ToTensor,
Normalize, crops, flips, Resize, Cast — HWC-in, CHW-out per the
reference convention.  Each is a port `Block` taking a numpy array or a
tensor and returning a tensor; randomness draws from numpy's global
stream, as the JAX package's transforms do.
"""
from __future__ import annotations

import numpy as onp
import torch
import torch.nn.functional as F

from ...block import Block, HybridBlock
from ...nn.basic_layers import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast"]


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(onp.asarray(x))


def _resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear resize of an HWC or NHWC tensor to (h, w), antialiased
    when it shrinks (`jax.image.resize`'s ``"bilinear"``), in float32."""
    x = x.to(torch.float32)
    batched = x.dim() == 4
    nchw = (x if batched else x[None]).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(h, w), mode="bilinear",
                        align_corners=False, antialias=True)
    out = out.permute(0, 2, 3, 1)
    return out if batched else out[0]


class Compose(Sequential):
    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype

    def forward(self, x):
        return _t(x).to(self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8/float [0,255] → CHW float32 [0,1]."""

    def forward(self, x):
        x = _t(x)
        arr = x.to(torch.float32)
        if x.dtype == torch.uint8:
            arr = arr / 255.0
        if arr.dim() == 3:
            arr = arr.permute(2, 0, 1)
        elif arr.dim() == 4:
            arr = arr.permute(0, 3, 1, 2)
        return arr.contiguous()


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = torch.from_numpy(
            onp.asarray(mean, "float32").reshape(-1, 1, 1))
        self._std = torch.from_numpy(
            onp.asarray(std, "float32").reshape(-1, 1, 1))

    def forward(self, x):
        x = _t(x)
        return (x - self._mean.to(x.device)) / self._std.to(x.device)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        return _resize(_t(x), h, w)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        x = _t(x)
        w, h = self._size
        H, W = x.shape[0], x.shape[1]
        y0, x0 = (H - h) // 2, (W - w) // 2
        return x[y0:y0 + h, x0:x0 + w]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3), interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        x = _t(x)
        H, W = x.shape[0], x.shape[1]
        area = H * W
        for _ in range(10):
            target_area = onp.random.uniform(*self._scale) * area
            ar = onp.random.uniform(*self._ratio)
            w = int(round((target_area * ar) ** 0.5))
            h = int(round((target_area / ar) ** 0.5))
            if w <= W and h <= H:
                x0 = onp.random.randint(0, W - w + 1)
                y0 = onp.random.randint(0, H - h + 1)
                return _resize(x[y0:y0 + h, x0:x0 + w], self._size[1],
                               self._size[0])
        # fallback center crop
        return CenterCrop(self._size)(x)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        x = _t(x)
        if onp.random.rand() < 0.5:
            return torch.flip(x, dims=(1,))
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        x = _t(x)
        if onp.random.rand() < 0.5:
            return torch.flip(x, dims=(0,))
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + onp.random.uniform(-self._b, self._b)
        return _t(x) * float(alpha)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        x = _t(x)
        alpha = 1.0 + onp.random.uniform(-self._c, self._c)
        gray = x.to(torch.float32).mean()
        return x * float(alpha) + gray * float(1 - alpha)
