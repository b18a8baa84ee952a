"""DCGAN's generator and discriminator in the PyTorch/CUDA port (a
port-only module): the 32x32 networks that `examples/gluon/dc_gan.py`
builds (``build_nets``), with each layer given its input width.  The
generator maps z (N, latent, 1, 1) through four transposed convolutions
(BatchNorm and ReLU between, tanh after) to (N, 3, 32, 32); the
discriminator maps an image through four convolutions (LeakyReLU 0.2,
BatchNorm on the middle two) to one logit (N, 1).  Parameter names are
the JAX example's (``0.weight``, ``1.gamma``, ``1.running_mean``,
...).  The upstream example's widths are ngf = ndf = 64, latent 100."""
from __future__ import annotations

from ..context import resolve_device
from ..gluon import nn

__all__ = ["dcgan_nets"]


def dcgan_nets(ngf=64, ndf=64, latent=100, channels=3, *, device=None):
    """(netG, netD), made on ``device`` (default the card)."""
    dev = resolve_device(device)
    netG = nn.HybridSequential()
    netG.add(
        nn.Conv2DTranspose(ngf * 4, 4, strides=1, padding=0, use_bias=False,
                           in_channels=latent, device=dev),
        nn.BatchNorm(in_channels=ngf * 4, device=dev),
        nn.Activation("relu"),                                  # 4x4
        nn.Conv2DTranspose(ngf * 2, 4, strides=2, padding=1, use_bias=False,
                           in_channels=ngf * 4, device=dev),
        nn.BatchNorm(in_channels=ngf * 2, device=dev),
        nn.Activation("relu"),                                  # 8x8
        nn.Conv2DTranspose(ngf, 4, strides=2, padding=1, use_bias=False,
                           in_channels=ngf * 2, device=dev),
        nn.BatchNorm(in_channels=ngf, device=dev),
        nn.Activation("relu"),                                  # 16x16
        nn.Conv2DTranspose(channels, 4, strides=2, padding=1,
                           use_bias=False, in_channels=ngf, device=dev),
        nn.Activation("tanh"))                                  # 32x32
    netD = nn.HybridSequential()
    netD.add(
        nn.Conv2D(ndf, 4, strides=2, padding=1, use_bias=False,
                  in_channels=channels, device=dev),
        nn.LeakyReLU(0.2),                                      # 16x16
        nn.Conv2D(ndf * 2, 4, strides=2, padding=1, use_bias=False,
                  in_channels=ndf, device=dev),
        nn.BatchNorm(in_channels=ndf * 2, device=dev),
        nn.LeakyReLU(0.2),                                      # 8x8
        nn.Conv2D(ndf * 4, 4, strides=2, padding=1, use_bias=False,
                  in_channels=ndf * 2, device=dev),
        nn.BatchNorm(in_channels=ndf * 4, device=dev),
        nn.LeakyReLU(0.2),                                      # 4x4
        nn.Conv2D(1, 4, strides=1, padding=0, use_bias=False,
                  in_channels=ndf * 4, device=dev),
        nn.Flatten())
    return netG, netD
