# -*- coding: utf-8 -*-
"""ResNet encoder, numerics-compatible with HF ``ResNetModel`` (port of
``drin_tpu/encoders/resnet.py``; ``microsoft/resnet-152``: bottleneck v1,
stem 7x7/2 + maxpool 3x3/2, stages [3, 8, 36, 3] at widths [256, 512,
1024, 2048]).

The preprocessing stage runs it frozen, for image-region features (the
conv map [B, 2048, 7, 7] -> 49 regions) and object-crop pooling
(``pooler_output``).  Convolutions are ``F.conv2d`` over NCHW tensors (a
channels-last view is taken as it comes); BatchNorm is the inference form,
from running statistics, computed as the JAX package computes it:
``x * inv + (bias - mean * inv)`` with ``inv = weight / sqrt(var + eps)``.

Parameters and buffers carry HF ``ResNetModel.state_dict()``'s keys
(``embedder.embedder.convolution.weight``,
``encoder.stages.{s}.layers.{l}.layer.{c}.normalization.running_mean``, ...),
so a checkpoint loads under its own names (``num_batches_tracked`` aside).

Outputs: ``last_hidden_state`` [B, H'*W', C] in the JAX package's region
order, row-major over (h, w) of the NHWC map, and ``pooler_output`` [B, C].
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F


class ResNetConfig:
    def __init__(
        self,
        embedding_size: int = 64,
        hidden_sizes: Sequence[int] = (256, 512, 1024, 2048),
        depths: Sequence[int] = (3, 8, 36, 3),  # resnet-152
        downsample_in_first_stage: bool = False,
        downsample_in_bottleneck: bool = False,
        num_channels: int = 3,
        bn_eps: float = 1e-5,
    ):
        self.embedding_size = embedding_size
        self.hidden_sizes = tuple(hidden_sizes)
        self.depths = tuple(depths)
        self.downsample_in_first_stage = downsample_in_first_stage
        self.downsample_in_bottleneck = downsample_in_bottleneck
        self.num_channels = num_channels
        self.bn_eps = bn_eps


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm over NCHW: the running statistics are
    buffers, the affine pair parameters (the encoders are frozen)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.reciprocal(torch.sqrt(self.running_var + self.eps))
        shift = self.bias - self.running_mean * inv
        return torch.addcmul(shift[:, None, None], x, inv[:, None, None])


class ConvLayer(nn.Module):
    """conv (no bias, padding k//2) + BatchNorm + optional relu (HF
    ``ResNetConvLayer``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 act: bool = True, bn_eps: float = 1e-5):
        super().__init__()
        self.act = act
        self.convolution = nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                                     padding=kernel_size // 2, bias=False)
        self.normalization = BatchNorm(out_ch, bn_eps)

    def forward(self, x):
        x = self.normalization(self.convolution(x))
        return F.relu(x) if self.act else x


class ShortCut(nn.Module):
    """1x1 projection of the residual (HF ``ResNetShortCut``)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, bn_eps: float):
        super().__init__()
        self.convolution = nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False)
        self.normalization = BatchNorm(out_ch, bn_eps)

    def forward(self, x):
        return self.normalization(self.convolution(x))


class BottleneckLayer(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, reduction: int = 4,
                 downsample_in_bottleneck: bool = False, bn_eps: float = 1e-5):
        super().__init__()
        self.shortcut = (ShortCut(in_ch, out_ch, stride, bn_eps)
                         if in_ch != out_ch or stride != 1 else None)
        red = out_ch // reduction
        s_first = stride if downsample_in_bottleneck else 1
        s_mid = stride if not downsample_in_bottleneck else 1
        self.layer = nn.Sequential(
            ConvLayer(in_ch, red, 1, s_first, bn_eps=bn_eps),
            ConvLayer(red, red, 3, s_mid, bn_eps=bn_eps),
            ConvLayer(red, out_ch, 1, 1, act=False, bn_eps=bn_eps))

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        return F.relu(self.layer(x) + residual)


class _Embedder(nn.Module):
    def __init__(self, c: ResNetConfig):
        super().__init__()
        self.embedder = ConvLayer(c.num_channels, c.embedding_size, 7, 2, bn_eps=c.bn_eps)

    def forward(self, x):
        return F.max_pool2d(self.embedder(x), 3, stride=2, padding=1)


class _Stage(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.Sequential(*layers)


class _Encoder(nn.Module):
    def __init__(self, c: ResNetConfig):
        super().__init__()
        stages, in_ch = [], c.embedding_size
        for si, (width, depth) in enumerate(zip(c.hidden_sizes, c.depths)):
            stride = (2 if c.downsample_in_first_stage else 1) if si == 0 else 2
            stages.append(_Stage([
                BottleneckLayer(in_ch if li == 0 else width, width,
                                stride=stride if li == 0 else 1,
                                downsample_in_bottleneck=c.downsample_in_bottleneck,
                                bn_eps=c.bn_eps)
                for li in range(depth)]))
            in_ch = width
        self.stages = nn.ModuleList(stages)


class ResNetModel(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        self.cfg = cfg
        self.embedder = _Embedder(cfg)
        self.encoder = _Encoder(cfg)

    def feature_map(self, pixel_values):
        """pixel_values [B, 3, H, W] normalized -> the last conv map
        [B, C, H', W']."""
        x = self.embedder(pixel_values)
        for stage in self.encoder.stages:
            x = stage.layers(x)
        return x

    def forward(self, pixel_values):
        """Returns (last_hidden_state [B, H'*W', C] row-major over (h, w),
        pooler_output [B, C])."""
        x = self.feature_map(pixel_values)
        pooled = x.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1, 1)
        return x.flatten(2).transpose(1, 2), pooled
