"""The model's weights, made on the device from the seed in a few large
draws: each 1x1 conv U(-1/sqrt(c_in), 1/sqrt(c_in)) (torch's default conv
init), and BatchNorm with non-trivial statistics: gamma U(0.5, 1.5) with a
random sign, beta N(0, 0.2), running mean N(0, 0.3), running variance
U(0.5, 2). Names are ``convN.w`` (c_in, c_out) and ``bnN.{gamma, beta,
mean, var}``."""

from __future__ import annotations

import math

import torch

from harness.core import generator


def plan(num_features: int, emb_dims: int, num_classes: int) -> dict[str, tuple[int, int]]:
    """DGCNN segmentation's convs, (c_in, c_out), in order."""
    f, emb = num_features, emb_dims
    return {"conv1": (2 * f, 64), "conv2": (64, 64), "conv3": (128, 64), "conv4": (64, 64),
            "conv5": (128, 64), "conv6": (192, emb), "conv7": (emb + 192, 512),
            "conv8": (512, 256), "conv9": (256, num_classes)}


def make_weights(model_cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    convs = plan(model_cfg["num_features"], model_cfg["emb_dims"], model_cfg["num_classes"])
    gen = generator(seed, device)
    sizes = [ci * co for ci, co in convs.values()]
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, (ci, co)), part in zip(convs.items(), torch.split(u, sizes)):
        bound = 1.0 / math.sqrt(ci)
        out[f"{name}.w"] = (part * (2 * bound) - bound).reshape(ci, co)
    bns = {name.replace("conv", "bn"): co for name, (_, co) in convs.items() if name != "conv9"}
    widths = list(bns.values())
    total = sum(widths)
    mag = torch.rand(total, generator=gen, device=device) + 0.5
    sign = torch.where(torch.rand(total, generator=gen, device=device) < 0.5, -1.0, 1.0)
    beta = torch.randn(total, generator=gen, device=device) * 0.2
    mean = torch.randn(total, generator=gen, device=device) * 0.3
    var = torch.rand(total, generator=gen, device=device) * 1.5 + 0.5
    for leaf, values in (("gamma", mag * sign), ("beta", beta), ("mean", mean), ("var", var)):
        for name, part in zip(bns, torch.split(values, widths)):
            out[f"{name}.{leaf}"] = part.contiguous()
    return out
