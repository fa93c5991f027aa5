"""Tower adapters of the parameter-efficient baselines: LoRA and Houlsby.

Port of ``iisan_tpu/models/peft.py``.  ``LoRADense`` is a dense layer
(``base``) plus a low-rank delta ``(x A) B / r`` whose ``lora_B`` starts
at zero, so the delta starts at exactly 0 (standard LoRA on a frozen
pretrained base, scale 1/r as loralib's default ``lora_alpha=1``).
``HoulsbyAdapter`` is the serial bottleneck adapter the Houlsby baseline
places inside each tower block.  Which parameters train is decided by
``train/peft_masks.py``; BitFit needs no module (tower biases only).

Parameter names and layouts are the JAX tree's (``query.base.kernel``
(in, out), ``query.lora_A`` (in, r), ``query.lora_B`` (r, out),
``attention_adapter.fc_down.kernel``), so ``utils/jax_params`` carries a
JAX tree across unchanged.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .modules import TorchLinear, uniform_init


def lora_a_init(shape, device=None, generator=None) -> torch.Tensor:
    """loralib's kaiming_uniform(a=sqrt(5)) on its (r, in) matrix; the
    layout here is (in, r), so the bound uses fan_in = in-features."""
    return uniform_init(shape, math.sqrt(6.0 / shape[0]), device, generator)


class LoRADense(nn.Module):
    """``y = base(x) + ((x A) B) * (1/r)``, A and B only when rank > 0.

    The JAX cast chain: ``base`` computes in ``dtype``; the delta's two
    products run in x's dtype, each rounded to it, then the scale, then
    the sum.  With rank 0 the layer is ``base`` alone."""

    def __init__(self, in_features: int, features: int, rank: int = 0,
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        self.rank = rank
        self.base = TorchLinear(in_features, features, dtype=dtype,
                                init="lecun", device=device,
                                generator=generator)
        if rank > 0:
            self.lora_A = nn.Parameter(lora_a_init((in_features, rank), device,
                                                   generator))
            self.lora_B = nn.Parameter(torch.zeros((rank, features),
                                                   device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.base(x)
        if self.rank == 0:
            return y
        delta = (x @ self.lora_A.to(x.dtype)) @ self.lora_B.to(x.dtype)
        return y + delta * (1.0 / self.rank)


class HoulsbyAdapter(nn.Module):
    """``fc_up(act(fc_down(x))) + x``: N(0, 1e-2) weights, zero biases;
    exact GELU for ``activation="GELU"``, ReLU for anything else."""

    def __init__(self, dim: int, down_size: int, activation: str = "RELU",
                 dtype: Optional[torch.dtype] = None, device=None,
                 generator=None):
        super().__init__()
        self.gelu = activation == "GELU"
        self.fc_down = TorchLinear(dim, down_size, dtype=dtype, init="adapter",
                                   device=device, generator=generator)
        self.fc_up = TorchLinear(down_size, dim, dtype=dtype, init="adapter",
                                 device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc_down(x)
        h = F.gelu(h) if self.gelu else torch.relu(h)
        return self.fc_up(h) + x

