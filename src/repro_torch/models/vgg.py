"""VGG-5 — the model FedFly evaluates (VGG-5 on CIFAR-10, §V.A).

Three conv+pool units and two FC layers, as ``repro.models.vgg``. The
FedFly split points SP1/SP2/SP3 keep the first k layers on the device.

Layouts. Input is NHWC, as the batcher yields it; the first layer
permutes it once to NCHW *shape*, which is channels-last *memory* — the
layout cuDNN prefers — so every activation after it stays channels-last.
Parameters are in torch layout (conv OIHW, Linear ``(out, in)``). Before
``fc1`` the activation is flattened in ``(h, w, c)`` order, the
reference's order, so a reference parameter tree carries across with
transposes alone (``params_from_reference``/``params_to_reference``).

Training works on explicit parameter trees (a list of ``{"w", "b"}``
dicts, one per layer), so a stage is a slice of that list and of
``VGG5.layers``; the module's own parameters are the default tree.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map

Params = Dict[str, Any]

# (type, spec) per layer. conv spec: (in_ch, out_ch, pool); fc: (in, out)
VGG5_LAYERS: Tuple = (
    ("conv", (3, 32, True)),
    ("conv", (32, 64, True)),
    ("conv", (64, 64, True)),
    ("fc", (64 * 4 * 4, 128)),
    ("fc", (128, 10)),
)

# paper split points: number of leading layers on the device stage
SPLIT_POINTS = {"SP1": 1, "SP2": 2, "SP3": 3}


class VGG5(nn.Module):
    """CIFAR-10 VGG-5. Input (B, 32, 32, 3) NHWC float32."""

    def __init__(self, num_classes: int = 10, image_size: int = 32, *,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.image_size = image_size
        self.layer_specs: Sequence = VGG5_LAYERS
        self.num_layers = len(VGG5_LAYERS)
        self.default_split = SPLIT_POINTS["SP2"]
        layers: List[nn.Module] = []
        for kind, spec in self.layer_specs:
            if kind == "conv":
                layers.append(nn.Conv2d(spec[0], spec[1], 3, padding=1,
                                        device=dev))
            else:
                layers.append(nn.Linear(spec[0], spec[1], device=dev))
        self.layers = nn.ModuleList(layers)
        self.load_params(self.init(generator))

    @property
    def device(self) -> torch.device:
        return self.layers[0].weight.device

    def init(self, generator: Optional[torch.Generator] = None
             ) -> List[Params]:
        """A fresh parameter tree: He-normal weights, zero biases (the
        reference's scheme; the draws differ, since torch and JAX
        generators differ). Drawn on the CPU from ``generator`` and
        moved to the model's device, so a seed gives the same weights on
        every device."""
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
        params: List[Params] = []
        for layer in self.layers:
            w_shape = tuple(layer.weight.shape)
            fan_in = math.prod(w_shape[1:])
            w = torch.randn(w_shape, generator=g) * math.sqrt(2.0 / fan_in)
            params.append({"w": w.to(self.device),
                           "b": torch.zeros(w_shape[0], device=self.device)})
        return params

    def param_tree(self) -> List[Params]:
        return [{"w": m.weight.detach(), "b": m.bias.detach()}
                for m in self.layers]

    @torch.no_grad()
    def load_params(self, params: Sequence[Params]) -> None:
        for m, p in zip(self.layers, params):
            m.weight.copy_(p["w"])
            m.bias.copy_(p["b"])

    def stage(self, lo: int, hi: int) -> nn.ModuleList:
        """Layers ``[lo, hi)`` — the device stage is ``stage(0, sp)``,
        the edge-server stage ``stage(sp, num_layers)``."""
        return self.layers[lo:hi]

    def apply_layer(self, idx: int, p: Params, x: torch.Tensor
                    ) -> torch.Tensor:
        kind, spec = self.layer_specs[idx]
        if kind == "conv":
            if idx == 0:
                x = x.permute(0, 3, 1, 2)     # NHWC -> NCHW channels-last
            x = F.relu(F.conv2d(x, p["w"], p["b"], padding=1))
            if spec[2]:
                x = F.max_pool2d(x, 2)
            return x
        if x.ndim > 2:
            # flatten in (h, w, c) order, as the reference does
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.linear(x, p["w"], p["b"])
        if idx < self.num_layers - 1:
            x = F.relu(x)
        return x

    def apply_range(self, params: Sequence[Params], x: torch.Tensor,
                    lo: int, hi: int) -> torch.Tensor:
        for i in range(lo, hi):
            x = self.apply_layer(i, params[i], x)
        return x

    def forward(self, x: torch.Tensor,
                params: Optional[Sequence[Params]] = None) -> torch.Tensor:
        params = self.param_tree() if params is None else params
        return self.apply_range(params, x, 0, self.num_layers)

    def loss(self, params: Sequence[Params], batch: Params) -> torch.Tensor:
        return cross_entropy(self.forward(batch["images"], params),
                             batch["labels"])

    def accuracy(self, params: Sequence[Params], batch: Params
                 ) -> torch.Tensor:
        logits = self.forward(batch["images"], params)
        return (logits.argmax(-1) == batch["labels"]).float().mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels``.

    Written as ``log_softmax`` times a one-hot mask instead of a gather:
    the backward of a gather is a scatter-add, which deterministic mode
    refuses on CUDA (``torch.use_deterministic_algorithms``), while this
    form's backward is elementwise. The product is exact (a factor of 1
    or 0) and the row sum adds one nonzero term, so the value equals the
    gathered log-probability."""
    lp = F.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(lp.dtype)
    return -(lp * onehot).sum(-1).mean()


# -- parameter layout carry between the JAX package and the port -----------

def params_from_reference(tree: Any, device="cuda") -> Any:
    """Reference layout (conv ``w`` HWIO, fc ``w`` ``(in, out)``; numpy
    arrays or tensors) -> torch layout on ``device``. Works on any tree
    whose 4-D leaves are conv kernels and 2-D leaves fc weights — a
    parameter list, a stage of one, or SGD state (``mu`` mirrors the
    params; ``step`` is 0-d)."""
    dev = resolve_device(device)

    def conv(x):
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.array(x, copy=True))
        t = t.to(dev)
        if t.ndim == 4:
            return t.permute(3, 2, 0, 1).contiguous()
        if t.ndim == 2:
            return t.t().contiguous()
        return t
    return tree_map(conv, tree)


def params_to_reference(tree: Any) -> Any:
    """Torch layout -> reference layout, on the tensors' own device (the
    inverse of ``params_from_reference``)."""
    def conv(t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.ndim == 4:
            return t.permute(2, 3, 1, 0).contiguous()
        if t.ndim == 2:
            return t.t().contiguous()
        return t
    return tree_map(conv, tree)
