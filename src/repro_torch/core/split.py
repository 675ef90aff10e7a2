"""Split-point partitioning and the split training step (VGG-5).

SplitFed/FedFly semantics (paper §II, §IV): the *device stage* holds the
first ``sp`` layers, the *edge-server stage* the rest plus the loss. A
training step is

  device forward  -> smashed data (split-layer activations)
  server forward  -> loss
  server backward -> grads of server params + grad of smashed data
  device backward -> grads of device params

``split_value_and_grad`` runs it as two autograd passes across a
detached smashed tensor, which is the chain rule of the monolithic step
cut at the split: for any sp it gives the monolithic loss and grads.
The counterpart of ``repro.core.split``'s VGG branch; the LLM branches
are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.vgg import VGG5, cross_entropy
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Params = List[Dict[str, Any]]


def _check(model) -> None:
    if not isinstance(model, VGG5):
        raise NotImplementedError(
            f"{type(model).__name__}: only VGG-5 is ported")


def partition_params(model, params, sp: int) -> Tuple[Params, Params]:
    """Split full-model params into (device_stage, server_stage)."""
    _check(model)
    return list(params[:sp]), list(params[sp:])


def merge_params(model, dev: Params, srv: Params) -> Params:
    """Inverse of partition_params."""
    _check(model)
    return list(dev) + list(srv)


def merge_grads(model, g_dev: Params, g_srv: Params) -> Params:
    _check(model)
    return list(g_dev) + list(g_srv)


def device_forward(model, dev: Params, batch, sp: int) -> Dict[str, Any]:
    """Device stage: layers[:sp]. Returns the smashed-data tree sent over
    the network (paper: "smashed data")."""
    _check(model)
    return {"h": model.apply_range(dev, batch["images"], 0, sp)}


def server_loss(model, srv: Params, smashed, batch, sp: int
                ) -> torch.Tensor:
    """Server stage: layers[sp:] + loss."""
    _check(model)
    x = smashed["h"]
    for i, p in enumerate(srv):
        x = model.apply_layer(sp + i, p, x)
    return cross_entropy(x, batch["labels"])


def _requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def split_value_and_grad(model, dev: Params, srv: Params, batch, sp: int
                         ) -> Tuple[torch.Tensor, Params, Params]:
    """Loss + per-stage grads via two autograd passes across the smashed
    data — the computation FedFly distributes across device and edge
    server. Returns (loss, g_dev, g_srv); the loss is detached."""
    dev_p = _requiring_grad(dev)
    srv_p = _requiring_grad(srv)
    h = device_forward(model, dev_p, batch, sp)["h"]
    # the network boundary: the server sees a leaf copy of the smashed
    # data and sends back only its gradient
    h_srv = h.detach().requires_grad_(True)
    loss = server_loss(model, srv_p, {"h": h_srv}, batch, sp)
    srv_leaves = tree_leaves(srv_p)
    grads = torch.autograd.grad(loss, srv_leaves + [h_srv])
    g_srv = tree_unflatten_like(srv_p, list(grads[:-1]))
    dev_leaves = tree_leaves(dev_p)
    g_dev = tree_unflatten_like(
        dev_p, list(torch.autograd.grad(h, dev_leaves,
                                        grad_outputs=grads[-1])))
    return loss.detach(), g_dev, g_srv


def monolithic_value_and_grad(model, params: Params, batch
                              ) -> Tuple[torch.Tensor, Params]:
    """Reference: ordinary end-to-end grad of the unsplit model."""
    p = _requiring_grad(params)
    loss = model.loss(p, batch)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return loss.detach(), tree_unflatten_like(p, list(grads))
