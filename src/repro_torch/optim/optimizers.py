"""Optimizers as pure (init, update) pairs over tensor trees.

The counterpart of ``repro.optim.optimizers``: the same state layout
(SGD ``{"mu", "step"}``, AdamW ``{"m", "v", "step"}``, ``step`` an int32
scalar) and the same float32 update math, so optimizer state rides in a
migration checkpoint exactly as the reference's does. Updates return new
tensors and never modify their inputs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

Params = Any
OptState = Any


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Params], OptState]
    update: Callable[..., Tuple[Params, OptState]]  # (grads, state, params, lr)
    #: (factory name, kwargs) — lets an optimizer cross a process boundary
    #: (the init/update closures themselves cannot pickle)
    conf: Optional[Tuple[str, dict]] = None

    def __reduce__(self):
        if self.conf is None:
            raise TypeError(
                f"optimizer {self.name!r} has no conf and cannot be "
                "pickled; construct it via a registered factory "
                "(sgd/adamw) or pass conf=(factory_name, kwargs)")
        return (_rebuild_optimizer, (self.conf,))


def _rebuild_optimizer(conf: Tuple[str, dict]) -> "Optimizer":
    name, kwargs = conf
    try:
        factory = _FACTORIES[name]
    except KeyError:
        raise ValueError(f"unknown optimizer factory {name!r}") from None
    return factory(**kwargs)


def _zeros(p: torch.Tensor, dtype_name: Optional[str]) -> torch.Tensor:
    dt = getattr(torch, dtype_name) if dtype_name else p.dtype
    return torch.zeros(p.shape, dtype=dt, device=p.device)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def _map_leaves(fn, params, *trees):
    """Apply ``fn`` (returning a tuple) leafwise; returns one tree per
    tuple slot, each shaped like ``params``."""
    cols = zip(*(fn(*args) for args in zip(*(tree_leaves(t) for t in
                                                 (*trees, params)))))
    return [tree_unflatten_like(params, list(c)) for c in cols]


def sgd(momentum: float = 0.9, momentum_dtype: Optional[str] = None,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: _zeros(p, momentum_dtype), params),
                "step": _step0(params)}

    def update(grads, state, params, lr):
        def upd(g, mu, p):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            mu_new = momentum * mu.float() + g
            p_new = p.float() - lr * mu_new
            return p_new.to(p.dtype), mu_new.to(mu.dtype)
        new_p, new_mu = _map_leaves(upd, params, grads, state["mu"])
        return new_p, {"mu": new_mu, "step": state["step"] + 1}

    return Optimizer("sgd", init, update,
                     conf=("sgd", {"momentum": momentum,
                                   "momentum_dtype": momentum_dtype,
                                   "weight_decay": weight_decay}))


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1,
          moment_dtype: Optional[str] = "float32") -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: _zeros(p, moment_dtype), params),
                "v": tree_map(lambda p: _zeros(p, moment_dtype), params),
                "step": _step0(params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(g, m, v, p):
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * torch.square(g)
            upd_ = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            p_new = p.float() - lr * (upd_ + weight_decay * p.float())
            return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

        new_p, new_m, new_v = _map_leaves(upd, params, grads, state["m"],
                                          state["v"])
        return new_p, {"m": new_m, "v": new_v, "step": step}

    return Optimizer("adamw", init, update,
                     conf=("adamw", {"b1": b1, "b2": b2, "eps": eps,
                                     "weight_decay": weight_decay,
                                     "moment_dtype": moment_dtype}))


_FACTORIES: Dict[str, Callable[..., Optimizer]] = {"sgd": sgd,
                                                   "adamw": adamw}
