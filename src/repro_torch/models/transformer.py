"""Decoder-only transformer of the dense and RWKV families, for serving:
prefill (with the decode cache it collects) and one-token decode steps.

The torch counterpart of ``repro.models.transformer.TransformerLM``. The
module owns its parameters (``nn.Module``); each layer is a ``ParamTree``
holding the reference's per-layer dict in the reference's layout
(projections ``(d_in, d_out)``), so the layer functions of
``models/layers.py`` and ``models/ssm.py`` apply to it directly. Layers
are a ``ModuleList`` walked in a Python loop where the reference scans a
stacked tree; ``params_from_reference``/``params_to_reference`` convert
between the two, exactly.

Decode caches have the reference's keys, dtypes and layouts, so a decode
session crosses between the packages: ``k``/``v`` (L, B, C, KV, hd),
``pos_tab`` (L, B, C) int32 (-1 = empty); ``rwkv_state`` (L, B, H, 64,
64) float32, ``rwkv_xprev``/``cmix_xprev`` (L, B, d). ``decode_step``
updates the cache in place.

MoE, hybrid (attention + Mamba), VLM and encoder-decoder archs are not
ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers, ssm
from repro_torch.tree import tree_leaves, tree_map

Params = Dict[str, Any]

_ROADMAP = "ROADMAP.md §1, 'Architecture zoo: what is left'"


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Static per-layer sliding-window sizes (0 = full attention)."""
    L, w, period = cfg.num_layers, cfg.sliding_window, cfg.local_global_period
    if w <= 0:
        return np.zeros((L,), np.int32)
    if period <= 0:
        return np.full((L,), w, np.int32)
    out = np.full((L,), w, np.int32)
    out[period - 1::period] = 0
    return out


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.encoder_layers > 0:
        return "encoder-decoder"
    if cfg.is_moe:
        return "MoE"
    if cfg.hybrid_attn_ssm:
        return "hybrid attention + Mamba"
    if cfg.vision_prefix > 0:
        return "VLM"
    if cfg.family not in ("dense", "ssm") or (cfg.family == "ssm"
                                              and not cfg.rwkv):
        return f"family {cfg.family!r}"
    if not cfg.rwkv and cfg.head_dim not in (64, 128):
        return f"head_dim {cfg.head_dim} (the flash kernel takes 64 or 128)"
    return None


class ParamTree(nn.Module):
    """A nested dict of tensors held as (frozen) parameters; ``tree()``
    gives the dict back."""

    def __init__(self, tree: Params):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> Params:
        out: Params = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class TransformerLM(nn.Module):
    """Dense (GQA, optional qk-norm) or RWKV6 decoder-only LM.

    Parameters are drawn on ``device`` from ``generator`` (default: a
    generator seeded with 0) with the reference's initializers; tests
    load the reference's own parameters with ``load_params``.
    ``use_kernel`` is passed to every kernel wrapper on the prefill path
    (None: the kernels on a CUDA device, their plain versions on the
    CPU; False: the plain versions everywhere, for comparisons).
    """

    def __init__(self, cfg: ModelConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 use_kernel: Optional[bool] = None):
        super().__init__()
        why = _unsupported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: {why} models are not ported yet ({_ROADMAP})")
        self.cfg = cfg
        self.use_kernel = use_kernel
        dev = resolve_device(device)
        gen = generator if generator is not None else \
            torch.Generator(device=dev).manual_seed(0)
        if gen.device.type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        dtype = getattr(torch, cfg.param_dtype)
        self.embed = nn.Parameter(
            layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
            requires_grad=False)
        self.layers = nn.ModuleList(
            ParamTree(self._init_layer(gen, dtype))
            for _ in range(cfg.num_layers))
        self.final_norm = ParamTree(layers.rmsnorm_init(cfg.d_model, dtype,
                                                        dev))
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dtype),
            requires_grad=False)
        self.windows = [int(w) for w in layer_windows(cfg)]
        self.compute_dtype = getattr(torch, cfg.compute_dtype)

    def _init_layer(self, gen: torch.Generator, dtype) -> Params:
        cfg, dev = self.cfg, gen.device
        p: Params = {"ln1": layers.rmsnorm_init(cfg.d_model, dtype, dev),
                     "ln2": layers.rmsnorm_init(cfg.d_model, dtype, dev)}
        if cfg.rwkv:
            p["rwkv"] = ssm.rwkv_init(gen, cfg, dtype)
            p["cmix"] = {
                "mu": torch.full((2, cfg.d_model), 0.5, dtype=dtype,
                                 device=dev),
                "wk": layers.dense_init(gen, cfg.d_model, cfg.d_ff, dtype),
                "wv": layers.dense_init(gen, cfg.d_ff, cfg.d_model, dtype),
                "wr": layers.dense_init(gen, cfg.d_model, cfg.d_model,
                                        dtype)}
            return p
        p["attn"] = layers.attention_init(gen, cfg, dtype)
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dtype)
        return p

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- parameters -----------------------------------------------------------

    def param_tree(self) -> Params:
        """{"embed", "layers": [per-layer dict], "final_norm"
        [, "lm_head"]} of the module's tensors."""
        p = {"embed": self.embed, "layers": [m.tree() for m in self.layers],
             "final_norm": self.final_norm.tree()}
        if self.lm_head is not None:
            p["lm_head"] = self.lm_head
        return p

    @torch.no_grad()
    def load_params(self, params: Params) -> None:
        """Copy a ``param_tree``-shaped tree into the module."""
        tree_map(lambda dst, src: dst.copy_(src), self.param_tree(), params)

    def _layer(self, i: int) -> Params:
        p = self.layers[i].tree()
        if self.compute_dtype != getattr(torch, self.cfg.param_dtype):
            p = tree_map(lambda w: w.to(self.compute_dtype)
                         if w.is_floating_point() else w, p)
        return p

    # -- blocks ---------------------------------------------------------------

    @staticmethod
    def _cmix(p: Params, x: torch.Tensor, xprev: torch.Tensor
              ) -> torch.Tensor:
        """RWKV channel mixing (token-shifted squared-relu gate)."""
        mu = p["mu"].to(x.dtype)
        xk = x + (xprev - x) * mu[0]
        xr = x + (xprev - x) * mu[1]
        k = torch.square(F.relu(xk @ p["wk"]))
        return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])

    def block(self, p: Params, x: torch.Tensor, *, positions: torch.Tensor,
              window: int, collect_cache: bool = False
              ) -> Tuple[torch.Tensor, Params]:
        """Full-sequence block. Returns (x, aux): aux holds the layer's
        prefill cache entries when ``collect_cache``."""
        cfg = self.cfg
        aux: Params = {}
        if cfg.rwkv:
            h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
            y, (state, xlast) = ssm.rwkv_scan(p["rwkv"], cfg, h,
                                              use_kernel=self.use_kernel)
            x = x + y
            h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
            h2prev = F.pad(h2[:, :-1], (0, 0, 1, 0))
            x = x + self._cmix(p["cmix"], h2, h2prev)
            if collect_cache:
                aux = {"rwkv_state": state, "rwkv_xprev": xlast,
                       "cmix_xprev": h2[:, -1]}
            return x, aux

        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        attn_out, k, v = layers.attention(
            p["attn"], cfg, h, positions=positions, window=window,
            use_kernel=self.use_kernel)
        x = x + attn_out
        h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h2)
        if collect_cache:
            aux = {"k": k, "v": v}
        return x, aux

    # -- full forward (prefill) ---------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.long()]
        x = x * math.sqrt(self.cfg.d_model)
        return x.to(self.compute_dtype)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.rmsnorm(self.final_norm.tree(), x, cfg.norm_eps)
        head = self.embed.t() if cfg.tie_embeddings else self.lm_head
        out = (x @ head.to(x.dtype)).float()
        if cfg.logit_softcap and cfg.logit_softcap > 0:
            out = cfg.logit_softcap * torch.tanh(out / cfg.logit_softcap)
        return out

    def hidden(self, batch: Params, *, collect_cache: bool = False
               ) -> Tuple[torch.Tensor, Params]:
        """Trunk only: embeddings + layers, no head. batch: {"tokens":
        (B, S)}. With ``collect_cache``, aux holds each cache entry
        stacked on a leading L axis."""
        x = self.embed_tokens(batch["tokens"].to(self.device))
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        per_layer: List[Params] = []
        for i, window in enumerate(self.windows):
            x, aux = self.block(self._layer(i), x, positions=positions,
                                window=window, collect_cache=collect_cache)
            per_layer.append(aux)
        if not collect_cache:
            return x, {}
        return x, {key: torch.stack([a[key] for a in per_layer])
                   for key in per_layer[0]}

    def forward(self, batch: Params, *, collect_cache: bool = False
                ) -> Tuple[torch.Tensor, Params]:
        """Logits at every position (B, S, V) float32. A prefill needs only
        the last one: ``launch.steps.make_prefill_step``."""
        x, aux = self.hidden(batch, collect_cache=collect_cache)
        return self.logits(x), aux

    # -- decode ---------------------------------------------------------------

    def cache_len(self, seq_len: int) -> int:
        w = np.asarray(self.windows)
        if self.cfg.rwkv:
            return 0
        if (w > 0).all():
            return int(min(seq_len, int(w.max())))
        return seq_len

    def init_cache(self, batch: int, seq_len: int) -> Params:
        """An empty decode cache on the model's device (KV in the compute
        dtype, recurrent state float32)."""
        cfg, dev = self.cfg, self.device
        L, dtype = cfg.num_layers, self.compute_dtype
        if cfg.rwkv:
            H = cfg.d_model // ssm.RWKV_HEAD
            return {
                "rwkv_state": torch.zeros(
                    (L, batch, H, ssm.RWKV_HEAD, ssm.RWKV_HEAD),
                    dtype=torch.float32, device=dev),
                "rwkv_xprev": torch.zeros((L, batch, cfg.d_model),
                                          dtype=dtype, device=dev),
                "cmix_xprev": torch.zeros((L, batch, cfg.d_model),
                                          dtype=dtype, device=dev)}
        C = self.cache_len(seq_len)
        shape = (L, batch, C, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev),
                "pos_tab": torch.full((L, batch, C), -1, dtype=torch.int32,
                                      device=dev)}

    def decode_block(self, p: Params, x: torch.Tensor, cache: Params,
                     layer: int, *, pos: int, window: int) -> torch.Tensor:
        """One layer of a decode step; writes layer ``layer``'s entries of
        ``cache`` in place."""
        cfg = self.cfg
        if cfg.rwkv:
            h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
            state, y = ssm.rwkv_cell(p["rwkv"], cfg,
                                     cache["rwkv_state"][layer], h[:, 0],
                                     cache["rwkv_xprev"][layer])
            x = x + y[:, None]
            h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
            x = x + self._cmix(p["cmix"], h2[:, 0],
                               cache["cmix_xprev"][layer])[:, None]
            cache["rwkv_state"][layer] = state
            cache["rwkv_xprev"][layer] = h[:, 0]
            cache["cmix_xprev"][layer] = h2[:, 0]
            return x

        h = layers.rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + layers.decode_attention(
            p["attn"], cfg, h, pos=pos, cache_k=cache["k"][layer],
            cache_v=cache["v"][layer],
            cache_positions=cache["pos_tab"][layer], window=window)
        h2 = layers.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + layers.mlp(p["mlp"], h2)

    def decode_step(self, cache: Params, tokens: torch.Tensor, pos: int
                    ) -> Tuple[torch.Tensor, Params]:
        """One decode step. tokens: (B, 1); pos: the tokens' position.
        Returns (logits (B, 1, V) float32, cache) — the same cache dict,
        updated in place."""
        x = self.embed_tokens(tokens.to(self.device))
        for i, window in enumerate(self.windows):
            x = self.decode_block(self._layer(i), x, cache, i, pos=int(pos),
                                  window=window)
        return self.logits(x), cache


# -- parameter carry between the JAX package and the port ---------------------

def params_from_reference(tree: Params, device="cuda") -> Params:
    """The reference's parameter tree (numpy arrays or tensors; layers
    stacked on a leading L axis) -> the port's ``param_tree`` layout (a
    list of per-layer dicts) on ``device``. Values are copied exactly."""
    dev = resolve_device(device)

    def on(a):
        t = a if isinstance(a, torch.Tensor) else \
            torch.from_numpy(np.array(a, copy=True))
        return t.to(dev)
    stacked = tree["layers"]
    L = len(tree_leaves(stacked)[0])
    out = {k: on(v) if not isinstance(v, dict) else tree_map(on, v)
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [tree_map(lambda a, i=i: on(a[i]), stacked)
                     for i in range(L)]
    return out


def params_to_reference(params: Params) -> Params:
    """The inverse of ``params_from_reference``: numpy arrays, layers
    stacked on a leading L axis (float32 parameters only)."""
    def host(t):
        return t.detach().cpu().numpy()
    out = {k: host(v) if isinstance(v, torch.Tensor) else tree_map(host, v)
           for k, v in params.items() if k != "layers"}
    out["layers"] = tree_map(lambda *xs: np.stack([host(x) for x in xs]),
                             *params["layers"])
    return out

