"""Shared model primitives: init helpers, norms, activations, losses.

The JAX package's ``models/common.py`` in PyTorch: f32 master parameters
(``PDTYPE``), bf16 matmul compute (``CDTYPE``), f32 norms and loss
reductions.  Initialisers draw from an explicit ``torch.Generator`` on
``device`` (``"cuda"`` unless the caller asks for the CPU); they cannot
share the reference's JAX draws, so weights carried across come through
``repro_torch.interop``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = [
    "dense_init", "embed_init", "rms_norm", "layer_norm", "act_fn",
    "softmax_xent", "sigmoid_bce", "mlp_init", "mlp_apply", "div",
    "seeded",
]

PDTYPE = torch.float32   # parameter dtype (f32 master copies)
CDTYPE = torch.bfloat16  # compute dtype


def div(x, y):
    """x / y, rounded as a true division where one side is a Python number:
    CUDA multiplies by a scalar divisor's reciprocal, and ``number /
    tensor`` is a reciprocal times the number on every device."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=y.dtype, device=y.device)
    elif not isinstance(y, torch.Tensor):
        y = torch.tensor(y, dtype=x.dtype, device=x.device)
    return x / y


def seeded(generator: Optional[torch.Generator], device,
           seed: int) -> Optional[torch.Generator]:
    """``generator``, else a new one on ``device`` seeded with ``seed``
    (none on the ``meta`` device, which draws nothing: shapes only)."""
    if generator is not None or torch.device(device).type == "meta":
        return generator
    return torch.Generator(device=device).manual_seed(seed)


def dense_init(shape, generator: Optional[torch.Generator] = None,
               scale: Optional[float] = None, dtype=PDTYPE,
               device="cuda") -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut to [-2, 2] times
    ``scale`` (default 1/sqrt(shape[0]), so ``wq`` of shape (D, H, dh) has
    fan-in D)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    t = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def embed_init(shape, generator: Optional[torch.Generator] = None,
               dtype=PDTYPE, device="cuda") -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(generator=generator).mul_(0.02)


def rms_norm(x, gamma, eps=1e-6):
    """RMS norm scaled by (1 + gamma), computed in f32, cast back to x's
    dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-6):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


def act_fn(name: str) -> Callable:
    """``gelu`` is the tanh approximation, as ``jax.nn.gelu``'s default."""
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu, "tanh": torch.tanh}[name]


def softmax_xent(logits, labels, mask=None):
    """Mean cross-entropy; logits upcast to f32 for the reduction.

    The reference takes the gold logit by a one-hot contraction so that a
    vocab axis sharded over devices stays sharded; on one card
    ``torch.gather`` of the f32 logits picks the same value and spares a
    (B, S, V) f32 one-hot."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def sigmoid_bce(logits, labels):
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def mlp_init(dims, generator: Optional[torch.Generator] = None, bias=True,
             dtype=PDTYPE, device="cuda"):
    """dims = [in, h1, ..., out] -> list of {'w','b'} layers."""
    layers = []
    for din, dout in zip(dims[:-1], dims[1:]):
        layer = {"w": dense_init((din, dout), generator, dtype=dtype,
                                 device=device)}
        if bias:
            layer["b"] = torch.zeros((dout,), dtype=dtype, device=device)
        layers.append(layer)
    return layers


def mlp_apply(layers, x, act="relu", final_act=False):
    f = act_fn(act)
    for i, layer in enumerate(layers):
        x = x @ layer["w"].to(x.dtype)
        if "b" in layer:
            x = x + layer["b"].to(x.dtype)
        if i < len(layers) - 1 or final_act:
            x = f(x)
    return x
