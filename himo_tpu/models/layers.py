"""Plain-JAX layers with ``flax.linen``'s parameter layout and formulas.

The networks were first written as ``flax.linen`` modules. These functions
keep flax's parameter tree (``{"Dense_0": {"kernel", "bias"}, ...}``), its
initializers and its arithmetic (dtype promotion, SAME padding, fast-variance
GroupNorm over every axis but the leading one), so checkpoints and tree
walks carry over, while the models depend on JAX alone.

A layer is a function ``layer(p, x, ...)`` of a :class:`Params` node. In
``init`` mode the node creates each parameter on first access from a key
folded with its path; in ``apply`` mode it only reads. Children are named
explicitly, flax-style (``p["Dense_0"]``); a module reused across calls
passes the same node again.
"""

from __future__ import annotations

import zlib
from typing import Mapping

import jax
import jax.numpy as jnp

lecun_normal = jax.nn.initializers.lecun_normal()
orthogonal = jax.nn.initializers.orthogonal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones
relu = jax.nn.relu


def _fold(key, name: str):
    return jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


class Params:
    """One node of a parameter tree; creates leaves when it holds a key."""

    def __init__(self, tree: Mapping, key=None):
        self.tree = tree
        self.key = key

    def __getitem__(self, name: str) -> "Params":
        if self.key is None:
            return Params(self.tree[name])
        return Params(self.tree.setdefault(name, {}), _fold(self.key, name))

    def param(self, name: str, init, shape) -> jax.Array:
        if self.key is not None and name not in self.tree:
            self.tree[name] = init(_fold(self.key, name), tuple(shape), jnp.float32)
        return self.tree[name]


class Module:
    """Base for networks written as ``__call__(self, p, *args)``.

    ``init`` returns ``{"params": tree}`` and ``apply`` takes it back, the
    same contract as a ``flax.linen`` module."""

    def init(self, key, *args, **kwargs):
        def build(key):
            tree: dict = {}
            self(Params(tree, key), *args, **kwargs)
            return tree

        return {"params": jax.jit(build)(key)}

    def apply(self, variables, *args, **kwargs):
        return self(Params(variables["params"]), *args, **kwargs)


def _promote(dtype, *xs):
    if dtype is None:
        dtype = jnp.result_type(*[x for x in xs if x is not None])
    return [None if x is None else jnp.asarray(x, dtype) for x in xs]


def dense(p: Params, x, features: int, dtype=None, use_bias: bool = True,
          kernel_init=lecun_normal, bias_init=zeros):
    """``flax.linen.Dense``: ``x @ kernel + bias`` over the last axis."""
    kernel = p.param("kernel", kernel_init, (x.shape[-1], features))
    bias = p.param("bias", bias_init, (features,)) if use_bias else None
    x, kernel, bias = _promote(dtype, x, kernel, bias)
    y = jax.lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())))
    if bias is not None:
        y = y + bias.reshape((1,) * (y.ndim - 1) + (-1,))
    return y


def conv(p: Params, x, features: int, kernel_size=(3, 3), strides=(1, 1),
         dtype=None, bias_init=zeros):
    """``flax.linen.Conv`` on (..., H, W, C) with SAME padding."""
    kernel = p.param(
        "kernel", lecun_normal, (*kernel_size, x.shape[-1], features)
    )
    bias = p.param("bias", bias_init, (features,))
    batch = x.shape[:-3]
    x = x.reshape((-1,) + x.shape[-3:])
    x, kernel, bias = _promote(dtype, x, kernel, bias)
    y = jax.lax.conv_general_dilated(
        x, kernel, tuple(strides), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    y = y + bias.reshape(1, 1, 1, -1)
    return y.reshape(batch + y.shape[1:])


def group_norm(p: Params, x, num_groups: int = 8, dtype=None,
               epsilon: float = 1e-6):
    """``flax.linen.GroupNorm``: statistics per leading index and channel
    group, over every other axis, in float32 (E[x^2] - E[x]^2)."""
    c = x.shape[-1]
    gs = c // num_groups
    xg = x.reshape(x.shape[:-1] + (num_groups, gs))
    xg = xg.astype(jnp.promote_types(x.dtype, jnp.float32))
    axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
    mu = xg.mean(axes)
    var = jnp.maximum(0.0, (xg * xg).mean(axes) - mu * mu)
    bshape = x.shape[:1] + (1,) * (x.ndim - 2) + (c,)
    mu = jnp.repeat(mu, gs, axis=-1).reshape(bshape)
    var = jnp.repeat(var, gs, axis=-1).reshape(bshape)
    scale = p.param("scale", ones, (c,))
    bias = p.param("bias", zeros, (c,))
    fshape = (1,) * (x.ndim - 1) + (c,)
    y = (x - mu) * (jax.lax.rsqrt(var + epsilon) * scale.reshape(fshape))
    y = y + bias.reshape(fshape)
    return y.astype(dtype or jnp.result_type(x, scale, bias))


def gru_cell(p: Params, h, x, dtype=None):
    """``flax.linen.GRUCell`` step; returns the new hidden state."""
    features = h.shape[-1]

    def inp(name):
        return dense(p[name], x, features, dtype)

    def rec(name, use_bias=False):
        return dense(p[name], h, features, dtype, use_bias=use_bias,
                     kernel_init=orthogonal)

    r = jax.nn.sigmoid(inp("ir") + rec("hr"))
    z = jax.nn.sigmoid(inp("iz") + rec("hz"))
    n = jnp.tanh(inp("in") + r * rec("hn", use_bias=True))
    return (1.0 - z) * n + z * h
