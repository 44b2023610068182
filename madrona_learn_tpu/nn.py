"""A small module layer: dataclass modules over explicit variable trees.

Models are written as in flax's ``linen``: a ``Module`` is a dataclass of
hyperparameters and child modules; ``setup()`` or a ``@compact`` method
declares parameters (``self.param``) and children; ``init`` builds the
variable tree and ``apply`` runs a method against one. Only what the
repository's models use is provided:

- child modules as fields (named after the field, ``field_key`` for dicts
  and ``field_i`` for lists), assigned in ``setup()`` (named after the
  attribute unless given ``name=``), or created in a ``@compact`` method
  (``ClassName_k`` unless given ``name=``);
- ``param``, ``init``/``init_with_output``/``apply(method=, mutable=)``,
  ``is_initializing`` and ``variables``;
- ``Dense``, ``LayerNorm`` and ``MultiHeadDotProductAttention``.

Parameter trees, names, initial values and layer arithmetic follow linen:
a parameter's init key is the root key folded with a hash of its scope
path and a per-scope counter, as linen derives it, so a model built here
starts from the same weights as the same model built with linen. Time
scans use ``jax.lax.scan`` and rematerialisation ``jax.checkpoint`` over
closures of bound modules: parameters already exist, so the closures read
them as constants.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import threading
from collections.abc import Mapping
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = [
    "Module", "compact", "Dense", "LayerNorm",
    "MultiHeadDotProductAttention",
]

default_kernel_init = jax.nn.initializers.lecun_normal()

# Modules whose @compact method is running, innermost last; None marks a
# setup() in progress (modules built there are bound by attribute
# assignment, not adopted by the compact caller).
_ctx = threading.local()


def _stack():
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


def _fold_in_path(key, path):
    """linen's static fold-in: SHA-1 of the path entries, first 4 bytes."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(m.digest()[:4], byteorder="big")))


class _Root:
    def __init__(self, variables, rng, initializing):
        self.variables = variables
        self.rng = rng
        self.initializing = initializing


class _Scope:
    """One node of the variable tree: a path below the root."""

    def __init__(self, root, path):
        self.root = root
        self.path = path
        self.children = {}
        self.rng_count = 0

    def child(self, name):
        if name not in self.children:
            self.children[name] = _Scope(self.root, self.path + (name,))
        return self.children[name]

    def collection(self, col, create=False):
        d = self.root.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.root.variables[col] = {}
        for name in self.path:
            nxt = d.get(name)
            if nxt is None:
                if not create:
                    return None
                nxt = d[name] = {}
            d = nxt
        return d

    def param(self, name, init_fn, *init_args):
        params = self.collection("params", create=self.root.initializing)
        if params is not None and name in params:
            return params[name]
        if not self.root.initializing:
            raise KeyError(
                f"parameter {'/'.join(self.path + (name,))} is missing "
                "from the variables passed to apply()")
        self.rng_count += 1
        key = _fold_in_path(self.root.rng, self.path + (self.rng_count,))
        value = init_fn(key, *init_args)
        params[name] = value
        return value


def _bind_tree(value, scope, name, explicit_names):
    """Bind the modules in ``value`` (a module, or a dict/list/tuple of
    them) below ``scope``; anything else is returned unchanged."""
    def child_name(m, default):
        return m.name if explicit_names and m.name is not None else default

    if isinstance(value, Module):
        return value._bind(scope.child(child_name(value, name)))
    if isinstance(value, Mapping) and any(
            isinstance(v, Module) for v in value.values()):
        return {k: v._bind(scope.child(child_name(v, f"{name}_{k}")))
                for k, v in value.items()}
    if isinstance(value, (list, tuple)) and any(
            isinstance(v, Module) for v in value):
        return type(value)(
            v._bind(scope.child(child_name(v, f"{name}_{i}")))
            for i, v in enumerate(value))
    return value


def compact(fn):
    """Marks the method in which a module creates its children inline."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._require_scope()
        object.__setattr__(self, "_autonames", {})
        stack = _stack()
        stack.append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            stack.pop()

    return wrapped


@dataclasses.dataclass(eq=True, unsafe_hash=True)
class Module:
    """Base class; subclasses are dataclasses of their hyperparameters."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    _scope = None
    _in_setup = False

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=True, unsafe_hash=True)(cls)

    def __post_init__(self):
        stack = _stack()
        if stack and stack[-1] is not None:
            parent = stack[-1]
            name = self.name
            if name is None:
                cls_name = type(self).__name__
                k = parent._autonames.get(cls_name, 0)
                parent._autonames[cls_name] = k + 1
                name = f"{cls_name}_{k}"
            self._attach(parent._scope.child(name))

    def __setattr__(self, name, value):
        if self._in_setup and not name.startswith("_"):
            value = _bind_tree(value, self._scope, name, explicit_names=True)
        object.__setattr__(self, name, value)

    def setup(self):
        pass

    # -- binding ---------------------------------------------------------------

    def _bind(self, scope):
        clone = copy.copy(self)
        clone._attach(scope)
        return clone

    def _attach(self, scope):
        object.__setattr__(self, "_scope", scope)
        for f in dataclasses.fields(self):
            if f.name == "name":
                continue
            value = getattr(self, f.name)
            bound = _bind_tree(value, scope, f.name, explicit_names=False)
            if bound is not value:
                object.__setattr__(self, f.name, bound)
        if type(self).setup is not Module.setup:
            stack = _stack()
            stack.append(None)
            object.__setattr__(self, "_in_setup", True)
            try:
                self.setup()
            finally:
                object.__setattr__(self, "_in_setup", False)
                stack.pop()

    def _require_scope(self):
        if self._scope is None:
            raise ValueError(
                f"{type(self).__name__} is not bound to variables; call it "
                "through init() or apply()")
        return self._scope

    # -- inside a bound module -------------------------------------------------

    def param(self, name: str, init_fn: Callable, *init_args):
        """The parameter ``name`` of this module, created by
        ``init_fn(key, *init_args)`` during init."""
        return self._require_scope().param(name, init_fn, *init_args)

    def is_initializing(self) -> bool:
        return self._require_scope().root.initializing

    @property
    def variables(self):
        scope = self._require_scope()
        out = {}
        for col in scope.root.variables:
            d = scope.collection(col)
            if d is not None:
                out[col] = d
        return out

    # -- entry points ----------------------------------------------------------

    def _run(self, root, method, args, kwargs):
        bound = self._bind(_Scope(root, ()))
        if method is None:
            fn = bound.__call__
        elif isinstance(method, str):
            fn = getattr(bound, method)
        else:
            fn = functools.partial(method, bound)
        stack = _stack()
        saved = stack[:]
        stack.clear()
        try:
            return fn(*args, **kwargs)
        finally:
            stack[:] = saved

    def init_with_output(self, rngs, *args, method=None, **kwargs):
        """Run ``method`` creating parameters; ``(output, variables)``."""
        key = rngs["params"] if isinstance(rngs, Mapping) else rngs
        root = _Root({}, key, initializing=True)
        out = self._run(root, method, args, kwargs)
        return out, root.variables

    def init(self, rngs, *args, method=None, **kwargs):
        return self.init_with_output(
            rngs, *args, method=method, **kwargs)[1]

    def apply(self, variables, *args, method=None, mutable=False, **kwargs):
        """Run ``method`` against ``variables``. With ``mutable`` (a
        collection name, a list of them, or True) also return those
        collections; no module here writes a collection during apply."""
        root = _Root(variables, None, initializing=False)
        out = self._run(root, method, args, kwargs)
        if mutable is False:
            return out
        if mutable is True:
            cols = list(variables)
        elif isinstance(mutable, str):
            cols = [mutable]
        else:
            cols = list(mutable)
        return out, {c: variables.get(c, {}) for c in cols}


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _promote(*args, dtype=None):
    """Cast the non-None args to ``dtype`` (default: their common
    floating type)."""
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


class Dense(Module):
    """``y = x @ kernel + bias`` over the last axis, computed in ``dtype``."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = jax.nn.initializers.zeros

    def __call__(self, inputs):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(inputs)[-1], self.features),
                            self.param_dtype)
        bias = (self.param("bias", self.bias_init, (self.features,),
                           self.param_dtype) if self.use_bias else None)
        inputs, kernel, bias = _promote(inputs, kernel, bias,
                                        dtype=self.dtype)
        y = lax.dot_general(inputs, kernel,
                            (((inputs.ndim - 1,), (0,)), ((), ())),
                            precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class LayerNorm(Module):
    """Layer norm over the last axis; statistics in at least float32."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True

    def __call__(self, x):
        stat_dtype = jnp.promote_types(
            self.dtype if self.dtype is not None else x.dtype, jnp.float32)
        xs = x.astype(stat_dtype)
        mu = xs.mean(-1, keepdims=True)
        mu2 = lax.square(xs).mean(-1, keepdims=True)
        var = jnp.maximum(0.0, mu2 - lax.square(mu))
        features = (x.shape[-1],)

        y = xs - mu
        mul = lax.rsqrt(var + self.epsilon)
        args = [x]
        if self.use_scale:
            scale = self.param("scale", jax.nn.initializers.ones, features,
                               self.param_dtype)
            mul *= scale
            args.append(scale)
        y *= mul
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros, features,
                              self.param_dtype)
            y += bias
            args.append(bias)
        dtype = self.dtype
        if dtype is None:
            dtype = jnp.result_type(*args)
        return jnp.asarray(y, dtype)


class _Projection(Module):
    """Contract the last ``contract`` axes of x into ``features`` axes.

    Kernel ``[*in_axes, *features]`` and bias ``[*features]`` are drawn in
    their flattened 2-D / 1-D shapes and reshaped, as linen's DenseGeneral
    does."""

    features: tuple
    contract: int = 1
    dtype: Any = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = jax.nn.initializers.zeros

    def __call__(self, x):
        n = self.contract
        in_shape = tuple(x.shape[-n:])
        flat_in = int(np.prod(in_shape))
        flat_out = int(np.prod(self.features))

        def kernel_init(key, shape, dtype):
            return jnp.reshape(
                self.kernel_init(key, (flat_in, flat_out), dtype), shape)

        def bias_init(key, shape, dtype):
            return jnp.reshape(self.bias_init(key, (flat_out,), dtype), shape)

        kernel = self.param("kernel", kernel_init, in_shape + self.features,
                            jnp.float32)
        bias = self.param("bias", bias_init, self.features, jnp.float32)
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(
            x, kernel,
            ((tuple(range(x.ndim - n, x.ndim)), tuple(range(n))), ((), ())))
        return y + bias


class MultiHeadDotProductAttention(Module):
    """Self-attention: query/key/value projections to ``[..., S, heads,
    head_dim]``, ``jax.nn.dot_product_attention`` (XLA, or cuDNN where it
    applies), and an output projection."""

    num_heads: int
    qkv_features: Optional[int] = None
    out_features: Optional[int] = None
    dtype: Any = None
    kernel_init: Callable = default_kernel_init

    @compact
    def __call__(self, x):
        qkv = self.qkv_features or x.shape[-1]
        head_dim = qkv // self.num_heads

        def project(name):
            return _Projection(features=(self.num_heads, head_dim),
                               dtype=self.dtype,
                               kernel_init=self.kernel_init, name=name)(x)

        q, k, v = project("query"), project("key"), project("value")
        fold = lambda t: t.reshape((-1,) + t.shape[-3:])
        y = jax.nn.dot_product_attention(fold(q), fold(k), fold(v))
        y = y.reshape(q.shape)
        return _Projection(features=(self.out_features or x.shape[-1],),
                           contract=2, dtype=self.dtype,
                           kernel_init=self.kernel_init, name="out")(y)
