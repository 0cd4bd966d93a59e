"""A small pure-JAX module layer: the model zoo's only dependency beyond JAX.

A model is a tree of `Module` dataclasses.  Submodules are created either
inside a ``__call__`` (auto-named ``ClassName_k``, or given ``name=``) or in
``setup()`` (named after the attribute they are assigned to).  Variables live
in plain nested dicts keyed by that module path, one dict per collection
(``params``, ``batch_stats``):

    variables = model.init({"params": key, "dropout": key2}, *args)
    out = model.apply(variables, *args, deterministic=True)
    out, updates = model.apply(variables, *args, rngs={"dropout": key},
                               mutable=["batch_stats"])

`init` runs the model once and returns every variable it created; `apply`
runs it against given variables and, for each collection named in
``mutable``, returns the updated values.  Parameter initialisers and
``make_rng`` streams are derived from the root keys by folding in a hash of
the module path, so a parameter's initial value depends only on its path and
the seed.

Beside the base class: `Dense`, `Conv`, `LayerNorm`, `GroupNorm`, `Dropout`,
`Embed`, `MultiHeadAttention` and `remat`.  Initialisers are
``jax.nn.initializers``.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import inspect
import threading
import zlib
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

initializers = jax.nn.initializers

_STACK = threading.local()  # .frames: modules whose methods are running


def _frames() -> list:
    if not hasattr(_STACK, "frames"):
        _STACK.frames = []
    return _STACK.frames


def _path_hash(parts: Iterable[str]) -> int:
    return zlib.crc32("/".join(parts).encode()) & 0x7FFFFFFF


class _Context:
    """State of one `init` or `apply` call: the variables being read and
    written, the root PRNG keys, and which collections may change."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = _copy_dicts(variables)
        self.rngs = dict(rngs)
        self.mutable = mutable  # set of collection names, or True for all
        self.initializing = initializing
        self.rng_counts: Dict[Tuple[str, ...], int] = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def node(self, col: str, path: Tuple[str, ...], create: bool) -> Optional[dict]:
        d = self.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.variables[col] = {}
        for p in path:
            nxt = d.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = d[p] = {}
            d = nxt
        return d


def _copy_dicts(tree):
    """Copy the dict structure (not the arrays) so writes never alias the
    caller's variables."""
    if isinstance(tree, dict):
        return {k: _copy_dicts(v) for k, v in tree.items()}
    return tree


class _Variable:
    """Handle to one non-parameter variable, read and written via ``.value``."""

    def __init__(self, ctx: _Context, col: str, path: Tuple[str, ...], name: str):
        self._ctx, self._col, self._path, self._name = ctx, col, path, name

    @property
    def value(self):
        return self._ctx.node(self._col, self._path, create=False)[self._name]

    @value.setter
    def value(self, v):
        if not self._ctx.is_mutable(self._col):
            raise ValueError(
                f"collection {self._col!r} is not mutable here: pass "
                f"mutable=[{self._col!r}] to apply() "
                f"(variable {'/'.join(self._path + (self._name,))})"
            )
        self._ctx.node(self._col, self._path, create=True)[self._name] = v


def _wrap_method(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        frames = _frames()
        self._bind()
        if self not in frames:
            object.__setattr__(self, "_counters", {})
        frames.append(self)
        try:
            if not self._setup_done:
                object.__setattr__(self, "_setup_done", True)
                object.__setattr__(self, "_in_setup", True)
                try:
                    self.setup()
                finally:
                    object.__setattr__(self, "_in_setup", False)
            return fn(self, *args, **kwargs)
        finally:
            frames.pop()

    wrapped._module_method = True
    return wrapped


class Module:
    """Base class.  Subclasses are dataclasses; their public methods run
    with the module bound to the current `init`/`apply` context."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(eq=False)(cls)
        for attr, fn in list(cls.__dict__.items()):
            if (
                inspect.isfunction(fn)
                and (attr == "__call__" or not attr.startswith("_"))
                and attr != "setup"
                and not getattr(fn, "_module_method", False)
            ):
                setattr(cls, attr, _wrap_method(fn))
        init = cls.__init__

        @functools.wraps(init)
        def __init__(self, *args, name: Optional[str] = None, **kw):
            frames = _frames()
            parent = frames[-1] if frames else None
            object.__setattr__(self, "_parent", parent)
            object.__setattr__(self, "_ctx", None)
            object.__setattr__(self, "_path", ())
            object.__setattr__(self, "_setup_done", False)
            object.__setattr__(self, "_in_setup", False)
            object.__setattr__(self, "_counters", {})
            if name is None and parent is not None and not parent._in_setup:
                n = parent._counters.get(type(self).__name__, 0)
                parent._counters[type(self).__name__] = n + 1
                name = f"{type(self).__name__}_{n}"
            object.__setattr__(self, "name", name)
            init(self, *args, **kw)

        cls.__init__ = __init__

    def __setattr__(self, key, value):
        # setup(): a submodule takes the attribute's name
        if isinstance(value, Module) and self._in_setup and value.name is None:
            object.__setattr__(value, "name", key)
        object.__setattr__(self, key, value)

    def setup(self) -> None:
        """Override to create submodules as attributes (run lazily, once per
        bound instance)."""

    def _bind(self) -> None:
        if self._ctx is not None:
            return
        parent = self._parent
        if parent is None or parent._ctx is None or self.name is None:
            raise ValueError(
                f"{type(self).__name__} is not bound: call it through "
                "init()/apply() or from within a bound module"
            )
        object.__setattr__(self, "_ctx", parent._ctx)
        object.__setattr__(self, "_path", parent._path + (self.name,))

    # -- variables -------------------------------------------------------

    def is_initializing(self) -> bool:
        return self._ctx.initializing

    def param(self, name: str, init_fn: Callable, *init_args):
        ctx = self._ctx
        node = ctx.node("params", self._path, create=ctx.initializing)
        if node is not None and name in node:
            return node[name]
        if not ctx.initializing:
            raise KeyError(f"missing parameter {'/'.join(self._path + (name,))}")
        key = jax.random.fold_in(
            ctx.rngs["params"], _path_hash(self._path + (name,))
        )
        node[name] = init_fn(key, *init_args)
        return node[name]

    def variable(self, col: str, name: str, init_fn: Callable, *init_args) -> _Variable:
        ctx = self._ctx
        node = ctx.node(col, self._path, create=ctx.initializing)
        if node is None or name not in node:
            if not ctx.initializing:
                raise KeyError(
                    f"missing variable {col}:{'/'.join(self._path + (name,))}"
                )
            node[name] = init_fn(*init_args)
        return _Variable(ctx, col, self._path, name)

    def make_rng(self, name: str) -> jax.Array:
        ctx = self._ctx
        if name not in ctx.rngs:
            raise ValueError(f"no PRNG key for stream {name!r}: pass rngs={{{name!r}: key}}")
        slot = self._path + (name,)
        n = ctx.rng_counts.get(slot, 0)
        ctx.rng_counts[slot] = n + 1
        return jax.random.fold_in(ctx.rngs[name], _path_hash(slot + (str(n),)))

    # -- entry points ----------------------------------------------------

    def _root(self, ctx: _Context) -> "Module":
        root = copy.copy(self)
        for k, v in (("_parent", None), ("_ctx", ctx), ("_path", ()),
                     ("_setup_done", False), ("_in_setup", False),
                     ("_counters", {})):
            object.__setattr__(root, k, v)
        return root

    def init(self, rngs, *args, **kwargs) -> Dict[str, Any]:
        """Run ``__call__`` once, creating every variable; returns
        ``{collection: nested dict}``."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        ctx = _Context({}, rngs, mutable=True, initializing=True)
        self._root(ctx)(*args, **kwargs)
        return ctx.variables

    def apply(
        self,
        variables: Dict[str, Any],
        *args,
        rngs: Optional[Dict[str, jax.Array]] = None,
        mutable: Union[bool, Sequence[str]] = False,
        **kwargs,
    ):
        """Run ``__call__`` against ``variables``.  With ``mutable`` (a list
        of collection names) returns ``(out, {col: updated})``."""
        cols = set(mutable) if mutable not in (False, True) else mutable
        ctx = _Context(variables, rngs or {}, mutable=cols or set(),
                       initializing=False)
        out = self._root(ctx)(*args, **kwargs)
        if not mutable:
            return out
        names = ctx.variables if mutable is True else cols
        return out, {c: ctx.variables[c] for c in names if c in ctx.variables}


def remat(module_cls, static_argnums: Tuple[int, ...] = ()):
    """``module_cls`` whose ``__call__`` is recomputed in the backward pass
    (``jax.checkpoint``).  ``static_argnums`` counts ``self`` as 0, so the
    first call argument is 1."""

    class Remat(module_cls):
        def __call__(self, *args):
            ctx = self._ctx
            if ctx.initializing:
                return super().__call__(*args)
            path = self._path
            sub = {c: ctx.node(c, path, create=False) or {} for c in ctx.variables}
            mutable = [c for c in sub if ctx.is_mutable(c)]
            base_call = super().__call__.__func__
            counts = {}  # rng counters after the call, learned while tracing

            def run(sub_vars, rng_keys, *call_args):
                nested = {}
                for c, tree in sub_vars.items():
                    d = nested.setdefault(c, {})
                    for p in path[:-1]:
                        d = d.setdefault(p, {})
                    d[path[-1]] = tree
                inner_ctx = _Context(nested, rng_keys, ctx.mutable, False)
                inner_ctx.rng_counts = dict(ctx.rng_counts)
                inner = copy.copy(self)
                for k, v in (("_ctx", inner_ctx), ("_setup_done", False),
                             ("_in_setup", False), ("_counters", {})):
                    object.__setattr__(inner, k, v)
                out = base_call(inner, *call_args)
                counts.update(inner_ctx.rng_counts)
                return out, {c: inner_ctx.node(c, path, create=False) or {}
                             for c in mutable}

            # the wrapped function takes (sub_vars, rng_keys, *args)
            static = tuple(i + 1 for i in static_argnums)
            out, new = jax.checkpoint(run, static_argnums=static)(
                sub, ctx.rngs, *args
            )
            for c, tree in new.items():
                ctx.node(c, path[:-1], create=True)[path[-1]] = tree
            ctx.rng_counts.update(counts)
            return out

    Remat.__name__ = Remat.__qualname__ = module_cls.__name__
    return Remat


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _dtype(dtype, *xs):
    return jnp.dtype(dtype) if dtype is not None else jnp.result_type(*xs)


class Dense(Module):
    """y = x @ kernel + bias; ``kernel`` is (in, features)."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init, (x.shape[-1], self.features))
        dt = _dtype(self.dtype, x, kernel)
        y = jnp.matmul(x.astype(dt), kernel.astype(dt))
        if self.use_bias:
            y = y + self.param("bias", self.bias_init, (self.features,)).astype(dt)
        return y


class Conv(Module):
    """Channels-last convolution over 1 or 2 spatial axes; ``kernel`` is
    (*kernel_size, in // groups, features)."""

    features: int
    kernel_size: Tuple[int, ...]
    strides: Union[int, Tuple[int, ...]] = 1
    padding: str = "SAME"
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Any = None
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x):
        nd = len(self.kernel_size)
        strides = (self.strides,) * nd if isinstance(self.strides, int) else self.strides
        kernel = self.param(
            "kernel", self.kernel_init,
            (*self.kernel_size, x.shape[-1] // self.feature_group_count, self.features),
        )
        dt = _dtype(self.dtype, x, kernel)
        spatial = "HW"[:nd] if nd <= 2 else None
        y = jax.lax.conv_general_dilated(
            x.astype(dt), kernel.astype(dt),
            window_strides=strides, padding=self.padding,
            dimension_numbers=(f"N{spatial}C", f"{spatial}IO", f"N{spatial}C"),
            feature_group_count=self.feature_group_count,
        )
        if self.use_bias:
            y = y + self.param("bias", self.bias_init, (self.features,)).astype(dt)
        return y


def _normalize(x, axes, epsilon):
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mean = jnp.mean(xf, axis=axes, keepdims=True)
    var = jnp.mean(jnp.square(xf - mean), axis=axes, keepdims=True)
    return (xf - mean) * jax.lax.rsqrt(var + epsilon)


class LayerNorm(Module):
    """Normalise over the last axis (statistics in float32), then scale and
    shift."""

    epsilon: float = 1e-6
    dtype: Any = None

    def __call__(self, x):
        c = x.shape[-1]
        scale = self.param("scale", initializers.ones, (c,))
        bias = self.param("bias", initializers.zeros, (c,))
        y = _normalize(x, (-1,), self.epsilon) * scale + bias
        return y.astype(_dtype(self.dtype, x))


class GroupNorm(Module):
    """Normalise each example over all non-batch axes within ``num_groups``
    channel groups."""

    num_groups: int = 32
    epsilon: float = 1e-6
    dtype: Any = None

    def __call__(self, x):
        c = x.shape[-1]
        if c % self.num_groups:
            raise ValueError(f"{c} channels not divisible into {self.num_groups} groups")
        scale = self.param("scale", initializers.ones, (c,))
        bias = self.param("bias", initializers.zeros, (c,))
        g = x.reshape(*x.shape[:-1], self.num_groups, c // self.num_groups)
        axes = tuple(range(1, g.ndim - 2)) + (g.ndim - 1,)
        y = _normalize(g, axes, self.epsilon).reshape(x.shape) * scale + bias
        return y.astype(_dtype(self.dtype, x))


class Dropout(Module):
    """Zero each element with probability ``rate`` and rescale the rest;
    draws from the ``dropout`` PRNG stream."""

    rate: float

    def __call__(self, x, deterministic: bool):
        if deterministic or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return jnp.zeros_like(x)
        keep = jax.random.bernoulli(self.make_rng("dropout"), 1.0 - self.rate, x.shape)
        return jnp.where(keep, x / (1.0 - self.rate), 0).astype(x.dtype)


class Embed(Module):
    """Token id → row of an (num_embeddings, features) table."""

    num_embeddings: int
    features: int

    def __call__(self, ids):
        table = self.param(
            "embedding",
            initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0),
            (self.num_embeddings, self.features),
        )
        return jnp.take(table, ids, axis=0)


class _HeadsDense(Module):
    """(…, d) → (…, heads, head_dim) projection; kernel (d, heads, head_dim)."""

    heads: int
    head_dim: int

    def __call__(self, x):
        kernel = self.param("kernel", initializers.lecun_normal(),
                            (x.shape[-1], self.heads, self.head_dim))
        bias = self.param("bias", initializers.zeros, (self.heads, self.head_dim))
        return jnp.einsum("...d,dhk->...hk", x, kernel) + bias


class _MergeHeadsDense(Module):
    """(…, heads, head_dim) → (…, features); kernel (heads, head_dim, features)."""

    features: int

    def __call__(self, x):
        kernel = self.param(
            "kernel",
            initializers.lecun_normal(in_axis=(0, 1), out_axis=2),
            (x.shape[-2], x.shape[-1], self.features),
        )
        bias = self.param("bias", initializers.zeros, (self.features,))
        return jnp.einsum("...hk,hkf->...f", x, kernel) + bias


class MultiHeadAttention(Module):
    """Scaled dot-product attention with per-head ``query``/``key``/``value``
    projections (kernels (d, H, d/H)) and an ``out`` projection (kernel
    (H, d/H, d)).  ``mask`` broadcasts to (B, H, Tq, Tk); True = attend."""

    num_heads: int
    dropout_rate: float = 0.0

    def __call__(self, inputs_q, inputs_kv, mask=None, deterministic: bool = True):
        d = inputs_q.shape[-1]
        dh = d // self.num_heads
        q = _HeadsDense(self.num_heads, dh, name="query")(inputs_q)
        k = _HeadsDense(self.num_heads, dh, name="key")(inputs_kv)
        v = _HeadsDense(self.num_heads, dh, name="value")(inputs_kv)
        scores = jnp.einsum("bqhd,bkhd->bhqk", q / np.sqrt(dh).astype(q.dtype), k)
        if mask is not None:
            scores = jnp.where(mask, scores, jnp.finfo(scores.dtype).min)
        w = jax.nn.softmax(scores, axis=-1)
        w = Dropout(self.dropout_rate)(w, deterministic=deterministic)
        out = jnp.einsum("bhqk,bkhd->bqhd", w, v)
        return _MergeHeadsDense(d, name="out")(out)
