"""Dynamic loss scaling for fp16 training.

The update rule is the standard one (also flax's ``DynamicScale``): the
loss is multiplied by ``scale`` before differentiation and the float32
gradients divided by it after. After ``growth_interval`` finite steps in a
row the scale grows by ``growth_factor``; a non-finite gradient shrinks it
by ``backoff_factor`` (never below ``minimum_scale``) and resets the count.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..struct import PyTreeNode, field

__all__ = ["DynamicScale"]


class DynamicScale(PyTreeNode):
    growth_factor: float = field(pytree_node=False, default=2.0)
    backoff_factor: float = field(pytree_node=False, default=0.5)
    growth_interval: int = field(pytree_node=False, default=2000)
    fin_steps: int = 0
    scale: float = 65536.0
    minimum_scale: Optional[float] = field(
        pytree_node=False, default=float(jnp.finfo(jnp.float32).tiny))

    def value_and_grad(self, fun: Callable, has_aux: bool = False,
                       axis_name: Optional[str] = None):
        """Like ``jax.value_and_grad`` over the first argument; the returned
        function gives ``(new_scale, is_finite, value, grads)``.

        With ``axis_name`` (inside ``shard_map``), the unscaled gradients
        are averaged over that axis before the finiteness test, so every
        shard takes the same step."""

        def scaled(*args):
            out = fun(*args)
            if has_aux:
                return self.scale * out[0], out[1]
            return self.scale * out

        grad_fn = jax.value_and_grad(scaled, has_aux=has_aux)

        def wrapped(*args):
            value, grads = grad_fn(*args)
            if has_aux:
                value = (value[0] / self.scale, value[1])
            else:
                value = value / self.scale
            grads = jax.tree.map(
                lambda g: jnp.asarray(g, jnp.float32) / self.scale, grads)
            if axis_name is not None:
                grads = lax.pmean(grads, axis_name)

            finite = jnp.array(True)
            for g in jax.tree.leaves(grads):
                finite &= jnp.all(lax.is_finite(g))

            grow = self.fin_steps == self.growth_interval
            fin_scale = jnp.where(
                grow & finite,
                jnp.minimum(self.scale * self.growth_factor,
                            jnp.finfo(jnp.float32).max),
                self.scale)
            inf_scale = self.scale * self.backoff_factor
            if self.minimum_scale is not None:
                inf_scale = jnp.maximum(inf_scale, self.minimum_scale)
            new_self = self.replace(
                scale=jnp.where(finite, fin_scale, inf_scale),
                fin_steps=jnp.where(grow | (~finite), 0, self.fin_steps + 1))
            return new_self, finite, value, grads

        return wrapped
