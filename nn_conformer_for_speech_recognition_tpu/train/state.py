"""Train state: params + batch stats + optimizer state + step + PRNG.

Unlike the reference's checkpoint (final weights only, no optimizer state or
step — `lib/standard/runner.py:48-60`), the full state is a single pytree so
`train/checkpoint.py` can save and restore everything needed for exact resume
(SURVEY.md §5 checkpoint/resume).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import optax


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jax.Array
    params: Any
    batch_stats: Any
    opt_state: Any
    rng: jax.Array
    # static: the optimizer is part of the tree's structure, not a leaf
    tx: optax.GradientTransformation = dataclasses.field(metadata=dict(static=True))

    @classmethod
    def create(cls, params, batch_stats, tx, rng):
        return cls(
            step=jnp.zeros((), jnp.int32),
            params=params,
            batch_stats=batch_stats,
            opt_state=tx.init(params),
            rng=rng,
            tx=tx,
        )

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)

    def apply_gradients(self, grads, new_batch_stats, new_rng):
        updates, new_opt_state = self.tx.update(grads, self.opt_state, self.params)
        new_params = optax.apply_updates(self.params, updates)
        return self.replace(
            step=self.step + 1,
            params=new_params,
            batch_stats=new_batch_stats,
            opt_state=new_opt_state,
            rng=new_rng,
        )
