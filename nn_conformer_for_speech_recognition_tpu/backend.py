"""Route choices by platform: the one place the code asks what it runs on.

Every choice that depends on the device (the compute dtype that
``compute_dtype="auto"`` means, the PRNG behind dropout masks) is read from
`routes`, keyed by the platform of the devices in use.  A platform without an
entry is an error, not a silent default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax


@dataclasses.dataclass(frozen=True)
class Routes:
    # what ModelConfig.compute_dtype="auto" resolves to
    compute_dtype: str
    # PRNG implementation for dropout masks (utils/rng.py): 'rbg' is XLA's
    # RngBitGenerator, 'threefry' JAX's counter-based default
    dropout_rng: str


_ROUTES = {
    "gpu": Routes(compute_dtype="bfloat16", dropout_rng="rbg"),
    "cpu": Routes(compute_dtype="float32", dropout_rng="threefry"),
}


def routes(platform: Optional[str] = None) -> Routes:
    """The routes for ``platform`` (default: the platform computations go
    to — the ``jax.default_device`` in effect, else ``jax.devices()``)."""
    if platform is None:
        dev = jax.config.jax_default_device
        platform = getattr(dev, "platform", dev) or jax.devices()[0].platform
    try:
        return _ROUTES[platform]
    except KeyError:
        raise ValueError(
            f"no routes for platform {platform!r} (supported: {sorted(_ROUTES)})"
        ) from None
