"""Test harness: run everything on an emulated 8-device CPU mesh.

The standard JAX trick (SURVEY.md §4): split the host platform into 8 virtual
devices so jit/shard_map/NamedSharding code paths run as they would on a
multi-device host.  The CPU is pinned with ``jax.config.update`` (it works
until the backend is first touched), and XLA_FLAGS is read at backend init —
both still unset at conftest import time.  Tests marked ``gpu`` never touch
JAX here: they check for a card in a fixture and run `chip_smoke.py` in a
child process.
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
