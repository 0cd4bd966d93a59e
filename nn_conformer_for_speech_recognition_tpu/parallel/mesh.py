"""Device mesh construction and sharding rules.

The reference is single-device (`lib/hparams.py:27`); this module supplies the
layer it lacks (SURVEY.md §2.3): a ``('data', 'model')`` mesh, NamedSharding
specs for batches and parameters, and multi-host init.  Parallelism is
GSPMD-style: annotate shardings, jit, and let XLA insert the collectives —
gradient psum falls out of the sharded batch axis, tensor-parallel
all-reduces out of the sharded FFN/attention weight axes.  On one host the
cards are joined all to all (NVLink), so the mesh follows the algorithm, not
a physical topology.

Parameter partitioning is rule-based on the param path + shape:
  * FFN/attention kernels with a dim divisible by the model axis are sharded
    on their largest weight axis (Megatron-style column/row split);
  * everything else is replicated.
With ``model_parallel_size=1`` this degrades to pure DP (all params
replicated, batch sharded over every chip).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from nn_conformer_for_speech_recognition_tpu.config import MeshConfig


def make_mesh(
    config: MeshConfig = MeshConfig(), devices: Optional[list] = None
) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    mp = config.model_parallel_size
    if n % mp != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel_size={mp}")
    dp = n // mp
    arr = np.asarray(devices).reshape(dp, mp)
    return Mesh(arr, (config.data_axis, config.model_axis))


def batch_sharding(mesh: Mesh, config: MeshConfig = MeshConfig()) -> NamedSharding:
    """Leading (batch) axis sharded over the data axis; rest replicated."""
    return NamedSharding(mesh, P(config.data_axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# param-path substrings that carry a shardable hidden dimension
_COLUMN_SHARD = ("ffn1", "ffn2", "qkv", "pos_proj")  # output dim sharded
_ROW_SHARD = ("out_proj",)  # input dim sharded


def _spec_for_param(path: str, shape: Tuple[int, ...], mp: int, model_axis: str):
    if mp <= 1 or len(shape) < 2:
        return P()
    lo = path.lower()
    if any(k in lo for k in _ROW_SHARD) and shape[0] % mp == 0:
        return P(*([model_axis] + [None] * (len(shape) - 1)))
    if any(k in lo for k in _COLUMN_SHARD) and shape[-1] % mp == 0:
        return P(*([None] * (len(shape) - 1) + [model_axis]))
    return P()


def param_shardings(
    mesh: Mesh, params: Any, config: MeshConfig = MeshConfig()
) -> Any:
    """PyTree of NamedShardings matching ``params``."""
    mp = config.model_parallel_size
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    treedef = jax.tree_util.tree_structure(params)
    specs = []
    for path, leaf in flat:
        pstr = "/".join(str(k) for k in path)
        specs.append(
            NamedSharding(
                mesh, _spec_for_param(pstr, getattr(leaf, "shape", ()), mp, config.model_axis)
            )
        )
    return jax.tree_util.tree_unflatten(treedef, specs)


def shard_params(mesh: Mesh, params: Any, config: MeshConfig = MeshConfig()) -> Any:
    if jax.process_count() > 1:
        # multi-process: leaves coming out of a local `jit(model.init)` are
        # committed to one local device; device_put to a global (partly
        # non-addressable) sharding needs host values, which every process
        # holds identically (same seed, same shapes)
        params = jax.tree.map(np.asarray, params)
    return jax.device_put(params, param_shardings(mesh, params, config))


def shard_batch_arrays(mesh: Mesh, config: MeshConfig, *arrays):
    """Place host arrays with the batch axis sharded over 'data'."""
    sh = batch_sharding(mesh, config)
    return tuple(jax.device_put(a, sh) for a in arrays)


def initialize_multihost(coordinator: Optional[str] = None) -> None:
    """Multi-host init (no-op single-process).  Call before any jax op, with
    the coordinator's ``host:port``."""
    if jax.process_count() > 1 or coordinator:
        jax.distributed.initialize(coordinator_address=coordinator)
