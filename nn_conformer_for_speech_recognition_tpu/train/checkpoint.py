"""Checkpointing: the full TrainState as one ``.npz`` file per checkpoint.

The reference saves only final weights with ``torch.save(state_dict)`` to
fixed paths (`lib/standard/runner.py:48-60`) — no optimizer state, no resume.
Here the full TrainState (params, batch stats, Adafactor state, step, PRNG,
data-iterator cursor) round-trips, enabling exact resume mid-NST-generation
(SURVEY.md §5), and a selective encoder-only restore mirrors the reference's
'conformer'-filtered partial load (`runner.py:61-77`).

A checkpoint is a directory holding ``state.npz``: every leaf under its
'/'-joined tree path.  It is written into a temporary directory beside the
target and renamed into place, so a reader never sees a partial checkpoint.
In a multi-process run every leaf is gathered to the host and process 0
writes.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from nn_conformer_for_speech_recognition_tpu.train.state import TrainState

_FILE = "state.npz"


def _key_str(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported tree key {k!r}")


def _flatten(tree) -> Dict[str, Any]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key_str(k) for k in path): leaf for path, leaf in flat}


def _to_save(state: TrainState, iterator=None):
    return {
        "step": state.step,
        "params": state.params,
        "batch_stats": state.batch_stats,
        "opt_state": state.opt_state,
        "rng": jax.random.key_data(state.rng),
        # data-iterator position (SURVEY.md §5 full train-state): the epoch
        # stream is deterministic given (seed, epoch), so (epoch, step) is a
        # complete cursor — resume skips `step` batches of epoch `epoch`.
        "iterator": {
            "epoch": (iterator or {}).get("epoch", -1),
            "step": (iterator or {}).get("step", 0),
        },
    }


def _host(x) -> np.ndarray:
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        x = multihost_utils.process_allgather(x, tiled=True)
    a = np.asarray(x)
    if a.dtype.type.__module__ != "numpy":  # e.g. bfloat16: npz stores numpy dtypes
        a = a.astype(np.float32)
    return a


def save_state(path: str, state: TrainState, iterator=None) -> None:
    """Write ``state`` (and the iterator cursor) to directory ``path``,
    replacing any checkpoint already there."""
    path = os.path.abspath(path)
    arrays = {k: _host(v) for k, v in _flatten(_to_save(state, iterator)).items()}
    if jax.process_index() != 0:
        return
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=f".{os.path.basename(path)}.")
    try:
        with open(os.path.join(tmp, _FILE), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        old = None
        if os.path.exists(path):
            old = tmp + ".old"
            os.rename(path, old)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _load(path: str) -> Dict[str, np.ndarray]:
    with np.load(os.path.join(os.path.abspath(path), _FILE), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def restore_state(path: str, template: TrainState, with_iterator: bool = False):
    """Restore a checkpoint into the structure, dtypes and shardings of
    ``template``."""
    saved = _load(path)

    def fill(prefix, tree):
        flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
        leaves = []
        for kp, t in flat:
            key = "/".join([prefix] + [_key_str(k) for k in kp])
            if key not in saved:
                raise KeyError(f"checkpoint {path} has no {key!r}")
            r = saved[key].astype(jnp.result_type(t))
            if np.shape(r) != np.shape(t):
                raise ValueError(f"{key}: checkpoint shape {r.shape} != {np.shape(t)}")
            leaves.append(_place(r, t))
        return jax.tree_util.tree_unflatten(treedef, leaves)

    state = template.replace(
        step=_place(saved["step"].astype(np.int32), template.step),
        params=fill("params", template.params),
        batch_stats=fill("batch_stats", template.batch_stats),
        opt_state=fill("opt_state", template.opt_state),
        # wrap from HOST data: a device-committed key would be pinned to one
        # device, conflicting with mesh-placed params
        rng=jax.random.wrap_key_data(jnp.asarray(saved["rng"])),
    )
    if with_iterator:
        it = {"epoch": int(saved["iterator/epoch"]), "step": int(saved["iterator/step"])}
        return state, (it if it["epoch"] >= 0 else None)
    return state


def _place(r: np.ndarray, t):
    """Leaves whose template carries a mesh sharding go back onto it; the
    rest stay host arrays, which jit places like fresh inputs."""
    from jax.sharding import NamedSharding

    if isinstance(t, jax.Array) and isinstance(t.sharding, NamedSharding):
        return jax.device_put(r, t.sharding)
    return r


def restore_encoder_params(path: str, template_params: Any) -> Any:
    """Restore only encoder/subsampling params, keep the rest (decoder/head)
    from ``template_params`` — the 'load pretrained conformer' path."""
    saved = _load(path)

    def merge(tpl, prefix):
        out = {}
        for k, v in tpl.items():
            key = f"{prefix}/{k}"
            if isinstance(v, dict):
                out[k] = merge(v, key)
            elif ("encoder" in prefix or "subsampling" in prefix) and key in saved:
                out[k] = saved[key].astype(v.dtype)
            else:
                out[k] = v
        return out

    return merge(template_params, "params")


class CheckpointManager:
    """Rotating checkpoint manager: keeps the newest ``keep`` checkpoints
    (plus an optional 'best' by metric), the durable-training layer the
    reference's fixed-path ``torch.save`` lacks (`runner.py:48-60`)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric: float | None = None

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append((int(name.split("_")[1]), name))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, state: TrainState, metric: float | None = None,
             iterator: dict | None = None) -> str:
        step = int(state.step)
        path = os.path.join(self.directory, f"step_{step:08d}")
        save_state(path, state, iterator=iterator)
        if metric is not None and (self.best_metric is None or metric < self.best_metric):
            self.best_metric = metric
            save_state(os.path.join(self.directory, "best"), state, iterator=iterator)
        dirs = self._step_dirs()
        while len(dirs) > self.keep:
            _, name = dirs.pop(0)
            shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        return path

    def latest(self) -> str | None:
        dirs = self._step_dirs()
        return os.path.join(self.directory, dirs[-1][1]) if dirs else None

    def restore_latest(self, template: TrainState) -> TrainState | None:
        path = self.latest()
        return restore_state(path, template) if path else None

    def restore_latest_with_iterator(self, template: TrainState):
        """(state, iterator|None) of the newest checkpoint, or (None, None).
        ``iterator`` = {"epoch", "step"} when the save was mid-epoch."""
        path = self.latest()
        if not path:
            return None, None
        return restore_state(path, template, with_iterator=True)
