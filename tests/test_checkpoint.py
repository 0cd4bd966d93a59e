"""train/checkpoint.py: the numpy checkpoint format round trip."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nn_conformer_for_speech_recognition_tpu.train import checkpoint as ckpt
from nn_conformer_for_speech_recognition_tpu.train.optim import make_optimizer
from nn_conformer_for_speech_recognition_tpu.train.state import TrainState
from nn_conformer_for_speech_recognition_tpu.config import OptimizerConfig


def _state(seed, scale=1.0):
    r = np.random.default_rng(seed)
    params = {
        "encoder": {"block_0": {"kernel": jnp.asarray(r.standard_normal((4, 3)) * scale,
                                                      jnp.float32)}},
        "subsampling": {"bias": jnp.asarray(r.standard_normal(3), jnp.float32)},
        "final_fc": {"kernel": jnp.asarray(r.standard_normal((3, 2)), jnp.float32)},
    }
    st = TrainState.create(params, {"bn": {"mean": jnp.zeros(3)}},
                           make_optimizer(OptimizerConfig()), jax.random.key(seed))
    grads = jax.tree.map(jnp.ones_like, params)
    return st.apply_gradients(grads, {"bn": {"mean": jnp.full(3, seed, jnp.float32)}},
                              jax.random.key(seed + 100))


def _assert_same(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if jnp.issubdtype(getattr(x, "dtype", None), jax.dtypes.prng_key):
            x, y = jax.random.key_data(x), jax.random.key_data(y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_full_state_round_trip(tmp_path):
    st = _state(1)
    path = str(tmp_path / "ck")
    ckpt.save_state(path, st, iterator={"epoch": 3, "step": 7})
    got, it = ckpt.restore_state(path, _state(2), with_iterator=True)
    _assert_same(got, st)
    assert it == {"epoch": 3, "step": 7}
    assert int(got.step) == 1
    # no iterator cursor saved → None
    ckpt.save_state(path, st)
    assert ckpt.restore_state(path, _state(2), with_iterator=True)[1] is None


def test_overwrite_is_atomic_and_leaves_no_temporaries(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save_state(path, _state(1))
    ckpt.save_state(path, _state(3))
    _assert_same(ckpt.restore_state(path, _state(2)), _state(3))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert os.listdir(path) == ["state.npz"]


def test_restore_rejects_a_mismatched_template(tmp_path):
    path = str(tmp_path / "ck")
    ckpt.save_state(path, _state(1))
    bad = _state(2).replace(params={**_state(2).params,
                                    "final_fc": {"kernel": jnp.zeros((5, 2))}})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_state(path, bad)


def test_encoder_only_restore_and_manager_rotation(tmp_path):
    src = _state(1)
    path = str(tmp_path / "ck")
    ckpt.save_state(path, src)
    tpl = _state(2, scale=10.0).params
    got = ckpt.restore_encoder_params(path, tpl)
    _assert_same(got["encoder"], src.params["encoder"])
    _assert_same(got["subsampling"], src.params["subsampling"])
    _assert_same(got["final_fc"], tpl["final_fc"])

    mgr = ckpt.CheckpointManager(str(tmp_path / "run"), keep=2)
    st = _state(1)
    for i, metric in enumerate([3.0, 1.0, 2.0]):
        st = st.replace(step=jnp.asarray(i + 1, jnp.int32))
        mgr.save(st, metric=metric, iterator={"epoch": i, "step": 0})
    names = sorted(os.listdir(mgr.directory))
    assert names == ["best", "step_00000002", "step_00000003"]
    assert int(ckpt.restore_state(os.path.join(mgr.directory, "best"), st).step) == 2
    latest, it = mgr.restore_latest_with_iterator(st)
    assert int(latest.step) == 3 and it == {"epoch": 2, "step": 0}
