"""Conformer ASR + Noisy Student Training framework in JAX.

Built from scratch with the capability surface of
`icadriani/nn_conformer_for_speech_recognition` (see SURVEY.md).
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache: where JAX_COMPILATION_CACHE_DIR says if
# it is set (JAX reads it itself), otherwise <checkout>/.jax_cache.  The
# directory is part of the cache key, so it is a fixed path.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
                      ".jax_cache"),
    )
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from nn_conformer_for_speech_recognition_tpu import config  # noqa: F401,E402
