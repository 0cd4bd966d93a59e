"""Tracing/profiling — the subsystem the reference lacks entirely
(SURVEY.md §5: only tqdm progress bars, `lib/standard/runner.py:127-172`).

Wraps ``jax.profiler``: a trace context manager (TensorBoard-viewable), a
trace server for live capture, and a StepTimer that separates host data-wait
from device compute and reports the north-star audio-seconds/s metric.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profiler trace: ``with trace('/tmp/tb'): run_steps()`` then
    inspect in TensorBoard (or xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def start_server(port: int = 9999):
    """Live capture endpoint for `tensorboard --logdir` remote profiling."""
    return jax.profiler.start_server(port)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible on the trace timeline."""
    with jax.profiler.TraceAnnotation(name):
        yield


class StepTimer:
    """Per-step wall-clock accounting: data-wait vs. step-dispatch+compute.

    Caveat: dispatch is async, so ``compute_s`` for an *individual* step
    is dispatch time unless the step ends with ``block_until_ready``.  The
    AGGREGATE over an epoch is trustworthy whenever the loop ends with a
    value fetch (the Trainer pulls losses per epoch) — queued device work
    must finish before the fetched value exists.

    Usage::

        timer = StepTimer(sample_rate=16000)
        for batch in ds.epoch():
            timer.data_ready()
            state, metrics = step(state, *args)
            timer.step_done(batch_audio_samples)
        print(timer.summary())
    """

    def __init__(self, sample_rate: int = 16000):
        self.sample_rate = sample_rate
        self.reset()

    def reset(self) -> None:
        self._last = time.perf_counter()
        self.data_s = 0.0
        self.compute_s = 0.0
        self.audio_samples = 0
        self.steps = 0

    def data_ready(self) -> None:
        now = time.perf_counter()
        self.data_s += now - self._last
        self._last = now

    def step_done(self, audio_samples: int) -> None:
        now = time.perf_counter()
        self.compute_s += now - self._last
        self._last = now
        self.audio_samples += int(audio_samples)
        self.steps += 1

    @property
    def audio_seconds_per_second(self) -> float:
        total = self.data_s + self.compute_s
        return (self.audio_samples / self.sample_rate) / max(total, 1e-9)

    def summary(self) -> Dict[str, float]:
        total = self.data_s + self.compute_s
        return {
            "steps": self.steps,
            "data_wait_s": round(self.data_s, 3),
            "compute_s": round(self.compute_s, 3),
            "data_wait_frac": round(self.data_s / max(total, 1e-9), 3),
            "audio_seconds_per_second": round(self.audio_seconds_per_second, 1),
        }
