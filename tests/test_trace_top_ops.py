"""The trace-to-metrics reduction kept with the benchmark."""

import glob
import os

import jax
import jax.numpy as jnp
import pytest

from tools.trace_top_ops import busy_time, summarize


def test_busy_time_is_the_union_of_intervals():
    assert busy_time([]) == 0.0
    assert busy_time([(0, 10), (5, 15), (20, 30)]) == 25.0
    assert busy_time([(20, 30), (0, 40)]) == 40.0


def test_summarize_a_recorded_trace(tmp_path):
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    (path,) = glob.glob(os.path.join(tmp_path, "**", "*.xplane.pb"),
                        recursive=True)
    out = summarize(path, plane_prefix="/host:CPU", top=3)
    assert 0.0 <= out["traced_idle_share"] <= 1.0
    assert 0 < len(out["top_ops"]) <= 3
    times = [op["total_ms"] for op in out["top_ops"]]
    assert times == sorted(times, reverse=True)
    with pytest.raises(ValueError, match="no events"):
        summarize(path, plane_prefix="/device:GPU")
