"""Test configuration.

Tests run CPU-only on a virtual 8-device mesh so multi-device sharding
compiles and executes without accelerator hardware.  Must run before jax
is imported anywhere.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rs_ray_toy_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


# heavyweight end-to-end renders, kept out of the default tier
# (python -m pytest tests/ -q -m "not slow")
_SLOW_TESTS = {
    "test_sppm_runs",
    "test_sppm_statistically_matches_path",
    "test_golden_sphere_arealight_path",
    "test_golden_metal_path",
    "test_golden_plastic_path",
    "test_golden_halton_path",
    "test_sppm_sphere_interior_oracle",
    "test_spectral_render_end_to_end",
    "test_spectral_metal_render_differs_more",
    "test_spectral_volpath_grid_fog",
    "test_spectral_env_light_escape",
    "test_spectral_textured_matte",
    "test_spectral_bssrdf_render",
    "test_spectral_sppm_render",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight end-to-end render tests (slow tier)",
    )


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        if item.name.split("[", 1)[0] in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
