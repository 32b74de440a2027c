"""Test configuration: force an 8-device virtual CPU mesh before JAX loads.

The tests run on the CPU; sharding tests run on
``xla_force_host_platform_device_count=8`` virtual devices. GPU runs go
through ``chip_smoke.py`` (see README).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# A machine with a GPU would otherwise hand the tests to it.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def synthetic_dataset(tmp_path_factory):
    """A small synthetic 'av2'-style dataset shared across the session."""
    from himo_tpu.data.synthetic import make_dataset

    root = tmp_path_factory.mktemp("data") / "av2_demo"
    make_dataset(
        root,
        num_scenes=2,
        num_frames=4,
        seed=0,
        method_flows=("perfect", "noisy"),
        method_noise=0.05,
    )
    return root


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
