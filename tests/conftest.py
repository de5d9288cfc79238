"""Test config: run everything on a virtual 8-device CPU mesh.

The tests run on the CPU; sharded code paths are validated on
``--xla_force_host_platform_device_count=8`` exactly as SURVEY.md §4 plans
(the reference has no distributed path to mirror; this is the framework's
own multi-"node" test strategy).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# deterministic simulated-stream fixtures cache to disk inside the checkout
# (keyed by source hashes — see simulate.cache_streams); warm suite runs
# skip ~60 s of pure numpy ray-casting
os.environ.setdefault(
    "SIMPLESLAM_SIM_CACHE",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 ".sim_cache"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _reset_singletons():
    from simpleslam_tpu.utils.config import Params
    from simpleslam_tpu.utils.logging import Logger

    Params.reset()
    yield
    Params.reset()
    Logger.reset()
