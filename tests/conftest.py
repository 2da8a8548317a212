"""Test harness config: the CPU backend with 8 virtual devices.

The default suite runs on the CPU, where a virtual 8-device mesh stands
in for several cards so the sharded paths are tested anywhere
(__graft_entry__.dryrun_multichip dry-runs the same way).  Tests marked `gpu` need the card: chip_smoke.py runs them with
PLUTO_TEST_GPU=1, which leaves JAX its default (GPU) backend.  The
collected tests are the same either way; test_gpu_compiled.py decides
inside a fixture whether a card is there."""

import os

if os.environ.get("PLUTO_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402

import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))

# host math runs f64-exact on the CPU; tests write no compile cache
# (the CLI under test points one at the checkout)
import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

from fixtures import ensure_fixtures  # noqa: E402


@pytest.fixture(scope="session")
def fixture_paths():
    return ensure_fixtures()


@pytest.fixture(scope="session")
def oracle_exe(tmp_path_factory):
    """Reference simulator compiled against stub iio/curl libs."""
    from ref_harness import harness
    if not harness.reference_available():
        pytest.skip("reference source not mounted")
    out = tmp_path_factory.mktemp("oracle")
    return harness.build_oracle(str(out))
