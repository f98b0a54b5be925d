"""Test configuration: run JAX on CPU with x64 and 8 virtual devices.

The multi-device paths are validated on 8 virtual CPU devices
(xla_force_host_platform_device_count); GPU behaviour is covered by
chip_smoke.py and the tests marked ``gpu`` on the card.  The platform is
pinned through jax.config as well as the environment, in case jax was
imported before this file ran.  The persistent compile cache is
ninpol_tpu's (JAX_COMPILATION_CACHE_DIR, else <checkout>/.jax_cache).
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# -m smoke: a ~2-min-warm subset for cold-cache days —
# one oracle test per method, the topology/geometry invariants (pure
# NumPy, no jit), the face-pack layout pin and one public-API sharding
# test.  Exact nodeids so parametrized families don't all run.
_SMOKE_IDS = {
    "test_methods.py::test_idw_matches_oracle[tetra]",
    "test_methods.py::test_ls_matches_oracle[tetra]",
    "test_methods.py::test_gls_matches_oracle_mixed[tetra-3]",
    "test_methods.py::test_face_pack_layout",
    "test_sharding.py::test_public_api_sharded_matches_single_device[gls]",
}
_SMOKE_FILES = {"test_topology.py", "test_geometry.py", "test_native.py",
                "test_utils.py"}


def pytest_collection_modifyitems(config, items):
    for item in items:
        rel = item.nodeid.rsplit("tests/", 1)[-1]
        if rel in _SMOKE_IDS or rel.split("::", 1)[0] in _SMOKE_FILES:
            item.add_marker(pytest.mark.smoke)
