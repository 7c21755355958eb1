"""Test configuration: run on CPU with 8 virtual devices so multi-card
sharding paths compile and execute without a GPU.  The platform is pinned
through jax.config as well as JAX_PLATFORMS, so a machine with a card still
runs this tier on the CPU; tests that need the card use the `gpu` fixture
of tests/test_chip_smoke.py."""

import os

# BEFORE importing jax (XLA worker threads inherit the creation-time
# rlimit): XLA:CPU's recursive passes overflow the default 8 MB stack on
# our largest protocol graphs -- a hard SIGSEGV.  And raise the kernel
# memory-map limit: XLA:CPU's map usage grows past the 65530 default
# mid-suite, which was the root cause of the rounds-3-5 aged-process
# crashes (see utils.raise_map_count_limit).
from plonky_tpu.utils import raise_map_count_limit, raise_stack_limit

raise_stack_limit()
raise_map_count_limit()

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import plonky_tpu  # noqa: E402
from plonky_tpu.utils import install_big_stack_compile  # noqa: E402

plonky_tpu.enable_compilation_cache()
install_big_stack_compile()
