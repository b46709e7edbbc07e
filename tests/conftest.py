"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

The sharding tests exercise the multi-device code paths on a virtual
8-device CPU mesh (the reference's single-process test scripts,
``Test/nddwt1D_test.m`` etc., extended with the multi-device tier the
reference never had).
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(12345)
