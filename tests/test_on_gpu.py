"""Checks that only mean something on the GPU (marked `gpu`)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


@pytest.mark.gpu
def test_default_matmul_precision_is_reduced_on_gpu(gpu_device):
  """JAX's default f32 dot on the GPU is not exact f32 (TF32 tensor cores):
  the documented gap between precision='f32' and 'highest'."""
  import jax
  import jax.numpy as jnp

  rng = np.random.default_rng(0)
  a = jnp.asarray(rng.normal(size=(512, 512)), jnp.float32)
  b = jnp.asarray(rng.normal(size=(512, 512)), jnp.float32)
  want = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
  with jax.default_matmul_precision('default'):
    fast = np.asarray(jax.jit(jnp.dot)(a, b))
  with jax.default_matmul_precision('highest'):
    exact = np.asarray(jax.jit(jnp.dot)(a, b))
  err = lambda got: np.linalg.norm(got - want) / np.linalg.norm(want)  # noqa: E731
  assert err(exact) < 1e-6
  assert 1e-5 < err(fast) < 1e-2


@pytest.mark.gpu
def test_chip_smoke_phases_at_small_size(gpu_device):
  import chip_smoke

  checks = chip_smoke.Checks()
  df, _ = chip_smoke.phase_map(
      checks, dict(air_rows=2048, air_sites=16, map_epochs=3), 0, gpu_device
  )
  chip_smoke.phase_stream(
      checks, dict(stream_epochs=1, stream_chunk_steps=4,
                   stream_chunk_rows=1024), 0, gpu_device, df,
  )
  assert checks.failed == []
