"""Test configuration: force an 8-device virtual CPU mesh.

The reference's CI never exercised its multi-device path (single CPU device).
Here every test runs against 8 virtual CPU devices so the sharded ensemble
path is what is actually tested.
"""

import os

import sys

# The suite runs on a deterministic 8-device virtual CPU mesh.
# Exception: BNF_TEST_PLATFORM=gpu keeps the attached GPU (fewer devices —
# mesh-shape tests shrink) so the tests marked `gpu` can run, and the rest
# exercise the compiled GPU programs. In GPU mode the default matmul
# precision is pinned to 'highest': the numeric-oracle tests compare
# programs at exact-f32 tolerances, and the GPU's default f32 dot may run
# as TF32.
_TEST_PLATFORM = os.environ.get('BNF_TEST_PLATFORM', 'cpu')
if _TEST_PLATFORM == 'cpu':
  os.environ['JAX_PLATFORMS'] = 'cpu'
  flags = os.environ.get('XLA_FLAGS', '')
  if 'xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (
        flags + ' --xla_force_host_platform_device_count=8'
    ).strip()
else:
  os.environ.setdefault('JAX_DEFAULT_MATMUL_PRECISION', 'highest')

# Persist compiled programs across suite runs: the suite is
# compile-dominated (hundreds of distinct programs, >1 s each), and the
# topology (8 virtual CPU devices) is fixed here so cache keys are stable.
# A warm cache roughly halves suite wall-clock. Opt out by setting the
# var to the empty string.
if 'JAX_COMPILATION_CACHE_DIR' not in os.environ:
  os.environ['JAX_COMPILATION_CACHE_DIR'] = os.path.join(
      os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
      '.pytest_jax_cache',
  )

# Pytest plugins (e.g. jaxtyping) may import jax before this conftest runs,
# at which point jax has already bound jax_platforms from the environment —
# override it through the config API too.
if 'jax' in sys.modules:
  import jax

  if _TEST_PLATFORM == 'cpu':
    jax.config.update('jax_platforms', 'cpu')
  else:
    jax.config.update('jax_default_matmul_precision', 'highest')

import pytest


@pytest.fixture(autouse=True, scope='module')
def _clear_jax_caches_between_modules():
  """Drop compiled executables after each test module.

  The full suite compiles hundreds of distinct programs into one process;
  on jax 0.9 the XLA:CPU JIT has been observed to segfault inside
  `backend_compile_and_load` only after ~200 in-process compilations
  (every module passes in isolation). Bounding the live-executable count
  keeps the process inside the regime that works. Modules rarely share
  program shapes, so the lost cache hits are negligible.
  """
  yield
  import jax

  jax.clear_caches()


@pytest.fixture
def gpu_device():
  """The attached GPU, for tests marked `gpu`; skips without one.

  Decided here, at test time, never while modules are collected: every
  pytest-xdist worker must collect the same tests.
  """
  import jax

  device = jax.devices()[0]
  if device.platform != 'gpu':
    pytest.skip(
        'needs an NVIDIA GPU: BNF_TEST_PLATFORM=gpu python -m pytest -m gpu '
        'tests/ on a GPU host'
    )
  return device
