"""Which trainer program each regime runs, and the shared Adam sharding.

There is one trainer path per regime: a sharded-data minibatch whose batch
divides the 'data' axis runs the shard_map program (each shard draws its
own rows); every other in-memory fit runs the GSPMD program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.inference import vi as vi_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods
from bayesnf_tpu.parallel import mesh as mesh_lib


def _setup(n=96):
  config = field_lib.FieldConfig.create(
      width=8, depth=1, input_scales=[50.0, 1.0], fourier_degrees=[2, 2],
      interactions=[], seasonality_periods=[10.0], num_seasonal_harmonics=[2],
  )
  rng = np.random.default_rng(0)
  x = np.stack([np.arange(n, dtype=np.float32) % 50,
                rng.normal(size=n).astype(np.float32)], -1)
  y = (np.sin(x[:, 0] / 3) + x[:, 1]).astype(np.float32)
  return config, field_lib.aug_features_device(config, x), jnp.asarray(y)


def _recording(monkeypatch, module, names):
  """Wrap `module`'s program factories so each call records its name."""
  calls = []
  for name in names:
    real = getattr(module, name)

    def wrapper(*args, _real=real, _name=name, **kwargs):
      calls.append(_name)
      return _real(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapper)
  return calls


# (data devices, batch size, program): None is a full batch.
ROUTES = [
    (1, None, '_make_train_fn'),
    (1, 32, '_make_train_fn'),
    (2, None, '_make_train_fn'),
    (2, 32, '_make_shardmap_train_fn'),
    (2, 33, '_make_train_fn'),
]


@pytest.mark.parametrize('data_devices, batch_size, program', ROUTES)
def test_map_routing(monkeypatch, data_devices, batch_size, program):
  config, aug, y = _setup()
  calls = _recording(
      monkeypatch, map_lib, ('_make_train_fn', '_make_shardmap_train_fn')
  )
  _, losses = map_lib.ensemble_map(
      aug, y, config, likelihoods.LikelihoodDist.NORMAL, ensemble_size=4,
      learning_rate=0.01, num_epochs=2, seed=jax.random.PRNGKey(0),
      batch_size=batch_size,
      mesh=mesh_lib.default_mesh(data_devices=data_devices),
  )
  assert calls == [program]
  assert np.all(np.isfinite(np.asarray(losses)))


@pytest.mark.parametrize('data_devices, batch_size, program', [
    (d, b, p.replace('_train_fn', '_vi_fn')) for d, b, p in ROUTES
])
def test_vi_routing(monkeypatch, data_devices, batch_size, program):
  config, aug, y = _setup()
  calls = _recording(
      monkeypatch, vi_lib, ('_make_vi_fn', '_make_shardmap_vi_fn')
  )
  _, losses, _ = vi_lib.fit_vi(
      aug, y, jax.random.PRNGKey(0), 'NORMAL', config, ensemble_size=4,
      learning_rate=0.01, num_epochs=2, sample_size_divergence=2,
      sample_size_posterior=2, batch_size=batch_size,
      mesh=mesh_lib.default_mesh(data_devices=data_devices),
  )
  assert calls == [program]
  assert np.all(np.isfinite(np.asarray(losses)))


def test_streaming_always_runs_the_slice_program(monkeypatch):
  config, aug, y = _setup()
  calls = _recording(
      monkeypatch, map_lib,
      ('_make_train_fn', '_make_shardmap_train_fn', '_make_stream_train_fn'),
  )
  map_lib.ensemble_map(
      np.asarray(aug), np.asarray(y), config,
      likelihoods.LikelihoodDist.NORMAL, ensemble_size=2,
      learning_rate=0.01, num_epochs=1, seed=jax.random.PRNGKey(0),
      batch_size=16, stream_chunk_steps=4,
      mesh=mesh_lib.default_mesh(data_devices=2),
  )
  assert set(calls) == {'_make_stream_train_fn'}


@pytest.mark.parametrize('surrogate', [False, True])
def test_adam_state_spec_matches_adam_state(surrogate):
  """The trainers' sharding tree has exactly the Adam state's structure."""
  config, _, _ = _setup()
  params = tuple(
      jnp.zeros((1,) + s.shape) for s in field_lib.param_specs(config)
  )
  if surrogate:
    params = (params, params)
  state = optax.adam(0.01).init(params)
  spec = map_lib.adam_state_spec(config, 0.01, 'leaf', surrogate=surrogate)
  assert (jax.tree_util.tree_structure(spec)
          == jax.tree_util.tree_structure(
              jax.tree_util.tree_map(lambda _: 'leaf', state)))
  assert set(jax.tree_util.tree_leaves(spec)) == {'leaf'}
