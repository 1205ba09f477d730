"""Scale-out rehearsal: the BASELINE 'config 5' shape on the virtual mesh.

Exercises, end to end on the 8-device CPU mesh, the combination a
multi-host precipitation-style run would use: multihost-layout ('ens' x
'data') mesh, ensemble sharded over the (cross-host) leading axis, rows
sharded within the
data group, minibatch SGD with per-member reshuffling, chunked gradient
accumulation, and periodic checkpointing with bit-exact resume.
"""

import numpy as np
import jax
import jax.numpy as jnp

from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods
from bayesnf_tpu.parallel import distributed


def test_config5_rehearsal(tmp_path):
  config = field_lib.FieldConfig.create(
      width=16, depth=2, input_scales=[200.0, 1.0, 1.0],
      fourier_degrees=[4, 3, 3], interactions=[(1, 2)],
      seasonality_periods=[12.0], num_seasonal_harmonics=[4],
  )
  rng = np.random.default_rng(0)
  n = 400
  t = np.arange(n, dtype=np.float32) % 200
  space = rng.normal(size=(n, 2)).astype(np.float32)
  x = jnp.asarray(np.concatenate([t[:, None], space], -1))
  y = jnp.asarray(
      (np.sin(2 * np.pi * t / 12) * 2 + space[:, 0]).astype(np.float32)
  )
  aug = jnp.concatenate([x, field_lib.seasonal_features_for(config, x)], -1)

  # Host-major mesh: 4 ensemble groups x 2-way data sharding per group.
  mesh = distributed.multihost_mesh(data_devices_per_host=2)
  assert mesh.shape == {'ens': 4, 'data': 2}

  common = dict(
      aug_features=aug, target=y, config=config,
      distribution=likelihoods.LikelihoodDist.NORMAL,
      ensemble_size=16, learning_rate=0.01, num_epochs=12,
      seed=jax.random.PRNGKey(0), batch_size=128, mesh=mesh,
  )
  params_ref, losses_ref = map_lib.ensemble_map(**common)
  losses_ref = np.asarray(losses_ref)
  assert losses_ref.shape == (16, 12)
  assert np.all(np.isfinite(losses_ref))
  assert losses_ref[:, -1].mean() < losses_ref[:, 0].mean()

  # Checkpointed run on the same mesh must match exactly.
  params_ck, losses_ck = map_lib.ensemble_map(
      checkpoint_dir=str(tmp_path / 'c5'), checkpoint_every=5, **common
  )
  np.testing.assert_array_equal(losses_ref, np.asarray(losses_ck))
  for a, b in zip(params_ref, params_ck):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
