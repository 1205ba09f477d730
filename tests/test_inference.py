"""Trainer and predictor integration tests (fast CPU configs)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.inference import predict as predict_lib
from bayesnf_tpu.inference import vi as vi_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods
from bayesnf_tpu.parallel import mesh as mesh_lib
from bayesnf_tpu.parallel import minibatch as minibatch_lib


def _small_config(width=8, depth=1):
  return field_lib.FieldConfig.create(
      width=width,
      depth=depth,
      input_scales=[50.0, 1.0],
      fourier_degrees=[3, 2],
      interactions=[],
      seasonality_periods=[10.0],
      num_seasonal_harmonics=[2],
  )


def _small_data(n=120, seed=0):
  rng = np.random.default_rng(seed)
  t = np.arange(n, dtype=np.float32) % 50
  s = rng.normal(size=n).astype(np.float32)
  x = np.stack([t, s], -1)
  y = (np.sin(2 * np.pi * t / 10) * 3 + s + 0.1 * rng.normal(size=n)).astype(
      np.float32
  )
  return x, y


def _aug(config, x):
  x = jnp.asarray(x)
  return jnp.concatenate(
      [x, field_lib.seasonal_features_for(config, x)], axis=-1
  )


class TestEnsembleMap:

  def test_loss_decreases_and_shapes(self):
    config = _small_config()
    x, y = _small_data()
    params, losses = map_lib.ensemble_map(
        _aug(config, x),
        y,
        config,
        likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=8,
        learning_rate=0.01,
        num_epochs=60,
        seed=jax.random.PRNGKey(0),
    )
    assert losses.shape == (8, 60)
    losses = np.asarray(losses)
    assert np.all(np.isfinite(losses))
    assert np.all(losses[:, -1] < losses[:, 0])
    specs = field_lib.param_specs(config)
    for spec, p in zip(specs, params):
      assert p.shape == (8,) + spec.shape

  def test_deterministic_same_seed(self):
    config = _small_config()
    x, y = _small_data()
    run = lambda: map_lib.ensemble_map(
        _aug(config, x), y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=4, learning_rate=0.01, num_epochs=10,
        seed=jax.random.PRNGKey(7),
    )
    p1, l1 = run()
    p2, l2 = run()
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
    for a, b in zip(p1, p2):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

  def test_minibatch_path(self):
    config = _small_config()
    x, y = _small_data()
    params, losses = map_lib.ensemble_map(
        _aug(config, x), y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=2, learning_rate=0.01, num_epochs=30,
        seed=jax.random.PRNGKey(1), batch_size=32,
    )
    losses = np.asarray(losses)
    assert np.all(np.isfinite(losses))
    assert losses[:, -1].mean() < losses[:, 0].mean()

  def test_ensemble_smaller_than_devices(self):
    # Reference issue #28: errors when ensemble < device count. We pad.
    config = _small_config()
    x, y = _small_data()
    params, losses = map_lib.ensemble_map(
        _aug(config, x), y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=3, learning_rate=0.01, num_epochs=5,
        seed=jax.random.PRNGKey(1),
    )
    assert losses.shape == (3, 5)
    assert params[0].shape[0] == 3

  def test_num_splits_concatenates(self):
    config = _small_config()
    x, y = _small_data()
    params, losses = map_lib.fit_map(
        _aug(config, x), y, jax.random.PRNGKey(0), 'NORMAL', config,
        num_particles=8, learning_rate=0.01, num_epochs=5, num_splits=2,
    )
    assert losses.shape == (8, 5)
    assert params[0].shape[0] == 8
    # Splits use folded seeds => different members.
    assert not np.allclose(losses[:4], losses[4:])

  def test_mle_is_prior_free(self):
    config = _small_config()
    x, y = _small_data()
    common = dict(
        aug_features=_aug(config, x), target=y, config=config,
        distribution=likelihoods.LikelihoodDist.NORMAL, ensemble_size=2,
        learning_rate=0.01, num_epochs=5, seed=jax.random.PRNGKey(0),
    )
    _, l_map = map_lib.ensemble_map(prior_weight=1.0, **common)
    _, l_mle = map_lib.ensemble_map(prior_weight=0.0, **common)
    # MAP loss includes the prior term: strictly larger in magnitude.
    assert np.asarray(l_map)[0, 0] > np.asarray(l_mle)[0, 0]

  def test_explicit_data_mesh(self):
    config = _small_config()
    x, y = _small_data(n=128)
    mesh = mesh_lib.default_mesh(data_devices=2)
    params, losses = map_lib.ensemble_map(
        _aug(config, x), y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=4, learning_rate=0.01, num_epochs=10,
        seed=jax.random.PRNGKey(3), mesh=mesh,
    )
    assert np.all(np.isfinite(np.asarray(losses)))
    # Same run on the default (ens-only) mesh: numerically very close
    # (reduction order may differ across data shards).
    params2, losses2 = map_lib.ensemble_map(
        _aug(config, x), y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=4, learning_rate=0.01, num_epochs=10,
        seed=jax.random.PRNGKey(3),
    )
    np.testing.assert_allclose(
        np.asarray(losses), np.asarray(losses2), rtol=1e-3, atol=1e-3
    )


class TestEnsembleVI:

  def test_loss_decreases_and_outputs(self):
    config = _small_config()
    x, y = _small_data()
    surrogate, losses, draws = vi_lib.fit_vi(
        _aug(config, x), y, jax.random.PRNGKey(0), 'NORMAL', config,
        ensemble_size=3, learning_rate=0.02, num_epochs=60,
        sample_size_divergence=3, sample_size_posterior=7, kl_weight=0.2,
    )
    losses = np.asarray(losses)
    assert losses.shape == (3, 60)
    assert np.all(np.isfinite(losses))
    assert losses[:, -1].mean() < losses[:, 0].mean()
    specs = field_lib.param_specs(config)
    for spec, p in zip(specs, draws):
      assert p.shape == (3, 7) + spec.shape
    locs, raw_scales = surrogate
    assert locs[0].shape == (3,)

  def test_minibatch_vi(self):
    config = _small_config()
    x, y = _small_data()
    _, losses, _ = vi_lib.fit_vi(
        _aug(config, x), y, jax.random.PRNGKey(0), 'NORMAL', config,
        ensemble_size=2, learning_rate=0.02, num_epochs=40,
        batch_size=40, kl_weight=0.1,
    )
    assert np.all(np.isfinite(np.asarray(losses)))


class TestPredict:

  def _fit(self, config, x, y, e=4):
    params, _ = map_lib.ensemble_map(
        _aug(config, x), y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=e, learning_rate=0.01, num_epochs=40,
        seed=jax.random.PRNGKey(0),
    )
    # Public 2-dim ensemble shape.
    return tuple(np.asarray(p).reshape((2, e // 2) + p.shape[1:]) for p in params)

  def test_chunking_invariance(self):
    config = _small_config()
    x, y = _small_data(n=100)
    params = self._fit(config, x, y)
    m1, q1 = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.5,), ensemble_dims=2, chunk_size=16
    )
    m2, q2 = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.5,), ensemble_dims=2, chunk_size=1024
    )
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(q1[0]), np.asarray(q2[0]), rtol=1e-4, atol=1e-4
    )

  def test_shapes_and_quantile_order(self):
    config = _small_config()
    x, y = _small_data(n=90)
    params = self._fit(config, x, y)
    means, quants = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.5, 0.025, 0.975), ensemble_dims=2
    )
    assert means.shape == (2, 2, 90)
    q50, qlo, qhi = (np.asarray(q) for q in quants)
    assert q50.shape == (90,)
    assert np.all(qlo <= q50) and np.all(q50 <= qhi)

  def test_mesh_row_parallel_matches_single_program(self):
    """predict_bnf(mesh=...) shards chunk rows over all devices — same
    numbers as the meshless program (N=90 also exercises uneven pad)."""
    config = _small_config()
    x, y = _small_data(n=90)
    params = self._fit(config, x, y)
    m1, q1 = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.5, 0.975), ensemble_dims=2,
        chunk_size=32,
    )
    for mesh in (mesh_lib.default_mesh(), mesh_lib.default_mesh(data_devices=4)):
      m2, q2 = predict_lib.predict_bnf(
          x, 'NORMAL', params, config, (0.5, 0.975), ensemble_dims=2,
          chunk_size=32, mesh=mesh,
      )
      np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-6)
      for a, b in zip(q1, q2):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
        )

  def test_mesh_row_parallel_matches_single_program_nb(self):
    """Count-likelihood predict (integer quantile root-find) over a mesh
    matches the meshless program too."""
    config = _small_config()
    x, y = _small_data(n=70)
    y_nb = np.round(np.exp(np.asarray(y) / 4.0)).astype(np.float32)
    params, _ = map_lib.ensemble_map(
        _aug(config, x), jnp.asarray(y_nb), config,
        likelihoods.LikelihoodDist.NB,
        ensemble_size=4, learning_rate=0.01, num_epochs=30,
        seed=jax.random.PRNGKey(0),
    )
    params = tuple(
        np.asarray(p).reshape((2, 2) + p.shape[1:]) for p in params
    )
    m1, q1 = predict_lib.predict_bnf(
        x, 'NB', params, config, (0.5, 0.9), ensemble_dims=2, chunk_size=32,
    )
    m2, q2 = predict_lib.predict_bnf(
        x, 'NB', params, config, (0.5, 0.9), ensemble_dims=2, chunk_size=32,
        mesh=mesh_lib.default_mesh(data_devices=2),
    )
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-6)
    for a, b in zip(q1, q2):
      # Integer-valued quantiles: must match exactly.
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

  def test_mesh_zinb_matches_single_program(self):
    """ZINB predict over an ('ens' x 'data') mesh: means match and the
    integer quantiles are identical to the meshless program (N=70 pads
    the row shards)."""
    config = _small_config()
    x, _ = _small_data(n=70)
    y = np.random.default_rng(3).poisson(3.0, size=70).astype(np.float32)
    y[::7] = 0.0
    params, _ = map_lib.ensemble_map(
        _aug(config, x), jnp.asarray(y), config,
        likelihoods.LikelihoodDist.ZINB,
        ensemble_size=4, learning_rate=0.01, num_epochs=20,
        seed=jax.random.PRNGKey(0),
    )
    params = tuple(p[jnp.newaxis] for p in params)
    m1, q1 = predict_lib.predict_bnf(
        x, 'ZINB', params, config, (0.5, 0.9), ensemble_dims=2,
        chunk_size=32,
    )
    m2, q2 = predict_lib.predict_bnf(
        x, 'ZINB', params, config, (0.5, 0.9), ensemble_dims=2,
        chunk_size=32, mesh=mesh_lib.default_mesh(data_devices=2),
    )
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-6)
    for a, b in zip(q1, q2):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

  def test_mesh_vi_draws_match_single_program(self):
    """The VI public layout (groups x samples x members, ensemble_dims=3)
    over a mesh matches the meshless program."""
    config = _small_config()
    x, y = _small_data(n=90)
    _, _, draws = vi_lib.fit_vi(
        _aug(config, x), y, jax.random.PRNGKey(0), 'NORMAL', config,
        ensemble_size=4, learning_rate=0.02, num_epochs=10,
        sample_size_divergence=2, sample_size_posterior=3,
    )
    params = tuple(np.asarray(d)[np.newaxis] for d in draws)  # (1, 4, 3, ..)
    m1, q1 = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.5, 0.975), ensemble_dims=3,
        chunk_size=32,
    )
    m2, q2 = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.5, 0.975), ensemble_dims=3,
        chunk_size=32, mesh=mesh_lib.default_mesh(data_devices=4),
    )
    assert np.asarray(m2).shape == (1, 4, 3, 90)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-6)
    for a, b in zip(q1, q2):
      np.testing.assert_allclose(
          np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
      )

  def test_approximate_close_to_exact(self):
    config = _small_config()
    x, y = _small_data(n=80)
    params = self._fit(config, x, y)
    _, exact = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.9,), ensemble_dims=2
    )
    _, approx = predict_lib.predict_bnf(
        x, 'NORMAL', params, config, (0.9,), ensemble_dims=2,
        approximate_quantiles=True,
    )
    # Trained members agree closely => mixture ~ Normal => paths agree.
    np.testing.assert_allclose(
        np.asarray(exact[0]), np.asarray(approx[0]), rtol=0.15, atol=0.3
    )


def _count_data(n=96, seed=5):
  rng = np.random.default_rng(seed)
  t = np.arange(n, dtype=np.float32) % 50
  s = rng.normal(size=n).astype(np.float32)
  x = np.stack([t, s], -1)
  y = rng.poisson(np.exp(0.5 * np.sin(t / 8) + 1.0)).astype(np.float32)
  y[::9] = 0.0  # exercise the ZINB zero branch
  return x, y


def _assert_fits_agree(got, want, first_rtol=1e-5, rtol=1e-3, atol=0.0):
  """Same seed, same batches: losses agree at step 1 (identical params)
  and stay close along the trajectory (only reduction order differs)."""
  (p_a, l_a), (p_b, l_b) = got, want
  l_a, l_b = np.asarray(l_a), np.asarray(l_b)
  np.testing.assert_allclose(l_a[:, 0], l_b[:, 0], rtol=first_rtol)
  np.testing.assert_allclose(l_a, l_b, rtol=rtol, atol=atol)
  for a, b in zip(jax.tree_util.tree_leaves(p_a),
                  jax.tree_util.tree_leaves(p_b)):
    np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=2e-2, atol=2e-3
    )


class TestShardedMatchesResident:
  """Sharded (GSPMD or shard_map) MAP training on the 8-device CPU mesh
  against the unsharded resident program of the same seed."""

  def _common(self, config, x, y, **kw):
    return dict(
        aug_features=_aug(config, x), target=y, config=config,
        distribution=likelihoods.LikelihoodDist.NORMAL, ensemble_size=2,
        learning_rate=0.01, num_epochs=8, seed=jax.random.PRNGKey(0), **kw,
    )

  def test_data_sharded_full_batch_matches_unsharded(self):
    """Rows sharded over a 4-wide 'data' axis; XLA all-reduces the loss
    and gradients over 'data'."""
    config = _small_config(width=16, depth=2)
    x, y = _small_data(n=96)
    common = self._common(config, x, y)
    _assert_fits_agree(
        map_lib.ensemble_map(
            mesh=mesh_lib.default_mesh(data_devices=4), **common
        ),
        map_lib.ensemble_map(mesh=mesh_lib.default_mesh(), **common),
    )

  def test_data_sharded_uneven_rows_full_batch(self):
    """N % data_shards != 0: the balanced padded layout's pad rows get zero
    weight, so the fit equals the unpadded unsharded one."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=97)  # 97 % 2 == 1
    common = self._common(config, x, y)
    _assert_fits_agree(
        map_lib.ensemble_map(
            mesh=mesh_lib.default_mesh(data_devices=2), **common
        ),
        map_lib.ensemble_map(mesh=mesh_lib.default_mesh(), **common),
    )

  @pytest.mark.parametrize('dist', [
      likelihoods.LikelihoodDist.NB, likelihoods.LikelihoodDist.ZINB,
  ])
  def test_count_data_sharded_full_batch_matches_unsharded(self, dist):
    config = _small_config(width=16, depth=2)
    x, y = _count_data()
    common = self._common(config, x, y)
    common['distribution'] = dist
    _assert_fits_agree(
        map_lib.ensemble_map(
            mesh=mesh_lib.default_mesh(data_devices=2), **common
        ),
        map_lib.ensemble_map(mesh=mesh_lib.default_mesh(), **common),
        rtol=3e-3, atol=1e-4,
    )

  def test_data_sharded_minibatch_non_divisible_matches_unsharded(self):
    """batch_size % data_shards != 0 runs the GSPMD program, whose global
    permutation is the unsharded program's: same batches, same fit."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=96)
    common = self._common(config, x, y, batch_size=33)
    _assert_fits_agree(
        map_lib.ensemble_map(
            mesh=mesh_lib.default_mesh(data_devices=2), **common
        ),
        map_lib.ensemble_map(mesh=mesh_lib.default_mesh(), **common),
    )

  def test_data_sharded_minibatch_ensemble_sharding_invariant(self):
    """The divisible sharded minibatch (shard_map, per-shard permutation)
    gives each member the same batches however 'ens' is sharded: a 4 x 2
    mesh equals a 1 x 2 mesh. N=97 also exercises the balanced layout."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=97)
    common = self._common(config, x, y, batch_size=32)
    common.update(ensemble_size=4, num_epochs=6)
    got = map_lib.ensemble_map(
        mesh=mesh_lib.default_mesh(data_devices=2), **common
    )
    want = map_lib.ensemble_map(
        mesh=mesh_lib.default_mesh(devices=jax.devices()[:2],
                                   data_devices=2),
        **common,
    )
    assert np.asarray(got[1]).shape == (4, 6)
    _assert_fits_agree(got, want, atol=1e-4)
    assert np.asarray(got[1])[:, -1].mean() < np.asarray(got[1])[:, 0].mean()

  def test_sharded_losses_and_grads_match_unsharded(self):
    """The shard_map programs' per-step loss/grad: row shards psum'd over
    'data' equal plain autodiff over the whole batch."""
    config = _small_config(width=16, depth=2)
    x, y = _count_data(n=64)
    aug_t = jnp.asarray(_aug(config, x)).T
    params = jax.vmap(lambda k: field_lib.init_params(config, k))(
        jax.random.split(jax.random.PRNGKey(0), 2)
    )
    for dist in likelihoods.LikelihoodDist:
      want = map_lib._make_losses_and_grads(
          config, dist, 1.5, 1.0, 'f32', data_shards=1
      )(params, aug_t, jnp.asarray(y))
      mesh = mesh_lib.default_mesh(devices=jax.devices()[:4],
                                   data_devices=2)
      fn = map_lib._make_losses_and_grads(
          config, dist, 1.5, 1.0, 'f32', data_shards=2
      )
      p_ens = jax.sharding.PartitionSpec(mesh_lib.ENSEMBLE_AXIS)
      got = jax.jit(jax.shard_map(
          fn, mesh=mesh,
          in_specs=(p_ens, jax.sharding.PartitionSpec(None, 'data'),
                    jax.sharding.PartitionSpec('data')),
          out_specs=(p_ens, p_ens), check_vma=False,
      ))(params, aug_t, jnp.asarray(y))
      np.testing.assert_allclose(got[0], want[0], rtol=1e-5, err_msg=str(dist))
      for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=str(dist))

  def test_shardmap_program_matches_gspmd_program_unsharded_data(self):
    """On an unsharded data axis the shard_map program draws the
    reference per-member permutation, so it equals the GSPMD program."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=96)
    mesh = mesh_lib.default_mesh()
    aug_t, target = minibatch_lib.make_layout_fn(96, 1, mesh)(
        _aug(config, x), jnp.asarray(y)
    )
    dist = likelihoods.LikelihoodDist.NORMAL
    results = []
    for factory in (map_lib._make_shardmap_train_fn, map_lib._make_train_fn):
      params, opt, keys, _ = map_lib._make_init_fn(config, 0.01, 8, mesh)(
          jax.random.PRNGKey(0), np.float32(0.0)
      )
      fn = factory(config, dist, 4, 32, 96, 0.01, 1.0, mesh)
      p, _, _, losses = fn(params, opt, keys, aug_t, target)
      results.append((p, losses))
    _assert_fits_agree(results[0], results[1])


class TestShardedVIMatchesResident:
  """Sharded ensemble VI against the unsharded resident program."""

  def _common(self, config, x, y, batch_size=None):
    return dict(
        aug_features=_aug(config, x), target=y,
        seed=jax.random.PRNGKey(0), observation_model='NORMAL',
        config=config, ensemble_size=2, learning_rate=0.02,
        num_epochs=6, sample_size_divergence=3, sample_size_posterior=4,
        kl_weight=0.2, batch_size=batch_size,
    )

  def _fit(self, mesh, common):
    s, l, _ = vi_lib.fit_vi(mesh=mesh, **common)
    return s, l

  def test_vi_data_sharded_full_batch_matches_unsharded(self):
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=96)
    common = self._common(config, x, y)
    _assert_fits_agree(
        self._fit(mesh_lib.default_mesh(data_devices=2), common),
        self._fit(mesh_lib.default_mesh(), common), atol=1e-4,
    )

  def test_vi_data_sharded_uneven_rows_full_batch(self):
    """VI on an uneven data axis: padded shards, exact row exclusion."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=97)
    common = self._common(config, x, y)
    _assert_fits_agree(
        self._fit(mesh_lib.default_mesh(data_devices=2), common),
        self._fit(mesh_lib.default_mesh(), common), atol=1e-4,
    )

  def test_vi_count_data_sharded_full_batch_matches_unsharded(self):
    config = _small_config(width=16, depth=1)
    x, y = _count_data(seed=7)
    common = self._common(config, x, y)
    common['observation_model'] = 'ZINB'
    _assert_fits_agree(
        self._fit(mesh_lib.default_mesh(data_devices=2), common),
        self._fit(mesh_lib.default_mesh(), common),
        first_rtol=1e-4, rtol=5e-3, atol=1e-3,
    )

  def test_vi_data_sharded_minibatch_non_divisible_matches_unsharded(self):
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=96)
    common = self._common(config, x, y, batch_size=33)
    _assert_fits_agree(
        self._fit(mesh_lib.default_mesh(data_devices=2), common),
        self._fit(mesh_lib.default_mesh(), common), atol=1e-4,
    )

  def test_vi_data_sharded_minibatch_ensemble_sharding_invariant(self):
    """Minibatch VI over a sharded data axis — the regime of EVERY VI
    registry config (shard_map, per-shard resampling each step); N=97
    exercises the balanced layout."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=97)
    common = self._common(config, x, y, batch_size=32)
    common['ensemble_size'] = 4
    got = self._fit(mesh_lib.default_mesh(data_devices=2), common)
    want = self._fit(
        mesh_lib.default_mesh(devices=jax.devices()[:2], data_devices=2),
        common,
    )
    assert np.asarray(got[1]).shape == (4, 6)
    _assert_fits_agree(got, want, rtol=2e-3, atol=1e-3)

  def test_vi_sharded_elbo_matches_unsharded(self):
    """The shard_map VI programs' per-step ELBO and gradient: shard-local
    terms psum'd over 'data' equal the whole-batch ELBO."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=64)
    aug_t = jnp.asarray(_aug(config, x)).T
    surrogate = jax.vmap(lambda k: vi_lib.init_surrogate(config, k))(
        jax.random.split(jax.random.PRNGKey(0), 2)
    )
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    dist = likelihoods.LikelihoodDist.NORMAL

    def total(fn, *args):
      def f(s):
        losses = fn(s, *args)
        return losses.sum(), losses
      return jax.value_and_grad(f, has_aux=True)

    one = vi_lib._make_elbo_losses(config, dist, 2.0, 3, 'f32', 1)
    (_, want_l), want_g = total(one, keys, aug_t, jnp.asarray(y))(surrogate)

    two = vi_lib._make_elbo_losses(config, dist, 2.0, 3, 'f32', 2)

    def shard_fn(s, k, a, yy):
      (_, losses), grads = total(two, k, a, yy)(s)
      psum = lambda v: jax.lax.psum(v, mesh_lib.DATA_AXIS)  # noqa: E731
      return psum(losses), jax.tree_util.tree_map(psum, grads)

    mesh = mesh_lib.default_mesh(devices=jax.devices()[:4], data_devices=2)
    p_ens = jax.sharding.PartitionSpec(mesh_lib.ENSEMBLE_AXIS)
    got_l, got_g = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(p_ens, p_ens, jax.sharding.PartitionSpec(None, 'data'),
                  jax.sharding.PartitionSpec('data')),
        out_specs=(p_ens, p_ens), check_vma=False,
    ))(surrogate, keys, aug_t, jnp.asarray(y))
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(got_g),
                    jax.tree_util.tree_leaves(want_g)):
      np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

  def test_vi_shardmap_program_matches_gspmd_program_unsharded_data(self):
    """On an unsharded data axis the shard_map VI program reproduces the
    GSPMD program's per-member RNG (step keys, MC draws, minibatch)."""
    config = _small_config(width=16, depth=1)
    x, y = _small_data(n=96)
    mesh = mesh_lib.default_mesh()
    aug_t, target = minibatch_lib.make_layout_fn(96, 1, mesh)(
        _aug(config, x), jnp.asarray(y)
    )
    dist = likelihoods.LikelihoodDist.NORMAL
    results = []
    for factory in (vi_lib._make_shardmap_vi_fn, vi_lib._make_vi_fn):
      surr, opt, keys, _ = vi_lib._make_vi_init_fn(config, 0.02, 8, mesh)(
          jax.random.PRNGKey(0)
      )
      fn = factory(config, dist, 5, 32, 96, 0.02, 3, 0.2, mesh)
      s, _, _, losses = fn(surr, opt, keys, aug_t, target)
      results.append((s, losses))
    _assert_fits_agree(results[0], results[1], atol=1e-4)
