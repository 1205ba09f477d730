"""Public estimator API tests (parity: reference test_spatiotemporal.py:49-120
plus data-handler behavior and end-to-end shape contracts)."""

import numpy as np
import pandas as pd
import jax
import pytest

from bayesnf_tpu import BayesianNeuralFieldEstimator
from bayesnf_tpu import BayesianNeuralFieldMAP
from bayesnf_tpu import BayesianNeuralFieldMLE
from bayesnf_tpu import BayesianNeuralFieldVI
from bayesnf_tpu.data import SpatiotemporalDataHandler


@pytest.mark.parametrize('p, h', [([], []), ([10, 15], [8, 6])])
def test_get_seasonality_periods_index(p, h):
  model = BayesianNeuralFieldMAP(
      freq='D', seasonality_periods=p, num_seasonal_harmonics=h,
      feature_cols=['t'], target_col='x', timetype='index',
  )
  assert np.all(model._get_seasonality_periods() == p)
  assert np.all(model._get_num_seasonal_harmonics() == h)


@pytest.mark.parametrize('p, h', [([], []), ([10, 12, .25], [.5, .5, .125])])
def test_get_seasonality_periods_float(p, h):
  model = BayesianNeuralFieldMAP(
      seasonality_periods=p, feature_cols=['t'], target_col='x',
      timetype='float',
  )
  assert np.all(model._get_seasonality_periods() == p)
  assert np.all(model._get_num_seasonal_harmonics() == h)


def test_invalid_frequency():
  model = BayesianNeuralFieldMAP(
      feature_cols=['t'], target_col='x', timetype='index',
  )
  with pytest.raises(ValueError):
    model._get_seasonality_periods()
  model = BayesianNeuralFieldMAP(
      freq='M', feature_cols=['t'], target_col='x', timetype='float',
  )
  with pytest.raises(ValueError):
    model._get_seasonality_periods()


def test_invalid_seasonality_period():
  model = BayesianNeuralFieldMAP(
      seasonality_periods=['W'], feature_cols=['t'], target_col='x',
      timetype='float',
  )
  with pytest.raises(ValueError):
    model._get_seasonality_periods()


def test_invalid_num_seasonal_harmonics():
  model = BayesianNeuralFieldMAP(
      seasonality_periods=[1, 5], num_seasonal_harmonics=[0.5, 1],
      feature_cols=['t'], target_col='x', timetype='float',
  )
  with pytest.raises(ValueError):
    model._get_num_seasonal_harmonics()


def test_fourier_degrees_validation():
  model = BayesianNeuralFieldMAP(
      feature_cols=['t', 'a'], target_col='x', timetype='float',
      fourier_degrees=[5],
  )
  with pytest.raises(ValueError, match='fourier_degrees'):
    model._get_fourier_degrees((10, 2))
  np.testing.assert_array_equal(
      BayesianNeuralFieldMAP(
          feature_cols=['t', 'a'], target_col='x', timetype='float'
      )._get_fourier_degrees((10, 2)),
      [5, 5],
  )


def test_interactions_validation():
  model = BayesianNeuralFieldMAP(
      feature_cols=['t'], target_col='x', timetype='float',
      interactions=[(0, 1, 2)],
  )
  with pytest.raises(ValueError, match='interactions'):
    model._get_interactions()


class TestDataHandler:

  def _table(self):
    return pd.DataFrame({
        'datetime': pd.to_datetime(
            ['2021-01-01', '2021-01-08', '2021-01-15', '2021-01-29']
        ),
        'lat': [1.0, 2.0, 3.0, 4.0],
        'y': [10.0, np.nan, 30.0, 40.0],
    })

  def test_time_conversion_and_nan_filter(self):
    h = SpatiotemporalDataHandler(['datetime', 'lat'], 'y', 'index', 'W')
    train = h.get_train(self._table())
    # NaN-target row dropped; weekly periods offset to min 0.
    assert train.shape == (3, 2)
    np.testing.assert_array_equal(train[:, 0], [0.0, 2.0, 4.0])
    np.testing.assert_array_equal(h.get_target(self._table()), [10, 30, 40])
    np.testing.assert_array_equal(h.get_input_scales(), [4.0, 1.0])

  def test_standardization_reuses_train_stats(self):
    h = SpatiotemporalDataHandler(
        ['datetime', 'lat'], 'y', 'index', 'W', standardize=['lat']
    )
    train = h.get_train(self._table())
    np.testing.assert_allclose(train[:, 1].mean(), 0.0, atol=1e-12)
    test_table = self._table().iloc[:2]
    test = h.get_test(test_table)
    # Test rows keep train stats (including the NaN row, not filtered).
    np.testing.assert_allclose(
        test[:, 1], (np.array([1.0, 2.0]) - h.mu_[1]) / h.std_[1]
    )
    assert test.shape == (2, 2)

  def test_time_standardization_rejected(self):
    h = SpatiotemporalDataHandler(
        ['datetime', 'lat'], 'y', 'index', 'W', standardize=['datetime']
    )
    with pytest.raises(TypeError, match='time column'):
      h.get_train(self._table())

  def test_float_timetype(self):
    h = SpatiotemporalDataHandler(['t', 'lat'], 'y', 'float', None)
    df = pd.DataFrame({'t': [3.0, 5.0, 9.0], 'lat': [0, 1, 2], 'y': [1, 2, 3]})
    train = h.get_train(df)
    np.testing.assert_array_equal(train[:, 0], [0.0, 2.0, 6.0])


class TestEndToEnd:

  def _df(self, n=100):
    rng = np.random.default_rng(0)
    t = np.arange(n, dtype=float) % 40
    lat = rng.normal(size=n)
    y = np.sin(2 * np.pi * t / 8) * 4 + lat + 0.1 * rng.normal(size=n)
    return pd.DataFrame({'time': t, 'lat': lat, 'y': y})

  def _kwargs(self):
    return dict(
        width=8, depth=1, seasonality_periods=[8.0],
        feature_cols=['time', 'lat'], target_col='y',
        observation_model='NORMAL', timetype='float', standardize=['lat'],
    )

  def test_map_shapes_and_learning(self):
    df = self._df()
    m = BayesianNeuralFieldMAP(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=8, num_epochs=150,
          learning_rate=0.02)
    assert m.losses_.shape == (8, 1, 150)
    means, quants = m.predict(df, quantiles=(0.5, 0.1, 0.9))
    assert means.shape == (8, 1, 100)
    yhat = np.asarray(means).mean((0, 1))
    rmse = np.sqrt(np.mean((yhat - df.y.values) ** 2))
    assert rmse < 0.8 * df.y.std()

  def test_int_seed_accepted(self):
    df = self._df(60)
    m = BayesianNeuralFieldMLE(**self._kwargs())
    m.fit(df, seed=3, ensemble_size=2, num_epochs=5)
    assert m.params_[0].shape == (1, 2)

  @pytest.mark.parametrize('precision', ['bf16', 'highest'])
  def test_precision_plumbs_through_fit(self, precision):
    df = self._df(60)
    m = BayesianNeuralFieldMAP(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=5,
          precision=precision)
    assert np.all(np.isfinite(np.asarray(m.losses_)))

  def test_vi_shapes(self):
    df = self._df(60)
    m = BayesianNeuralFieldVI(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=10,
          sample_size_posterior=5, batch_size=30)
    # (devices_group, samples, members, ...) with G=1 for E=2 on 8 devices.
    assert m.params_[0].shape == (1, 5, 2)
    assert m.losses_.shape == (1, 2, 20)  # 10 epochs * (60 // 30) steps
    means, _ = m.predict(df, quantiles=(0.5,))
    assert means.shape == (1, 5, 2, 60)

  def test_likelihood_model(self):
    df = self._df(50)
    m = BayesianNeuralFieldMAP(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=20)
    dist = m.likelihood_model(df)
    lp = np.asarray(dist.log_prob(df.y.values))
    assert lp.shape == (1, 2)
    assert np.all(np.isfinite(lp))
    samples = np.asarray(dist.sample(jax.random.PRNGKey(1)))
    assert samples.shape == (1, 2, 50)

  def test_likelihood_model_mesh_and_backend_agree(self):
    """likelihood_model rides the predict stack: a mesh-fit estimator
    produces the same distribution through the row-parallel mesh path as
    through the meshless program."""
    from bayesnf_tpu.parallel import mesh as mesh_lib

    df = self._df(50)
    mesh = mesh_lib.default_mesh(data_devices=2)
    m = BayesianNeuralFieldMAP(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=20,
          mesh=mesh)
    assert m.mesh_ is mesh
    got = m.likelihood_model(df)
    m.mesh_ = None  # the same fitted parameters, one meshless program
    ref = m.likelihood_model(df)
    np.testing.assert_allclose(
        np.asarray(got.log_prob(df.y.values)),
        np.asarray(ref.log_prob(df.y.values)), rtol=1e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(got.mean()), np.asarray(ref.mean()), rtol=1e-4, atol=1e-5,
    )

  def test_vi_surrogate_persists_and_resamples(self, tmp_path):
    """save/load keeps the fitted VI surrogate, so a loaded estimator can
    draw FRESH posterior ensembles (resample_posterior) — round 2's
    save/load froze VI models to their fit-time draws."""
    df = self._df(60)
    m = BayesianNeuralFieldVI(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=10,
          sample_size_posterior=4, batch_size=30)
    path = str(tmp_path / 'vi.bnf')
    m.save(path)
    m2 = BayesianNeuralFieldVI.load(path)
    assert m2.surrogate_ is not None
    for a, b in zip(jax.tree_util.tree_leaves(m.surrogate_),
                    jax.tree_util.tree_leaves(m2.surrogate_)):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    old_params = m2.params_
    m2.resample_posterior(seed=7, sample_size_posterior=5)
    assert m2.params_[0].shape == (1, 5, 2)  # (G, S, M)
    assert not np.array_equal(np.asarray(m2.params_[0])[:, :4],
                              np.asarray(old_params[0]))
    means, _ = m2.predict(df, quantiles=(0.5,))
    assert means.shape == (1, 5, 2, 60)
    assert np.all(np.isfinite(np.asarray(means)))
    # Same seed -> same draws (deterministic resampling).
    m3 = BayesianNeuralFieldVI.load(path).resample_posterior(
        seed=7, sample_size_posterior=5
    )
    for a, b in zip(m2.params_, m3.params_):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # A MAP artifact has no surrogate and says so.
    m_map = BayesianNeuralFieldMAP(**self._kwargs())
    m_map.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=5)
    map_path = str(tmp_path / 'map.bnf')
    m_map.save(map_path)
    assert BayesianNeuralFieldMAP.load(map_path).surrogate_ is None

  def test_save_load_restores_fit_mesh(self, tmp_path):
    """A loaded estimator rebuilds the fit-time mesh when this process has
    the same topology (round 2 silently predicted meshless)."""
    from bayesnf_tpu.parallel import mesh as mesh_lib

    df = self._df(64)
    mesh = mesh_lib.default_mesh(data_devices=2)
    m = BayesianNeuralFieldMAP(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=5,
          mesh=mesh)
    path = str(tmp_path / 'mesh.bnf')
    m.save(path)
    m2 = BayesianNeuralFieldMAP.load(path)
    assert m2.mesh_ is not None
    assert dict(m2.mesh_.shape) == {'ens': 4, 'data': 2}
    want, _ = m.predict(df, quantiles=(0.5,))
    got, _ = m2.predict(df, quantiles=(0.5,))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)

  def test_save_load_roundtrip(self, tmp_path):
    df = self._df(60)
    m = BayesianNeuralFieldMAP(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=20)
    want_means, want_q = m.predict(df, quantiles=(0.5, 0.9))
    path = str(tmp_path / 'model.bnf')
    m.save(path)

    # Load via the matching class AND via the base class.
    for loader in (BayesianNeuralFieldMAP, BayesianNeuralFieldEstimator):
      m2 = loader.load(path)
      assert type(m2) is BayesianNeuralFieldMAP
      got_means, got_q = m2.predict(df, quantiles=(0.5, 0.9))
      np.testing.assert_allclose(
          np.asarray(got_means), np.asarray(want_means), rtol=1e-6)
      for a, b in zip(got_q, want_q):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
      np.testing.assert_allclose(
          np.asarray(m2.losses_), np.asarray(m.losses_))

    # Wrong-class load errors clearly; unfitted save errors clearly.
    with pytest.raises(ValueError, match='holds a BayesianNeuralFieldMAP'):
      BayesianNeuralFieldVI.load(path)
    with pytest.raises(ValueError, match='unfitted'):
      BayesianNeuralFieldMAP(**self._kwargs()).save(str(tmp_path / 'x'))

  def test_save_load_vi_with_index_time(self, tmp_path):
    # VI (3 ensemble dims) + datetime/index time + freq: the handler's
    # period offset and z-score stats must survive the roundtrip.
    rng = np.random.default_rng(1)
    n = 60
    dates = pd.date_range('2018-01-01', periods=n, freq='W-MON')
    lat = rng.normal(size=n)
    y = np.sin(np.arange(n) / 5.0) * 3 + lat
    df = pd.DataFrame({'time': dates, 'lat': lat, 'y': y})
    m = BayesianNeuralFieldVI(
        width=8, depth=1, seasonality_periods=['M'],
        num_seasonal_harmonics=[2],
        feature_cols=['time', 'lat'], target_col='y',
        observation_model='NORMAL', timetype='index', freq='W',
        standardize=['lat'],
    )
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=5,
          sample_size_posterior=3, batch_size=None)
    want, _ = m.predict(df, quantiles=(0.5,))
    path = str(tmp_path / 'vi.bnf')
    m.save(path)
    m2 = BayesianNeuralFieldVI.load(path)
    assert m2.data_handler.time_min_ == m.data_handler.time_min_
    got, _ = m2.predict(df, quantiles=(0.5,))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)

  def test_predict_without_target_column(self):
    df = self._df(50)
    m = BayesianNeuralFieldMAP(**self._kwargs())
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=10)
    means, _ = m.predict(df.drop(columns=['y']), quantiles=(0.5,))
    assert means.shape == (1, 2, 50)


class TestCountModels:
  """Estimator-level NB/ZINB coverage (fit + predict + likelihood_model)."""

  def _count_df(self, n=200):
    rng = np.random.default_rng(3)
    t = np.arange(n, dtype=float) % 60
    lat = rng.normal(size=n)
    mu = np.exp(0.8 * np.sin(2 * np.pi * t / 12) + 0.3 * lat + 1.0)
    y = rng.poisson(mu).astype(float)
    return pd.DataFrame({'time': t, 'lat': lat, 'y': y})

  @pytest.mark.parametrize('obs', ['NB', 'ZINB'])
  def test_fit_predict(self, obs):
    df = self._count_df()
    m = BayesianNeuralFieldMLE(
        width=8, depth=1, seasonality_periods=[12.0],
        feature_cols=['time', 'lat'], target_col='y',
        observation_model=obs, timetype='float', standardize=['lat'],
    )
    m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=300,
          learning_rate=0.01)
    means, quants = m.predict(df, quantiles=(0.1, 0.5, 0.9))
    yhat = np.asarray(means).mean((0, 1))
    assert np.all(np.isfinite(yhat))
    q10, q50, q90 = (np.asarray(q) for q in quants)
    # Count quantiles: integer-valued, ordered, non-negative.
    for q in (q10, q50, q90):
      np.testing.assert_array_equal(q, np.floor(q))
      assert np.all(q >= 0)
    assert np.all(q10 <= q50) and np.all(q50 <= q90)
    dist = m.likelihood_model(df.head(20))
    lp = np.asarray(dist.log_prob(df.y.values[:20]))
    assert lp.shape == (1, 2) and np.all(np.isfinite(lp))


def test_vi_batch_larger_than_dataset_clamps():
  """Reference crashes when batch_size > N (assert); we clamp to full batch."""
  rng = np.random.default_rng(0)
  df = pd.DataFrame({
      'time': np.arange(30, dtype=float),
      'y': rng.normal(size=30),
  })
  m = BayesianNeuralFieldVI(
      width=8, depth=1, feature_cols=['time'], target_col='y',
      timetype='float',
  )
  m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=2, num_epochs=3,
        batch_size=500, sample_size_posterior=2)
  assert m.losses_.shape == (1, 2, 3)


def test_custom_mesh_group_shape_matches_fit_mesh():
  """params_ group shape derives from the mesh the fit ran on, not the
  process-global device count (8 virtual devices here)."""
  from bayesnf_tpu.parallel import mesh as mesh_lib

  rng = np.random.default_rng(0)
  df = pd.DataFrame({
      'time': np.arange(40, dtype=float),
      'y': rng.normal(size=40),
  })
  mesh = mesh_lib.default_mesh(devices=jax.devices()[:2])
  m = BayesianNeuralFieldMAP(
      width=8, depth=1, feature_cols=['time'], target_col='y',
      timetype='float',
  )
  m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=4, num_epochs=3,
        mesh=mesh)
  # 4 members on a 2-device mesh -> public group shape (2, 2), even though
  # jax.device_count() == 8 (which would have produced the degenerate (1, 4)).
  assert m.params_[0].shape[:2] == (2, 2)
  assert m.losses_.shape == (2, 2, 3)
