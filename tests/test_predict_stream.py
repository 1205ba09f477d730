"""Out-of-core (host-streamed) prediction tests.

The streamed predictor (`inference/predict_stream.py`) must be pure
transfer mechanics: for every observation model, ensemble shape, mesh
placement, and chunking, its outputs are BIT-identical to the in-memory
predict program (the forward is row-independent; the quantile root-finds
share the global bracket via exact running extrema). These tests assert
array_equal, not allclose — the same discipline as the training-side
streaming tests (tests/test_streaming.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest

from bayesnf_tpu.inference import predict as predict_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.parallel import mesh as mesh_lib


def _setup(n=100, seed=0, ensemble_shape=(2, 3)):
  config = field_lib.FieldConfig.create(
      width=8, depth=1, input_scales=[30.0, 1.0], fourier_degrees=[2, 2],
      interactions=[(0, 1)], seasonality_periods=[8.0],
      num_seasonal_harmonics=[2],
  )
  rng = np.random.default_rng(seed)
  x = np.stack(
      [np.arange(n, dtype=np.float32), rng.normal(size=n).astype(np.float32)],
      -1,
  )
  k = int(np.prod(ensemble_shape))
  params = jax.vmap(lambda key: field_lib.init_params(config, key))(
      jax.random.split(jax.random.PRNGKey(seed + 1), k)
  )
  params = tuple(
      p.reshape(ensemble_shape + p.shape[1:]) for p in params
  )
  return config, x, params


def _assert_bitwise(got, want):
  got_means, got_qs = got
  want_means, want_qs = want
  np.testing.assert_array_equal(np.asarray(got_means), np.asarray(want_means))
  assert len(got_qs) == len(want_qs)
  for g, w in zip(got_qs, want_qs):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_streamed_matches_in_memory_bitwise(observation_model):
  config, x, params = _setup(n=100)
  kwargs = dict(
      quantiles=(0.5, 0.975), ensemble_dims=2, chunk_size=16
  )
  want = predict_lib.predict_bnf(
      x, observation_model, params, config, **kwargs
  )
  # 32-row host chunks over 100 rows: 4 chunks, ragged 4-row tail.
  got = predict_lib.predict_bnf(
      x, observation_model, params, config, stream_chunk_rows=32, **kwargs
  )
  _assert_bitwise(got, want)
  assert isinstance(got[0], np.ndarray)  # host buffer, not device array


def test_stream_chunk_rows_is_bit_invariant():
  config, x, params = _setup(n=100)
  kwargs = dict(
      quantiles=(0.025, 0.5), ensemble_dims=2, chunk_size=16
  )
  a = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, stream_chunk_rows=16, **kwargs
  )
  b = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, stream_chunk_rows=64, **kwargs
  )
  # Chunk size not a multiple of the device chunk: rounded up internally.
  c = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, stream_chunk_rows=25, **kwargs
  )
  _assert_bitwise(a, b)
  _assert_bitwise(a, c)


def test_streamed_vi_shape_contract():
  # VI's ensemble_dims=3 (groups, samples, members) path.
  config, x, params = _setup(n=40, ensemble_shape=(1, 2, 2))
  kwargs = dict(
      quantiles=(0.5,), ensemble_dims=3, chunk_size=16
  )
  want = predict_lib.predict_bnf(x, 'NORMAL', params, config, **kwargs)
  got = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, stream_chunk_rows=16, **kwargs
  )
  _assert_bitwise(got, want)
  assert got[0].shape == (1, 2, 2, 40)


def test_streamed_approximate_quantiles():
  config, x, params = _setup(n=50)
  kwargs = dict(
      quantiles=(0.5, 0.9), ensemble_dims=2, chunk_size=16,
      approximate_quantiles=True,
  )
  want = predict_lib.predict_bnf(x, 'NORMAL', params, config, **kwargs)
  got = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, stream_chunk_rows=16, **kwargs
  )
  # Means stay bitwise. The APPROXIMATE quantile is a moment-matching
  # heuristic whose mean/sqrt chain XLA fuses differently in the streamed
  # program (flat (K, rows) leaves reshaped in-program) than in the
  # in-memory one — observed: final-ulp differences that additionally
  # depend on the compile environment. The bit-identity contract belongs
  # to the exact root-find path (global shared bracket — asserted bitwise
  # throughout this file); the heuristic path asserts ulp-level agreement,
  # the same discipline as the mesh leg above.
  np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
  for g, w in zip(got[1], want[1]):
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7
    )


def test_streamed_over_mesh_matches_in_memory():
  config, x, params = _setup(n=96)
  mesh = mesh_lib.default_mesh(jax.devices()[:4], data_devices=2)
  kwargs = dict(
      quantiles=(0.5, 0.975), ensemble_dims=2, chunk_size=32, mesh=mesh,
  )
  want = predict_lib.predict_bnf(x, 'NORMAL', params, config, **kwargs)
  got = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, stream_chunk_rows=32, **kwargs
  )
  # Forecast params (the means) stay bitwise over the mesh; the quantile
  # root-find is a DIFFERENT GSPMD-partitioned program in the streamed
  # path, and XLA's fusion/FMA choices across two partitioned programs
  # can differ in the final ulp of the CDF evaluation — observed: 1/96
  # lanes off by one f32 ulp. Meshless streamed predict is bitwise
  # (tests above); the mesh leg asserts ulp-level agreement.
  np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
  for g, w in zip(got[1], want[1]):
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(w), rtol=1e-6, atol=1e-7
    )


@pytest.mark.parametrize('observation_model', ['NORMAL', 'ZINB'])
def test_streamed_forecast_params_bitwise(observation_model):
  config, x, params = _setup(n=70)
  want = predict_lib.forecast_params_bnf(
      x, observation_model, params, config, ensemble_dims=2, chunk_size=16,
  )
  # Default budget (all chunks device-cached, one batched fetch per
  # leaf), a one-chunk budget (partial spill), and budget 0 (pure
  # per-chunk fetch) must all return the same host buffers bitwise.
  for cache_bytes in (1 << 30, 6 * 32 * 4 * 2, 0):
    got = predict_lib.forecast_params_bnf(
        x, observation_model, params, config, ensemble_dims=2,
        chunk_size=16, stream_chunk_rows=32,
        stream_cache_bytes=cache_bytes,
    )
    assert len(got) == len(want)
    for g, w in zip(got, want):
      assert isinstance(g, np.ndarray)
      np.testing.assert_array_equal(g, np.asarray(w))


def test_estimator_streamed_predict_and_likelihood_model():
  from bayesnf_tpu.spatiotemporal import BayesianNeuralFieldMAP

  n = 80
  rng = np.random.default_rng(0)
  t = np.arange(n, dtype=float) % 40
  lat = rng.normal(size=n)
  y = np.sin(2 * np.pi * t / 8) * 4 + lat + 0.1 * rng.normal(size=n)
  df = pd.DataFrame({'time': t, 'lat': lat, 'y': y})
  m = BayesianNeuralFieldMAP(
      width=8, depth=1, seasonality_periods=[8.0],
      feature_cols=['time', 'lat'], target_col='y',
      observation_model='NORMAL', timetype='float', standardize=['lat'],
  )
  m.fit(
      df, seed=jax.random.PRNGKey(0), ensemble_size=4, num_epochs=8,
      batch_size=20, stream_chunk_steps=4,
  )
  want = m.predict(df, quantiles=(0.5, 0.975))
  got = m.predict(
      df, quantiles=(0.5, 0.975), stream_chunk_rows=32
  )
  _assert_bitwise(got, want)

  lm_mem = m.likelihood_model(df)
  lm_str = m.likelihood_model(
      df, stream_chunk_rows=32, stream_cache_bytes=0
  )
  np.testing.assert_array_equal(
      np.asarray(lm_str.mean()), np.asarray(lm_mem.mean())
  )
  np.testing.assert_array_equal(
      np.asarray(lm_str.log_prob(jnp.asarray(df.y.values, jnp.float32))),
      np.asarray(lm_mem.log_prob(jnp.asarray(df.y.values, jnp.float32))),
  )


@pytest.mark.parametrize('observation_model', ['NORMAL', 'NB', 'ZINB'])
def test_cache_budget_bit_invariant(observation_model):
  """Fully cached, partially spilled, and cache-disabled streams agree.

  100 rows in 32-row host chunks (4 chunks, ragged tail). Retained
  bytes per chunk = K(=6) x 32 x 4 x num_RETAINED_leaves, where retained
  = pass-2 leaves UNION host-output leaves (NORMAL {0}; NB {1,2}; ZINB
  {1,2,3}). A one-chunk budget forces chunks 1..3 through the host
  spill + re-upload path — exercising the mixed cached+spilled pass-2
  assembly for every observation model; budget 0 spills everything —
  all must match the default (all-cached) output bitwise, and the
  in-memory program too.
  """
  config, x, params = _setup(n=100)
  kwargs = dict(
      quantiles=(0.5, 0.975), ensemble_dims=2, chunk_size=16
  )
  want = predict_lib.predict_bnf(
      x, observation_model, params, config, **kwargs
  )
  num_retained = {'NORMAL': 1, 'NB': 2, 'ZINB': 3}[observation_model]
  one_chunk = 6 * 32 * 4 * num_retained
  cached = predict_lib.predict_bnf(
      x, observation_model, params, config, stream_chunk_rows=32, **kwargs
  )
  spilled = predict_lib.predict_bnf(
      x, observation_model, params, config, stream_chunk_rows=32,
      stream_cache_bytes=one_chunk, **kwargs
  )
  disabled = predict_lib.predict_bnf(
      x, observation_model, params, config, stream_chunk_rows=32,
      stream_cache_bytes=0, **kwargs
  )
  _assert_bitwise(cached, want)
  _assert_bitwise(spilled, want)
  _assert_bitwise(disabled, want)


def test_estimator_stream_cache_bytes_kwarg():
  """The estimator surface plumbs the cache budget through."""
  config, x, params = _setup(n=40)
  del config, params
  from bayesnf_tpu.spatiotemporal import BayesianNeuralFieldMAP

  n = 60
  rng = np.random.default_rng(1)
  t = np.arange(n, dtype=float) % 30
  lat = rng.normal(size=n)
  y = np.sin(2 * np.pi * t / 8) * 4 + lat
  df = pd.DataFrame({'time': t, 'lat': lat, 'y': y})
  m = BayesianNeuralFieldMAP(
      width=8, depth=1, seasonality_periods=[8.0],
      feature_cols=['time', 'lat'], target_col='y',
      observation_model='NORMAL', timetype='float', standardize=['lat'],
  )
  m.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=4, num_epochs=4)
  want = m.predict(df, quantiles=(0.5,))
  got = m.predict(
      df, quantiles=(0.5,), stream_chunk_rows=16,
      stream_cache_bytes=0,
  )
  _assert_bitwise(got, want)


def test_single_chunk_degenerate():
  # stream_chunk_rows >= N: one chunk, still bit-equal.
  config, x, params = _setup(n=30)
  kwargs = dict(quantiles=(0.5,), ensemble_dims=2, chunk_size=16)
  want = predict_lib.predict_bnf(x, 'NB', params, config, **kwargs)
  got = predict_lib.predict_bnf(
      x, 'NB', params, config, stream_chunk_rows=10_000, **kwargs
  )
  _assert_bitwise(got, want)
