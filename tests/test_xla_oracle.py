"""The XLA train and predict programs against a plain row-major oracle.

The programs run the features-major forward (`field.apply_field_t`), the
chunked gradient accumulation of `inference/map.py` (a padded final
chunk), and the chunked predict forward. The oracle is the row-major
`field.apply_field` + likelihood + prior under plain `jax.value_and_grad`.
A train program's gradient is read back from Adam's first moment, which
after one step from a zero state is exactly (1 - b1) * grad.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.inference import predict as predict_lib
from bayesnf_tpu.inference import vi as vi_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods
from bayesnf_tpu.models import priors
from bayesnf_tpu.parallel import mesh as mesh_lib
from bayesnf_tpu.parallel import minibatch as minibatch_lib

N = 70  # with 32-row gradient chunks: 3 chunks, 26 padded rows


def _config(depth=2, seasonal=True, width=16):
  return field_lib.FieldConfig.create(
      width=width,
      depth=depth,
      input_scales=[40.0, 1.0, 1.0],
      fourier_degrees=[3, 2, 0],
      interactions=[(0, 1), (1, 2)] if seasonal else [],
      seasonality_periods=[7.0, 12.0] if seasonal else [],
      num_seasonal_harmonics=[2, 1] if seasonal else [],
  )


def _data(distribution, seed=0):
  rng = np.random.default_rng(seed)
  t = np.arange(N, dtype=np.float32) % 40
  x = np.stack([t, rng.normal(size=N), rng.normal(size=N)], -1)
  x = x.astype(np.float32)
  if distribution == likelihoods.LikelihoodDist.NORMAL:
    y = np.sin(t / 3) * 2 + x[:, 1]
  else:
    y = rng.poisson(np.exp(0.5 * np.sin(t / 5) + 1.0))
    y[::6] = 0
  return x, y.astype(np.float32)


def _params(config, e, seed=0):
  params = jax.vmap(lambda k: field_lib.init_params(config, k))(
      jax.random.split(jax.random.PRNGKey(seed), e)
  )
  # Nonzero scalars so every parameter slot carries a gradient.
  rng = np.random.default_rng(seed + 1)
  return tuple(
      p + 0.3 * jnp.asarray(rng.normal(size=p.shape), jnp.float32)
      for p in params
  )


def _oracle_step(config, distribution, params, x, y, lik_scale=1.0):
  seasonal = field_lib.seasonal_features_for(config, jnp.asarray(x))

  def loss(p):
    pred = field_lib.apply_field(config, p, jnp.asarray(x), seasonal)
    return -(
        lik_scale * likelihoods.log_likelihood(
            distribution, p, pred, jnp.asarray(y))
        + priors.prior_log_prob(config, p)
    )

  return jax.vmap(jax.value_and_grad(loss))(params)


def _program_step(config, distribution, params, x, y, precision='f32',
                  grad_row_chunk=32):
  mesh = mesh_lib.default_mesh()
  e = params[0].shape[0]
  aug = field_lib.aug_features_device(config, x)
  aug_t, target = minibatch_lib.make_layout_fn(N, 1, mesh)(aug, y)
  train = map_lib._make_train_fn(
      config, distribution, 1, N, N, 0.01, 1.0, mesh, precision,
      grad_row_chunk=grad_row_chunk,
  )
  opt = map_lib.init_opt_state(config, 0.01, params)
  keys = jax.random.split(jax.random.PRNGKey(0), e)
  _, opt1, _, losses = train(tuple(params), opt, keys, aug_t, target)
  return np.asarray(losses)[:, 0], [np.asarray(m) / 0.1 for m in opt1[0].mu]


def _assert_step_close(got, want, rtol, atol):
  np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=rtol)
  for g, w in zip(got[1], want[1]):
    np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol)


@pytest.mark.parametrize('seasonal', [True, False])
@pytest.mark.parametrize('depth', [1, 2, 3])
def test_features_major_forward_matches_row_major(depth, seasonal):
  config = _config(depth=depth, seasonal=seasonal)
  x, _ = _data(likelihoods.LikelihoodDist.NORMAL)
  params = _params(config, 3)
  seasonal_x = field_lib.seasonal_features_for(config, jnp.asarray(x))
  want = jax.vmap(
      lambda p: field_lib.apply_field(config, p, jnp.asarray(x), seasonal_x)
  )(params)
  got = jax.vmap(
      lambda p: field_lib.apply_field_t(
          config, p, jnp.asarray(x).T, seasonal_x.T)
  )(params)
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                             atol=2e-5)


@pytest.mark.parametrize('seasonal', [True, False])
@pytest.mark.parametrize('dist', list(likelihoods.LikelihoodDist))
def test_chunked_train_step_matches_full_batch_autodiff(dist, seasonal):
  """grad_row_chunk=32 < 70 rows: three chunks, the last one padded."""
  config = _config(seasonal=seasonal)
  x, y = _data(dist)
  params = _params(config, 8)
  _assert_step_close(
      _program_step(config, dist, params, x, y),
      _oracle_step(config, dist, params, x, y), rtol=2e-4, atol=2e-5,
  )


@pytest.mark.parametrize('dist', list(likelihoods.LikelihoodDist))
def test_highest_train_step_matches_oracle(dist):
  config = _config()
  x, y = _data(dist, seed=1)
  params = _params(config, 8, seed=1)
  with jax.default_matmul_precision('highest'):
    want = _oracle_step(config, dist, params, x, y)
  _assert_step_close(
      _program_step(config, dist, params, x, y, precision='highest'),
      want, rtol=2e-4, atol=2e-5,
  )


@pytest.mark.parametrize('grad_row_chunk', [16, 70, 8192])
def test_train_step_matches_oracle_for_any_row_chunk(grad_row_chunk):
  """16 rows: five chunks (ten padded rows); 70: the single-chunk branch;
  8192: one chunk far larger than the batch."""
  config = _config()
  dist = likelihoods.LikelihoodDist.NORMAL
  x, y = _data(dist, seed=2)
  params = _params(config, 8, seed=2)
  _assert_step_close(
      _program_step(config, dist, params, x, y,
                    grad_row_chunk=grad_row_chunk),
      _oracle_step(config, dist, params, x, y), rtol=2e-4, atol=2e-5,
  )


@pytest.mark.parametrize('dist', list(likelihoods.LikelihoodDist))
def test_chunked_predict_forward_matches_row_major(dist):
  """The predict program's forward: 16-row device chunks (70 rows pad to
  80), vmapped over members, equal the row-major forward parameters."""
  config = _config()
  x, _ = _data(dist)
  params = _params(config, 3)
  seasonal_x = field_lib.seasonal_features_for(config, jnp.asarray(x))
  pred = jax.vmap(
      lambda p: field_lib.apply_field(config, p, jnp.asarray(x), seasonal_x)
  )(params)
  want = jax.vmap(
      lambda p, pr: likelihoods.forecast_params(dist, p, pr)
  )(params, pred)
  got = predict_lib.forecast_params_bnf(
      x, dist.value, params, config, ensemble_dims=1, chunk_size=16,
  )
  assert len(got) == len(want)
  for g, w in zip(got, want):
    np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=2e-5,
                               atol=2e-5)


def test_vi_step_matches_reparametrized_oracle():
  """The VI program's first step: per-member negative ELBO over the same
  reparametrized draws and minibatch, and its surrogate gradient."""
  config = _config(width=8)
  dist = likelihoods.LikelihoodDist.NORMAL
  x, y = _data(dist)
  b, s, kl = 32, 3, 0.5
  mesh = mesh_lib.default_mesh()
  surr, opt, keys, _ = vi_lib._make_vi_init_fn(config, 0.01, 8, mesh)(
      jax.random.PRNGKey(0)
  )
  surr0 = jax.tree_util.tree_map(np.asarray, surr)
  keys0 = np.asarray(keys)
  aug = field_lib.aug_features_device(config, x)
  aug_t, target = minibatch_lib.make_layout_fn(N, 1, mesh)(aug, y)
  fn = vi_lib._make_vi_fn(config, dist, 1, b, N, 0.01, s, kl, mesh)
  _, opt1, _, losses = fn(surr, opt, keys, aug_t, target)
  seasonal_x = field_lib.seasonal_features_for(config, jnp.asarray(x))

  def oracle(locs, raws, key):
    _, sample_key, batch_key = jax.random.split(key, 3)
    idx = jax.random.permutation(batch_key, N)[:b]

    def elbo(surrogate):
      locs, raws = surrogate
      scales = vi_lib.surrogate_scales(raws)
      z = vi_lib._surrogate_sample(locs, scales, sample_key, (s,))

      def one(zd):
        pred = field_lib.apply_field(
            config, zd, jnp.asarray(x)[idx], seasonal_x[idx])
        target = priors.prior_log_prob(config, zd) + (
            likelihoods.log_likelihood(dist, zd, pred, jnp.asarray(y)[idx])
            * (N / b) / kl
        )
        return vi_lib._surrogate_log_prob(locs, scales, zd) - target

      return jnp.mean(jax.vmap(one)(z))

    return jax.value_and_grad(elbo)((locs, raws))

  want_l, want_g = jax.vmap(oracle)(surr0[0], surr0[1], keys0)
  np.testing.assert_allclose(
      np.asarray(losses)[:, 0], np.asarray(want_l) * kl, rtol=1e-5
  )
  for m, w in zip(jax.tree_util.tree_leaves(opt1[0].mu),
                  jax.tree_util.tree_leaves(want_g)):
    np.testing.assert_allclose(np.asarray(m) / 0.1, np.asarray(w),
                               rtol=2e-4, atol=2e-5)
