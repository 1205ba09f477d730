"""Likelihood and distribution tests against scipy ground truth."""

import numpy as np
import jax
import jax.numpy as jnp
import scipy.stats

from bayesnf_tpu.models import distributions as dist_lib
from bayesnf_tpu.models import likelihoods
from bayesnf_tpu.ops import special


def _scalar_params(log_noise=0.3, nb_shape_raw=-1.0, zinb_logit=-0.7):
  """Minimal params tuple: only the three leading scalars are read."""
  return (
      jnp.asarray(log_noise),
      jnp.asarray(nb_shape_raw),
      jnp.asarray(zinb_logit),
  )


class TestSpecial:

  def test_logistic_log_prob(self):
    x = np.linspace(-4, 4, 21)
    got = np.asarray(special.logistic_log_prob(x, loc=-1.5, scale=1.0))
    want = scipy.stats.logistic.logpdf(x, loc=-1.5, scale=1.0)
    np.testing.assert_allclose(got, want, rtol=1e-6)

  def test_softplus_inverse(self):
    y = np.array([0.1, 0.3, 1.0, 5.0])
    x = np.asarray(special.softplus_inverse(y))
    np.testing.assert_allclose(np.logaddexp(0, x), y, rtol=1e-6)

  def test_log_softplus_stable(self):
    x = jnp.array([-200.0, -50.0, -10.0, 0.0, 10.0, 100.0])
    got = np.asarray(special.log_softplus(x))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[0], -200.0)
    np.testing.assert_allclose(
        got[2:], np.log(np.logaddexp(0, np.asarray(x[2:]))), rtol=1e-6
    )
    grads = np.asarray(jax.vmap(jax.grad(special.log_softplus))(x))
    assert np.all(np.isfinite(grads))

  def test_normal_log_prob_cdf_and_quantile_vs_scipy(self):
    x = np.linspace(-6, 6, 49)
    np.testing.assert_allclose(
        np.asarray(special.normal_log_prob(x, 0.7, 1.9)),
        scipy.stats.norm.logpdf(x, 0.7, 1.9), rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(special.normal_cdf(x, 0.7, 1.9)),
        scipy.stats.norm.cdf(x, 0.7, 1.9), rtol=1e-5, atol=1e-7,
    )
    q = np.array([0.025, 0.2, 0.5, 0.9, 0.975])
    np.testing.assert_allclose(
        np.asarray(special.normal_quantile(q, 0.7, 1.9)),
        scipy.stats.norm.ppf(q, 0.7, 1.9), rtol=1e-5,
    )

  def test_nb_log_prob_gradient_vs_digamma(self):
    # The NB trainers differentiate nb_log_prob through lax.lgamma; its
    # total_count gradient must be the closed form
    # digamma(r + x) - digamma(r) + log_sigmoid(-logits), including the
    # huge total_counts a diverging shape parameter produces.
    x = np.arange(0, 40, 3).astype(np.float32)
    logits = np.float32(-0.4)
    for r in (0.3, 2.5, 40.0, 1e5):
      got = np.asarray(jax.vmap(
          jax.grad(special.nb_log_prob, argnums=1), in_axes=(0, None, None)
      )(x, np.float32(r), logits))
      want = (
          scipy.special.digamma(r + x.astype(np.float64))
          - scipy.special.digamma(r)
          - np.logaddexp(0.0, float(logits))
      )
      assert np.all(np.isfinite(got))
      np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4,
                                 err_msg=str(r))

  def test_nb_log_prob_vs_scipy(self):
    # My pmf: C(x + r - 1, x) * sigmoid(-l)^r * sigmoid(l)^x
    # == scipy.stats.nbinom(n=r, p=sigmoid(-l)).pmf(x).
    r, l = 2.5, -0.4
    x = np.arange(0, 20).astype(float)
    got = np.asarray(special.nb_log_prob(x, r, l))
    p_fail = 1.0 / (1.0 + np.exp(l))
    want = scipy.stats.nbinom.logpmf(x, r, p_fail)
    np.testing.assert_allclose(got, want, rtol=1e-5)

  def test_nb_cdf_vs_scipy_at_integers(self):
    r, l = 3.0, 0.2
    x = np.array([0.0, 1.0, 2.0, 10.0])
    got = np.asarray(special.nb_cdf(x, r, l))
    p_fail = 1.0 / (1.0 + np.exp(l))
    want = scipy.stats.nbinom.cdf(x, r, p_fail)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert float(special.nb_cdf(-1.0, r, l)) == 0.0

  def test_nb_cdf_continuous_between_integers(self):
    # TFP semantics: continuous interpolation in x (no floor), so the
    # quantile root-finder + ceil lands on the exact integer quantile.
    r, l = 3.0, 0.2
    xs = np.linspace(0.0, 6.0, 61)
    vals = np.asarray(special.nb_cdf(xs, r, l))
    assert np.all(np.diff(vals) > 0)  # strictly increasing, not a step fn

  def test_nb_moments_vs_scipy(self):
    r, l = 4.0, -0.3
    p_fail = 1.0 / (1.0 + np.exp(l))
    np.testing.assert_allclose(
        float(special.nb_mean(r, l)),
        scipy.stats.nbinom.mean(r, p_fail),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(special.nb_variance(r, l)),
        scipy.stats.nbinom.var(r, p_fail),
        rtol=1e-6,
    )


class TestLogLikelihood:

  def test_normal(self):
    params = _scalar_params(log_noise=0.5)
    pred = jnp.array([1.0, -2.0, 0.3])
    y = jnp.array([1.2, -1.7, 0.0])
    got = float(
        likelihoods.log_likelihood(
            likelihoods.LikelihoodDist.NORMAL, params, pred, y
        )
    )
    scale = 0.01 + np.exp(0.5)
    want = scipy.stats.norm.logpdf(
        np.asarray(y), np.asarray(pred), scale
    ).sum()
    np.testing.assert_allclose(got, want, rtol=1e-5)

  def test_nb(self):
    params = _scalar_params(nb_shape_raw=-1.0)
    pred = jnp.array([2.0, 0.5])
    y = jnp.array([3.0, 0.0])
    got = float(
        likelihoods.log_likelihood(
            likelihoods.LikelihoodDist.NB, params, pred, y
        )
    )
    shape = np.logaddexp(0, -1.0)
    r = 1.0 / shape
    mean = np.logaddexp(0, np.asarray(pred))
    logits = -np.log(shape) - np.log(mean)
    p_fail = 1.0 / (1.0 + np.exp(logits))
    want = scipy.stats.nbinom.logpmf(np.asarray(y), r, p_fail).sum()
    np.testing.assert_allclose(got, want, rtol=1e-4)

  def test_zinb_zero_vs_nonzero(self):
    params = _scalar_params(nb_shape_raw=-1.0, zinb_logit=0.2)
    pred = jnp.array([1.0])
    pi = 1.0 / (1.0 + np.exp(-0.2))
    lp_zero = float(
        likelihoods.log_likelihood(
            likelihoods.LikelihoodDist.ZINB, params, pred, jnp.array([0.0])
        )
    )
    lp_nb_zero = float(
        likelihoods.log_likelihood(
            likelihoods.LikelihoodDist.NB, params, pred, jnp.array([0.0])
        )
    )
    np.testing.assert_allclose(
        lp_zero, np.logaddexp(np.log(pi), np.log1p(-pi) + lp_nb_zero), rtol=1e-5
    )
    lp_three = float(
        likelihoods.log_likelihood(
            likelihoods.LikelihoodDist.ZINB, params, pred, jnp.array([3.0])
        )
    )
    lp_nb_three = float(
        likelihoods.log_likelihood(
            likelihoods.LikelihoodDist.NB, params, pred, jnp.array([3.0])
        )
    )
    np.testing.assert_allclose(lp_three, np.log1p(-pi) + lp_nb_three, rtol=1e-5)

  def test_forecast_params_shapes(self):
    params = _scalar_params()
    pred = jnp.zeros(5)
    loc, scale = likelihoods.forecast_params(
        likelihoods.LikelihoodDist.NORMAL, params, pred
    )
    assert loc.shape == (5,) and scale.shape == ()
    tc, logits = likelihoods.forecast_params(
        likelihoods.LikelihoodDist.NB, params, pred
    )
    assert tc.shape == () and logits.shape == (5,)
    tc, logits, pi = likelihoods.forecast_params(
        likelihoods.LikelihoodDist.ZINB, params, pred
    )
    assert pi.shape == (5,)


class TestDistributionObjects:

  def test_normal_roundtrip(self):
    d = dist_lib.Normal(jnp.array([1.0, 2.0]), jnp.array([0.5, 2.0]))
    np.testing.assert_allclose(
        np.asarray(d.quantile(d.cdf(jnp.array([1.3, -0.7])))),
        [1.3, -0.7],
        rtol=1e-5,
    )

  def test_nb_sampling_moments(self):
    d = dist_lib.NegativeBinomial(jnp.asarray(5.0), jnp.asarray(0.3))
    s = np.asarray(d.sample(jax.random.PRNGKey(0), (20000,)))
    np.testing.assert_allclose(s.mean(), float(d.mean()), rtol=0.05)
    np.testing.assert_allclose(s.std(), float(d.stddev()), rtol=0.05)

  def test_zinb_mean_and_cdf(self):
    nb = dist_lib.NegativeBinomial(jnp.asarray(5.0), jnp.asarray(0.3))
    zi = dist_lib.ZeroInflatedNegativeBinomial(
        jnp.asarray(5.0), jnp.asarray(0.3), jnp.asarray(0.25)
    )
    np.testing.assert_allclose(float(zi.mean()), 0.75 * float(nb.mean()), rtol=1e-6)
    np.testing.assert_allclose(
        float(zi.cdf(3.0)), 0.25 + 0.75 * float(nb.cdf(3.0)), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(zi.prob(0.0)), 0.25 + 0.75 * float(nb.prob(0.0)), rtol=1e-6
    )

  def test_independent_sums_log_prob(self):
    d = dist_lib.Independent(
        dist_lib.Normal(jnp.zeros((3, 4)), jnp.ones((3, 4))), 1
    )
    lp = d.log_prob(jnp.zeros((3, 4)))
    assert lp.shape == (3,)
    np.testing.assert_allclose(
        np.asarray(lp), 4 * scipy.stats.norm.logpdf(0.0), rtol=1e-6
    )

  def test_independent_prob_and_cdf_reduce_event_axes(self):
    """prob must equal exp(log_prob) on the same object, and the joint
    CDF of independent components is the product over the event axes
    (both reduce, as in TFP's Independent)."""
    base = dist_lib.Normal(jnp.zeros(4), jnp.ones(4))
    d = dist_lib.Independent(base, 1)
    x = jnp.array([0.1, -0.2, 0.3, 0.0])
    assert d.prob(x).shape == ()
    np.testing.assert_allclose(
        np.asarray(d.prob(x)), np.exp(np.asarray(d.log_prob(x))), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(d.cdf(x)), np.prod(np.asarray(base.cdf(x))), rtol=1e-6
    )

  def test_zinb_sample_broadcasts_pi_into_batch(self):
    """inflated_loc_probs participates in the sample's batch shape (TFP
    semantics), and the widened draws are independent, not aliased."""
    z = dist_lib.ZeroInflatedNegativeBinomial(
        jnp.asarray(5.0), jnp.asarray(0.0), jnp.full((10,), 0.3)
    )
    assert z.sample(jax.random.PRNGKey(0)).shape == (10,)
    assert z.sample(jax.random.PRNGKey(0), (7,)).shape == (7, 10)
    no_inflate = dist_lib.ZeroInflatedNegativeBinomial(
        jnp.asarray(50.0), jnp.asarray(0.0), jnp.zeros((64,))
    )
    draws = np.asarray(no_inflate.sample(jax.random.PRNGKey(1)))
    assert len(np.unique(draws)) > 10, draws
