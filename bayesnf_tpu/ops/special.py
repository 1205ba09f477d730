"""Numerical special functions used across the framework.

Self-contained (no TFP): branch-free, vectorized, XLA-friendly
implementations suitable for use inside jit/vmap/scan.
"""

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp_special


def softplus_inverse(y):
  """Inverse of softplus: x such that log(1 + e^x) = y.

  Stable form: x = y + log(1 - e^(-y)) = y + log(-expm1(-y)).
  """
  return y + jnp.log(-jnp.expm1(-y))


def log_softplus(x):
  """Numerically stable log(softplus(x)).

  For x << 0, softplus(x) ~= e^x underflows in f32 around x < -88, so
  log(softplus(x)) would hit log(0) = -inf with NaN gradients; there
  log(softplus(x)) ~= x to within e^x. Elsewhere the direct form is exact.
  The unsafe branch's input is clamped so the unselected `where` branch
  stays finite (avoids 0 * inf = NaN in the gradient).
  """
  safe_x = jnp.maximum(x, -20.0)
  return jnp.where(x < -20.0, x, jnp.log(jax.nn.softplus(safe_x)))


def logistic_log_prob(x, loc=0.0, scale=1.0):
  """Elementwise log-density of Logistic(loc, scale).

  log p(x) = -z - 2*softplus(-z) - log(scale), z = (x - loc)/scale.
  """
  z = (x - loc) / scale
  return -z - 2.0 * jax.nn.softplus(-z) - jnp.log(scale)


def normal_log_prob(x, loc, scale):
  """Elementwise log-density of Normal(loc, scale)."""
  z = (x - loc) / scale
  return -0.5 * z * z - 0.5 * jnp.log(2.0 * jnp.pi) - jnp.log(scale)


def normal_cdf(x, loc=0.0, scale=1.0):
  return jsp_special.ndtr((x - loc) / scale)


def normal_quantile(q, loc=0.0, scale=1.0):
  return loc + scale * jsp_special.ndtri(q)


def nb_log_prob(x, total_count, logits):
  """Elementwise Negative Binomial log-pmf, TFP parametrization.

  log p(x) = lgamma(r + x) - lgamma(1 + x) - lgamma(r)
             + r*log_sigmoid(-logits) + x*log_sigmoid(logits)

  with r = total_count. Matches the distribution the reference constructs via
  `tfd.NegativeBinomial(total_count, logits)` (reference models.py:173-175).
  """
  r = total_count
  return (
      jsp_special.gammaln(r + x)
      - jsp_special.gammaln(1.0 + x)
      - jsp_special.gammaln(r)
      + r * jax.nn.log_sigmoid(-logits)
      + x * jax.nn.log_sigmoid(logits)
  )


def nb_mean(total_count, logits):
  """Mean of the TFP-parametrized Negative Binomial: r * exp(logits)."""
  return total_count * jnp.exp(logits)


def nb_variance(total_count, logits):
  """Variance: mean / sigmoid(-logits)."""
  return nb_mean(total_count, logits) / jax.nn.sigmoid(-logits)


def nb_cdf(x, total_count, logits):
  """CDF of the Negative Binomial at (real-valued) x.

  P(X <= x) = I_{sigmoid(-logits)}(total_count, 1 + x), the regularized
  incomplete beta function, evaluated *continuously* in x (no floor) —
  matching TFP's `NegativeBinomial.cdf`. The continuity matters for the
  quantile engine: root-finding on a continuous CDF followed by `ceil`
  recovers the exact integer quantile, whereas a floored step-CDF roots
  just above the integer and ceils one too high. At integer x both forms
  agree. Negative x gives 0.
  """
  safe_x = jnp.maximum(x, 0.0)
  cdf = jsp_special.betainc(total_count, 1.0 + safe_x, jax.nn.sigmoid(-logits))
  return jnp.where(x < 0, jnp.zeros_like(cdf), cdf)
