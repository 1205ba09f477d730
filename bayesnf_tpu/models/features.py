"""Spatiotemporal feature encoders.

Math parity with the reference encoders
(`/root/reference/src/bayesnf/models.py:36-88`):

- *Seasonal harmonics*: for periods p_j with h_j harmonics each, frequencies
  {k/p_j : k=1..h_j} are deduplicated (first occurrence kept in order), and
  the features are [cos(2*pi*f*t), sin(2*pi*f*t)] / harmonic_number.
- *Fourier features*: per input dimension with degree d, features are
  [cos(2*pi*2^k*x), sin(2*pi*2^k*x)] / (k+1) for k in [0, d).
- *Interactions*: products of scaled input pairs.

Design note: seasonal features depend only on the raw time column —
NOT on any learned parameter — so they are precomputed once per dataset
(:func:`seasonal_features`) and carried alongside the inputs, instead of
being recomputed inside every training step as the reference does
(reference models.py:223-228 runs inside `mlp.apply` on the hot path).
Fourier and interaction features depend on the learned per-input scale
adjustment, so they are computed in-step (:func:`encode`) where XLA fuses
them into the first matmul.
"""

import numpy as np
import jax
import jax.numpy as jnp


def seasonal_frequency_table(
    seasonality_periods: np.ndarray, num_harmonics: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
  """Return deduplicated (frequencies, harmonic_numbers) for the periods.

  Harmonic k of period p contributes frequency k/p. Duplicate frequencies
  (e.g. harmonic 2 of period 12 == harmonic 1 of period 6) are removed,
  keeping the first occurrence in concatenation order.

  Raises:
    ValueError: if any harmonic count exceeds half its period, if the two
      arrays have different shapes, or if they are not rank 1.
  """
  seasonality_periods = np.asarray(seasonality_periods, dtype=np.float32)
  num_harmonics = np.asarray(num_harmonics)
  if np.any(num_harmonics > seasonality_periods / 2):
    raise ValueError(
        'num_harmonics[i] is capped at seasonality_periods[i] / 2: harmonics '
        'past the Nyquist count alias onto lower ones.'
    )
  if seasonality_periods.shape != num_harmonics.shape:
    raise ValueError(
        f'shape mismatch: {seasonality_periods.shape=} vs '
        f'{num_harmonics.shape=} (one harmonic count per period).'
    )
  if num_harmonics.ndim != 1:
    raise ValueError(
        f'seasonality_periods/num_harmonics must be rank-1 arrays, got '
        f'rank {num_harmonics.ndim}.'
    )
  if seasonality_periods.size == 0:
    return (np.zeros(0), np.zeros(0))
  # First-wins dedup by exact float equality, in concatenation order: e.g.
  # harmonic 2 of period 12 collides with harmonic 1 of period 6 and keeps
  # whichever period was listed first (and that period's harmonic number,
  # which sets the 1/k feature rescale downstream).
  table: dict[float, float] = {}
  for period, count in zip(seasonality_periods, num_harmonics):
    for k in np.arange(1, count + 1, dtype=np.float32):
      table.setdefault(float(k / period), float(k))
  return (
      np.fromiter(table.keys(), dtype=np.float32, count=len(table)),
      np.fromiter(table.values(), dtype=np.float32, count=len(table)),
  )


def seasonal_features(
    t: jax.Array,
    frequencies: np.ndarray | tuple,
    harmonics: np.ndarray | tuple,
    rescale: bool = True,
) -> jnp.ndarray:
  """Seasonal harmonic features of the raw time column.

  Args:
    t: (N,) raw (unscaled) time values.
    frequencies: (F,) deduplicated frequencies from
      :func:`seasonal_frequency_table`.
    harmonics: (F,) harmonic numbers aligned with `frequencies`.
    rescale: divide each cos/sin pair by its harmonic number.

  Returns:
    (N, 2F) array laid out [cos_f1..cos_fF, sin_f1..sin_fF].
  """
  frequencies = jnp.asarray(frequencies, dtype=jnp.float32)
  harmonics = jnp.asarray(harmonics, dtype=jnp.float32)
  if frequencies.shape[0] == 0:
    return jnp.zeros(t.shape[:1] + (0,), dtype=jnp.float32)
  angles = 2.0 * jnp.pi * frequencies * t[..., None]
  feats = jnp.concatenate([jnp.cos(angles), jnp.sin(angles)], axis=-1)
  if rescale:
    feats = feats / jnp.tile(harmonics, 2)
  return feats


def fourier_features(
    x: jax.Array, max_degree: int, rescale: bool = True
) -> jnp.ndarray:
  """Octave Fourier features of one (scaled) input dimension.

  The octave structure (angle_k = 2 * angle_{k-1}) lets every
  octave after the first come from the double-angle recurrence
  (cos2t = 2c^2-1, sin2t = 2sc) — 2 transcendentals + FMAs instead of 2d
  trig calls per element, and a trig-free backward. On the training hot
  path (reference recomputes full cos/sin stacks each step,
  models.py:79-88) this halves the non-matmul step cost.

  Args:
    x: (N,) scaled input values.
    max_degree: number of octaves d; frequencies are 2^k for k in [0, d).
    rescale: divide octave k's cos/sin pair by (k+1).

  Returns:
    (N, 2d) array laid out [cos_0..cos_{d-1}, sin_0..sin_{d-1}].
  """
  if max_degree <= 0:
    return jnp.zeros(x.shape[:1] + (0,), dtype=x.dtype)
  theta = 2.0 * jnp.pi * x
  c, s = jnp.cos(theta), jnp.sin(theta)
  coss, sins = [c], [s]
  for _ in range(max_degree - 1):
    c, s = 2.0 * c * c - 1.0, 2.0 * s * c
    coss.append(c)
    sins.append(s)
  feats = jnp.stack(coss + sins, axis=-1)
  if rescale:
    denom = jnp.tile(jnp.arange(1, max_degree + 1, dtype=x.dtype), 2)
    feats = feats / denom
  return feats


def fourier_features_t(
    x: jax.Array, max_degree: int, rescale: bool = True
) -> jnp.ndarray:
  """Features-major variant of :func:`fourier_features`: (N,) -> (2d, N).

  Rows (not columns) index the cos/sin octaves, so the large N axis stays
  the minor dimension (see `field.apply_field_t`).
  """
  if max_degree <= 0:
    return jnp.zeros((0,) + x.shape, dtype=x.dtype)
  theta = 2.0 * jnp.pi * x
  c, s = jnp.cos(theta), jnp.sin(theta)
  coss, sins = [c], [s]
  for _ in range(max_degree - 1):
    c, s = 2.0 * c * c - 1.0, 2.0 * s * c
    coss.append(c)
    sins.append(s)
  feats = jnp.stack(coss + sins, axis=0)
  if rescale:
    denom = jnp.tile(jnp.arange(1, max_degree + 1, dtype=x.dtype), 2)
    feats = feats / denom[:, None]
  return feats
