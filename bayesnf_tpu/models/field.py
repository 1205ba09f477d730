"""The Bayesian neural field: a functional MLP over encoded coordinates.

Math parity with the reference's Flax module `BayesianNeuralField1D`
(reference `src/bayesnf/models.py:197-273`), redesigned:

- Parameters are a **flat, ordered tuple of arrays** described by
  :func:`param_specs` (a deterministic, documented ordering) instead of a
  Flax FrozenDict re-initialized inside the loss every step
  (reference inference.py:393-395). The same spec table drives the prior,
  the MAP init, the VI surrogate, and checkpointing.
- The ensemble is a *leading vmapped axis of every computation*: `apply_field`
  is written for a single member and vectorized with `jax.vmap`, which XLA
  lowers to batched matmuls.
- Seasonal features (which depend only on raw time, not on any learned
  parameter) are precomputed once and passed in, rather than recomputed
  per training step.

Model structure (per member), matching reference models.py:213-273:

  scaled_x = x / (input_scales * exp(log_scale_adjustment))
  groups   = [scaled_x, fourier(scaled_x_i) per dim, seasonal(t), pairwise
              interaction products], each scaled by softplus(group scale)
  h        = concat(groups)
  for each of `depth` hidden layers:
      h = act( softplus(layer_scale) * Dense_width(h / sqrt(fan_in)) )
  out      = softplus(output_scale) * Dense_1(h / sqrt(width))

  act(x)   = sigmoid(w)*elu(x) + (1-sigmoid(w))*tanh(x), learned logit w.
"""

import functools
import dataclasses
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from bayesnf_tpu.models import features as feat_lib


class ParamSpec(NamedTuple):
  """Metadata for one entry of the flat parameter tuple.

  Attributes:
    name: stable identifier (used by checkpoints and diagnostics).
    shape: per-member array shape.
    prior_loc: location of the elementwise Logistic(loc, 1) prior.
    is_matrix: True for 2-D weight matrices; these are initialized from
      TruncatedNormal(0, 1, -2, 2) while everything else initializes to a
      deterministic constant (reference inference.py:399-427).
  """

  name: str
  shape: tuple
  prior_loc: float
  is_matrix: bool


@dataclasses.dataclass(frozen=True)
class FieldConfig:
  """Static (hashable) model configuration; safe as a jit static argument."""

  width: int
  depth: int
  input_scales: tuple  # (D,) floats; time scale first, 1.0 elsewhere.
  fourier_degrees: tuple  # (D,) ints.
  interactions: tuple  # ((i, j), ...) input-dim index pairs.
  seasonal_frequencies: tuple  # (F,) deduplicated floats.
  seasonal_harmonics: tuple  # (F,) harmonic numbers aligned with frequencies.

  @classmethod
  def create(
      cls,
      *,
      width: int,
      depth: int,
      input_scales,
      fourier_degrees,
      interactions,
      seasonality_periods,
      num_seasonal_harmonics,
  ) -> 'FieldConfig':
    """Build a config from reference-style model args (host-side)."""
    freqs, harms = feat_lib.seasonal_frequency_table(
        np.asarray(seasonality_periods), np.asarray(num_seasonal_harmonics)
    )
    interactions = np.asarray(interactions, dtype=int).reshape(-1, 2)
    return cls(
        width=int(width),
        depth=int(depth),
        input_scales=tuple(float(s) for s in np.asarray(input_scales)),
        fourier_degrees=tuple(int(d) for d in np.asarray(fourier_degrees)),
        interactions=tuple((int(i), int(j)) for i, j in interactions),
        seasonal_frequencies=tuple(float(f) for f in freqs),
        seasonal_harmonics=tuple(float(h) for h in harms),
    )

  @property
  def num_inputs(self) -> int:
    return len(self.input_scales)

  @property
  def num_seasonal_features(self) -> int:
    return 2 * len(self.seasonal_frequencies)

  @property
  def num_feature_groups(self) -> int:
    """Non-empty feature groups, in reference order (models.py:242-251)."""
    groups = 1  # scaled_x (always non-empty)
    groups += sum(1 for d in self.fourier_degrees if d > 0)
    groups += 1 if self.seasonal_frequencies else 0
    groups += 1 if self.interactions else 0
    return groups

  @property
  def encoded_dim(self) -> int:
    """Width of the encoded feature vector fed to the first dense layer."""
    return (
        self.num_inputs
        + 2 * sum(d for d in self.fourier_degrees if d > 0)
        + self.num_seasonal_features
        + len(self.interactions)
    )


# Indices of the fixed leading entries of the flat params tuple.
IDX_LOG_NOISE_SCALE = 0
IDX_NB_SHAPE_RAW = 1
IDX_ZINB_LOGIT = 2
IDX_LOG_SCALE_ADJ = 3
IDX_FEATURE_SCALES = 4
IDX_ACTIVATION_LOGIT = 5
IDX_LAYER_SCALES = 6
IDX_FIRST_DENSE = 7  # kernels/biases follow: (W_0, b_0, ..., W_out, b_out)


def param_specs(config: FieldConfig) -> tuple[ParamSpec, ...]:
  """The authoritative flat parameter ordering for a field model.

  Layout (one entry per tuple slot):
    0: log_noise_scale   ()            Normal-likelihood noise (pre-exp).
    1: nb_shape_raw      ()            NB shape (pre-softplus), prior loc -1.5.
    2: zinb_logit        ()            Zero-inflation logit.
    3: log_scale_adjustment (D,)       Learned per-input scale (pre-exp).
    4: feature_scales_raw (G,)         Per-feature-group scale (pre-softplus).
    5: activation_logit  ()            Blend between elu and tanh.
    6: layer_scales_raw  (depth+1,)    Hidden layer scales + output scale
                                       (pre-softplus).
    7..: (W_0, b_0, W_1, b_1, ..., W_out, b_out) dense layers; W_0 is
         (encoded_dim, width), inner layers (width, width), output (width, 1).
  """
  d = config.num_inputs
  specs = [
      ParamSpec('log_noise_scale', (), 0.0, False),
      ParamSpec('nb_shape_raw', (), -1.5, False),
      ParamSpec('zinb_logit', (), 0.0, False),
      ParamSpec('log_scale_adjustment', (d,), 0.0, False),
      ParamSpec('feature_scales_raw', (config.num_feature_groups,), 0.0, False),
      ParamSpec('activation_logit', (), 0.0, False),
      ParamSpec('layer_scales_raw', (config.depth + 1,), 0.0, False),
  ]
  fan_in = config.encoded_dim
  for layer in range(config.depth):
    specs.append(ParamSpec(f'kernel_{layer}', (fan_in, config.width), 0.0, True))
    specs.append(ParamSpec(f'bias_{layer}', (config.width,), 0.0, False))
    fan_in = config.width
  specs.append(ParamSpec('kernel_out', (fan_in, 1), 0.0, True))
  specs.append(ParamSpec('bias_out', (1,), 0.0, False))
  return tuple(specs)


def init_params(
    config: FieldConfig,
    key: jax.Array,
    log_noise_scale_init: jax.typing.ArrayLike = 0.0,
    dtype=jnp.float32,
) -> tuple[jax.Array, ...]:
  """Initialize one ensemble member's parameters.

  Matches the reference init scheme (inference.py:399-427): weight matrices
  draw from TruncatedNormal(0, 1, -2, 2); the noise scale starts at
  `log_noise_scale_init` (callers pass log(std(y)/2)); everything else is 0.
  """
  specs = param_specs(config)
  keys = jax.random.split(key, len(specs))
  out = []
  for spec, k in zip(specs, keys):
    if spec.is_matrix:
      out.append(
          jax.random.truncated_normal(k, -2.0, 2.0, spec.shape, dtype=dtype)
      )
    elif spec.name == 'log_noise_scale':
      out.append(jnp.full(spec.shape, log_noise_scale_init, dtype=dtype))
    else:
      out.append(jnp.zeros(spec.shape, dtype=dtype))
  return tuple(out)


@jax.custom_jvp
def blended_act(z: jax.Array, w: jax.Array) -> jax.Array:
  """w * elu(z) + (1 - w) * tanh(z).

  elu costs one exp on the negative branch. The custom JVP derives both derivatives from
  the forward's own values (elu' = elu + 1 for z < 0, tanh' = 1 - tanh^2),
  so the backward needs no additional transcendentals.
  """
  q = jnp.exp(jnp.minimum(z, 0.0))
  e = jnp.where(z > 0, z, q - 1.0)
  t = jnp.tanh(z)
  return w * e + (1.0 - w) * t


@blended_act.defjvp
def _blended_act_jvp(primals, tangents):
  z, w = primals
  dz, dw = tangents
  q = jnp.exp(jnp.minimum(z, 0.0))
  e = jnp.where(z > 0, z, q - 1.0)
  t = jnp.tanh(z)
  de = jnp.where(z > 0, jnp.ones_like(z), q)
  dt = 1.0 - t * t
  val = w * e + (1.0 - w) * t
  dval = (w * de + (1.0 - w) * dt) * dz + (e - t) * dw
  return val, dval


def _blend_activation(h: jax.Array, activation_logit: jax.Array) -> jax.Array:
  w = jax.nn.sigmoid(activation_logit)
  return blended_act(h, w)


def encode(
    config: FieldConfig,
    params: tuple,
    x: jax.Array,
    seasonal: jax.Array,
) -> jax.Array:
  """Encode raw inputs into the feature vector fed to the first dense layer.

  Args:
    config: static model config.
    params: flat parameter tuple (single member).
    x: (N, D) raw feature matrix (post data-handler scaling).
    seasonal: (N, 2F) precomputed seasonal features of the raw time column
      (see :func:`bayesnf_tpu.models.features.seasonal_features`).

  Returns:
    (N, encoded_dim) feature matrix.
  """
  input_scales = jnp.asarray(config.input_scales, dtype=x.dtype)
  lsa = params[IDX_LOG_SCALE_ADJ]
  scaled_x = x / (input_scales * jnp.exp(lsa))

  groups = [scaled_x]
  for i, degree in enumerate(config.fourier_degrees):
    if degree > 0:
      groups.append(feat_lib.fourier_features(scaled_x[:, i], degree))
  if config.seasonal_frequencies:
    groups.append(seasonal)
  if config.interactions:
    inter_idx = jnp.asarray(config.interactions, dtype=jnp.int32)
    groups.append(jnp.prod(scaled_x[:, inter_idx], axis=-1))

  group_scales = jax.nn.softplus(params[IDX_FEATURE_SCALES])
  scaled_groups = [g * group_scales[i] for i, g in enumerate(groups)]
  return jnp.concatenate(scaled_groups, axis=-1)


def apply_field(
    config: FieldConfig,
    params: tuple,
    x: jax.Array,
    seasonal: jax.Array,
    compute_dtype=None,
) -> jax.Array:
  """Forward pass of one ensemble member: (N, D) inputs -> (N,) predictions.

  Vectorize over the ensemble with `jax.vmap(apply_field, (None, 0, None,
  None))`; XLA lowers the per-member matmuls to one batched matmul.

  Args:
    compute_dtype: optional matmul operand precision: `jnp.bfloat16` for
      explicit bf16 operands, or the string 'highest' for exact f32 dots.
      Parameters stay f32 and every dot accumulates in f32
      (`preferred_element_type`). None (default) runs at JAX's default
      matmul precision, which on an H100 may compute f32 dots as TF32.
  """
  h = encode(config, params, x, seasonal)

  layer_scales = jax.nn.softplus(params[IDX_LAYER_SCALES])
  activation_logit = params[IDX_ACTIVATION_LOGIT]

  if compute_dtype not in (None, jnp.bfloat16, 'highest'):
    raise ValueError(f'Unsupported compute_dtype: {compute_dtype}')

  from bayesnf_tpu.ops import mixed

  def dense(h, kernel, bias):
    if compute_dtype == 'highest':
      # Multi-pass true-f32 dots, fusion-fenced like the other paths.
      return mixed.matmul_highest(h, kernel) + bias
    if compute_dtype is not None:
      # Custom-VJP matmul: forward AND backward run with bf16 operands
      # (a plain cast only accelerates the forward; see ops/mixed.py).
      return mixed.matmul_bf16(h, kernel) + bias
    # f32 matmul with fusion-fenced backward dots (see ops/mixed.py).
    return mixed.matmul_f32(h, kernel) + bias

  slot = IDX_FIRST_DENSE
  for layer in range(config.depth):
    kernel, bias = params[slot], params[slot + 1]
    slot += 2
    # 1/sqrt(fan_in) scaling == scaling the weight-prior variance by
    # 1/fan_in (reference models.py:267).
    h = h * jax.lax.rsqrt(jnp.asarray(h.shape[-1], dtype=h.dtype))
    h = _blend_activation(layer_scales[layer] * dense(h, kernel, bias),
                          activation_logit)

  kernel, bias = params[slot], params[slot + 1]
  h = h * jax.lax.rsqrt(jnp.asarray(h.shape[-1], dtype=h.dtype))
  out = dense(h, kernel, bias)
  return layer_scales[config.depth] * out[..., 0]


def seasonal_features_for(config: FieldConfig, x: jax.Array) -> jax.Array:
  """Precompute the (N, 2F) seasonal features for raw inputs `x` (N, D)."""
  return feat_lib.seasonal_features(
      x[:, 0],
      np.asarray(config.seasonal_frequencies),
      np.asarray(config.seasonal_harmonics),
      rescale=True,
  )


def aug_features(config: FieldConfig, x: jax.Array) -> jax.Array:
  """`[x | seasonal features]`, traceable — THE encode composition.

  Every consumer (fit-time setup, the in-memory predictor, the streamed
  predictor's pass-1 program) must append seasonal features through this
  one definition: the streamed-vs-in-memory bit-identity contract and
  train/predict feature agreement depend on the ordering and math being
  identical at every site.
  """
  return jnp.concatenate([x, seasonal_features_for(config, x)], axis=-1)


@functools.partial(jax.jit, static_argnames=('config',))
def _aug_features_jit(config, x):
  return aug_features(config, x)


def aug_features_device(config: FieldConfig, x) -> jax.Array:
  """`[x | seasonal features]` as ONE jitted device program.

  The eager composition (sin/cos/scale/concat primitive by primitive)
  costs a dozen separate compilations, so fit-time setup uses this single
  program instead.
  """
  return _aug_features_jit(config, jnp.asarray(x, dtype=jnp.float32))


def aug_features_host(
    config: FieldConfig, x, block_rows: int = 1 << 20, out=None
) -> np.ndarray:
  """Host (numpy) `[x | seasonal features]`, assembled in bounded blocks.

  The streaming trainers keep the dataset in host RAM, so the augmented
  matrix must never exist as one device array; seasonal features are
  computed `block_rows` rows at a time on the default device (exactly the
  math of `seasonal_features_for`) and written into a host buffer.

  `out`: optional preallocated float32 (N, D + 2F) destination — pass a
  `np.memmap` to assemble the augmented matrix ON DISK for datasets
  larger than host RAM (the streaming trainers gather batch rows from it
  directly; `x` itself may also be a memmap).
  """
  x = np.asarray(x, dtype=np.float32) if not isinstance(x, np.memmap) else x
  n, d = x.shape
  f2 = 2 * len(tuple(np.asarray(config.seasonal_frequencies).reshape(-1)))
  if out is None:
    out = np.empty((n, d + f2), dtype=np.float32)
  elif out.shape != (n, d + f2) or out.dtype != np.float32:
    raise ValueError(
        f'out must be float32 of shape {(n, d + f2)}; got '
        f'{out.dtype} {out.shape}.'
    )
  out[:, :d] = x
  for lo in range(0, n, block_rows):
    blk = x[lo : lo + block_rows]
    out[lo : lo + block_rows, d:] = np.asarray(
        seasonal_features_for(config, jnp.asarray(blk))
    )
  return out


# ---------------------------------------------------------------------------
# Transposed (features-major) formulation: the trainers' and predictor's
# hot path. Laying the computation out as (features, rows) keeps the large
# row dimension minor, so every dense layer is one (width, fan_in) @
# (fan_in, rows) matmul per member and the few-feature encode temporaries
# stay dense. `apply_field_t` is numerically identical to `apply_field`
# up to matmul reassociation (tested).
# ---------------------------------------------------------------------------


def encode_t(
    config: FieldConfig,
    params: tuple,
    x_t: jax.Array,
    seasonal_t: jax.Array,
) -> jax.Array:
  """Features-major encode: (D, N) inputs -> (encoded_dim, N)."""
  input_scales = jnp.asarray(config.input_scales, dtype=x_t.dtype)
  lsa = params[IDX_LOG_SCALE_ADJ]
  scaled_x = x_t / (input_scales * jnp.exp(lsa))[:, None]

  groups = [scaled_x]
  for i, degree in enumerate(config.fourier_degrees):
    if degree > 0:
      groups.append(feat_lib.fourier_features_t(scaled_x[i], degree))
  if config.seasonal_frequencies:
    groups.append(seasonal_t)
  if config.interactions:
    inter_idx = jnp.asarray(config.interactions, dtype=jnp.int32)
    groups.append(jnp.prod(scaled_x[inter_idx, :], axis=1))

  group_scales = jax.nn.softplus(params[IDX_FEATURE_SCALES])
  return jnp.concatenate(
      [g * group_scales[i] for i, g in enumerate(groups)], axis=0
  )


def apply_field_t(
    config: FieldConfig,
    params: tuple,
    x_t: jax.Array,
    seasonal_t: jax.Array,
    compute_dtype=None,
) -> jax.Array:
  """Features-major forward: (D, N) inputs -> (N,) predictions.

  Same math as :func:`apply_field`; hidden states live as (width, N) so the
  minor dimension is always the (large) row axis.
  """
  from bayesnf_tpu.ops import mixed

  h = encode_t(config, params, x_t, seasonal_t)

  layer_scales = jax.nn.softplus(params[IDX_LAYER_SCALES])
  activation_logit = params[IDX_ACTIVATION_LOGIT]

  def dense_t(h, kernel, bias):
    # (width, fan_in) @ (fan_in, N); the kernel transpose is tiny.
    if compute_dtype == 'highest':
      return mixed.matmul_highest(kernel.T, h) + bias[:, None]
    if compute_dtype is not None:
      return mixed.matmul_bf16(kernel.T, h) + bias[:, None]
    return mixed.matmul_f32(kernel.T, h) + bias[:, None]

  slot = IDX_FIRST_DENSE
  for layer in range(config.depth):
    kernel, bias = params[slot], params[slot + 1]
    slot += 2
    h = h * jax.lax.rsqrt(jnp.asarray(h.shape[0], dtype=h.dtype))
    h = _blend_activation(
        layer_scales[layer] * dense_t(h, kernel, bias), activation_logit
    )

  kernel, bias = params[slot], params[slot + 1]
  h = h * jax.lax.rsqrt(jnp.asarray(h.shape[0], dtype=h.dtype))
  out = dense_t(h, kernel, bias)
  return layer_scales[config.depth] * out[0, :]
