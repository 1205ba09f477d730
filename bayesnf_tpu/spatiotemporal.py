"""Public estimator API: BayesianNeuralField{MAP,MLE,VI}.

Surface parity with the reference estimators
(`/root/reference/src/bayesnf/spatiotemporal.py:195-648`): identical
constructor keywords, `fit(table, seed, ...)`, `predict(table, quantiles,
approximate_quantiles)`, and `likelihood_model(table)`, with the same
`(num_devices, [num_samples,] ensemble_size // num_devices, ...)` shape
contract on `params_`, `losses_`, and predicted means.

Differences (improvements) over the reference:

- Any `ensemble_size >= 1` works on any device count (reference issue #28);
  when the ensemble does not divide the device count the public group shape
  degrades gracefully to `(1, ensemble_size)`.
- `fit` accepts an optional explicit `mesh` (('ens', 'data')
  `jax.sharding.Mesh`) for multi-chip ensemble x data sharding.
- `likelihood_model` returns a lightweight JAX-native distribution object
  (`bayesnf_tpu.models.distributions`) rather than a TFP distribution; it
  supports `mean/stddev/variance/log_prob/prob/cdf/sample`.
"""

from collections.abc import Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from bayesnf_tpu.calendar import seasonalities_to_array
from bayesnf_tpu.calendar import seasonality_to_float  # noqa: F401  (public)
from bayesnf_tpu.data import SpatiotemporalDataHandler
from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.inference import predict as predict_lib
from bayesnf_tpu.inference import vi as vi_lib
from bayesnf_tpu.models import distributions as dist_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods


def _as_key(seed) -> jax.Array:
  if isinstance(seed, int) or (
      isinstance(seed, np.integer)
  ):
    return jax.random.PRNGKey(int(seed))
  return seed


def _group_shape(ensemble_size: int, mesh=None) -> tuple[int, int]:
  """Public (num_devices, per_device) factorization of the member axis.

  Derived from the mesh the fit actually ran on (its total device count),
  not the process-global device count — a fit on a custom sub-mesh keeps a
  `params_` group shape consistent with its own compute layout.
  """
  num_devices = mesh.size if mesh is not None else jax.device_count()
  if ensemble_size % num_devices == 0:
    return (num_devices, ensemble_size // num_devices)
  return (1, ensemble_size)


class BayesianNeuralFieldEstimator:
  """Base class for the BayesNF estimators.

  Do not instantiate directly; use one of:

  - :class:`BayesianNeuralFieldMAP` — stochastic MAP ensembles.
  - :class:`BayesianNeuralFieldMLE` — stochastic MLE ensembles.
  - :class:`BayesianNeuralFieldVI` — ensembles of mean-field surrogate
    posteriors from variational inference.
  """

  _ensemble_dims: int
  _prior_weight: float = 1.0
  _scale_epochs_by_batch_size: bool = False

  def __init__(
      self,
      *,
      feature_cols: Sequence[str],
      target_col: str,
      seasonality_periods: Sequence[float | str] | None = None,
      num_seasonal_harmonics: Sequence[int] | None = None,
      fourier_degrees: Sequence[float] | None = None,
      interactions: Sequence[tuple[int, int]] | None = None,
      freq: str | None = None,
      timetype: str = 'index',
      depth: int = 2,
      width: int = 512,
      observation_model: str = 'NORMAL',
      standardize: Sequence[str] | None = None,
  ):
    """Shared initialization; keyword semantics match the reference API.

    Args:
      feature_cols: column names; the first is the time variable.
      target_col: name of the target column.
      seasonality_periods: seasonal periods, as floats (multiples of `freq`)
        or pandas frequency aliases (with `timetype='index'`).
      num_seasonal_harmonics: harmonics per seasonal period
        (`timetype='index'` only).
      fourier_degrees: Fourier degree per feature column (default 5 each).
      interactions: pairs of feature-column indices to multiply.
      freq: pandas frequency alias of the data (iff `timetype='index'`).
      timetype: 'index' (datetime column) or 'float'.
      depth: hidden layers.
      width: hidden units per layer.
      observation_model: 'NORMAL' | 'NB' | 'ZINB'.
      standardize: columns to z-score with train stats (not the time column).
    """
    self.num_seasonal_harmonics = num_seasonal_harmonics
    self.seasonality_periods = seasonality_periods
    self.observation_model = observation_model
    self.depth = depth
    self.width = width
    self.feature_cols = feature_cols
    self.target_col = target_col
    self.timetype = timetype
    self.freq = freq
    self.fourier_degrees = fourier_degrees
    self.standardize = standardize
    self.interactions = interactions

    self.losses_ = None
    self.surrogate_ = None
    self.params_ = None
    self.mesh_ = None
    self.data_handler = SpatiotemporalDataHandler(
        self.feature_cols,
        self.target_col,
        self.timetype,
        self.freq,
        standardize=self.standardize,
    )

  # -- Hyperparameter resolution (parity: spatiotemporal.py:296-370) --------

  def _get_fourier_degrees(self, batch_shape) -> np.ndarray:
    if self.fourier_degrees is None:
      fourier_degrees = np.full(batch_shape[-1], 5, dtype=int)
    else:
      fourier_degrees = np.atleast_1d(self.fourier_degrees).astype(int)
      if fourier_degrees.shape[-1] != batch_shape[-1]:
        raise ValueError(
            f'Got {fourier_degrees.shape[-1]} fourier_degrees for '
            f'{batch_shape[-1]} feature columns; one degree per column is '
            'required.'
        )
    return fourier_degrees

  def _get_interactions(self) -> np.ndarray:
    if self.interactions is None:
      interactions = np.zeros((0, 2), dtype=int)
    else:
      interactions = np.array(self.interactions).astype(int)
      if np.ndim(interactions) != 2 or interactions.shape[-1] != 2:
        raise ValueError(
            '`interactions` must be a sequence of (i, j) feature-column '
            f'index pairs — an integer array of shape (N, 2); got shape '
            f'{interactions.shape}.'
        )
    return interactions

  def _get_seasonality_periods(self) -> np.ndarray:
    if (self.timetype == 'index' and self.freq is None) or (
        self.timetype == 'float' and self.freq is not None
    ):
      raise ValueError(f'Invalid freq={self.freq} with timetype={self.timetype}.')
    if self.seasonality_periods is None:
      return np.zeros(0)
    if self.timetype == 'index':
      return seasonalities_to_array(self.seasonality_periods, self.freq)
    if self.timetype == 'float':
      return np.asarray(self.seasonality_periods, dtype=float)
    raise AssertionError(f'Impossible timetype={self.timetype}.')

  def _get_num_seasonal_harmonics(self) -> np.ndarray:
    # Discrete time: harmonics are taken as given.
    if self.timetype == 'index':
      return (
          np.array(self.num_seasonal_harmonics)
          if self.num_seasonal_harmonics is not None
          else np.zeros(0)
      )
    # Continuous time: exactly one harmonic per seasonal factor; any value
    # in (0, min(.5, p/2)] yields the single base frequency (the reference's
    # continuous-time hack, spatiotemporal.py:347-357).
    if self.timetype == 'float':
      if self.num_seasonal_harmonics is not None:
        raise ValueError(
            f'Cannot use num_seasonal_harmonics with timetype={self.timetype}.'
        )
      return np.fmin(0.5, self._get_seasonality_periods() / 2)
    raise AssertionError(f'Impossible timetype={self.timetype}.')

  def _model_args(self, batch_shape):
    """Reference-shaped model-args dict (for logging and parity checks)."""
    return {
        'depth': self.depth,
        'input_scales': self.data_handler.get_input_scales(),
        'num_seasonal_harmonics': self._get_num_seasonal_harmonics(),
        'seasonality_periods': self._get_seasonality_periods(),
        'width': self.width,
        'init_x': batch_shape,
        'fourier_degrees': self._get_fourier_degrees(batch_shape),
        'interactions': self._get_interactions(),
    }

  def _field_config(self, batch_shape) -> field_lib.FieldConfig:
    return field_lib.FieldConfig.create(
        width=self.width,
        depth=self.depth,
        input_scales=self.data_handler.get_input_scales(),
        fourier_degrees=self._get_fourier_degrees(batch_shape),
        interactions=self._get_interactions(),
        seasonality_periods=self._get_seasonality_periods(),
        num_seasonal_harmonics=self._get_num_seasonal_harmonics(),
    )

  # -- Prediction ------------------------------------------------------------

  def _device_params(self):
    """Device-resident copy of `params_`, cached for repeated predicts.

    `params_` lives on the host (numpy after a fit or a `load`); without a
    cache every predict call re-uploads the full ensemble (~10 MB at the
    64-member flagship scale). Invalidated by identity: `fit`/`load`
    rebind `params_`.
    """
    cached = getattr(self, '_device_params_cache', None)
    if cached is not None and cached[0] is self.params_:
      return cached[1]
    device = tuple(
        p if isinstance(p, jax.Array) else jax.device_put(np.asarray(p))
        for p in self.params_
    )
    self._device_params_cache = (self.params_, device)
    return device

  def predict(self, table, quantiles=(0.5,), approximate_quantiles=False,
              stream_chunk_rows=None, stream_cache_bytes=None):
    """Predict the target at new field points.

    Args:
      table: DataFrame of new field locations (target column optional).
      quantiles: quantiles to compute.
      approximate_quantiles: moment-matching heuristic instead of
        root-finding.
      stream_chunk_rows: when set, the prediction grid streams from host
        RAM through the device in chunks of this many rows and results
        assemble into host numpy buffers — device memory stays O(chunk)
        instead of O(ensemble x len(table)). The predict-side twin of
        `fit(stream_chunk_steps=...)`: a model trained by streaming can
        predict on a grid of the same scale. Outputs are bit-identical
        to the in-memory path (exact quantiles; the
        `approximate_quantiles` heuristic is ulp-close).
      stream_cache_bytes: streamed-predict device cache budget in bytes
        (default 1 GiB; 0 disables). Pass-2 root-find inputs stay
        device-resident up to this budget, so grids within it stream
        with zero re-upload traffic; only grids beyond it spill to host
        buffers. Ignored without `stream_chunk_rows`.

    Returns:
      (means, quantiles): means has the ensemble leading dims
      `(num_devices, ensemble_size // num_devices, len(table))` (flatten
      with `np.row_stack`); each quantile array has length `len(table)`.

    A fit over an explicit mesh predicts over that mesh too: prediction
    rows shard across every device (row-parallel, collective-free after a
    small parameter all-gather).
    """
    test_data = self.data_handler.get_test(table)
    return predict_lib.predict_bnf(
        test_data,
        self.observation_model,
        params=self._device_params(),
        config=self._field_config(test_data.shape),
        quantiles=quantiles,
        ensemble_dims=self._ensemble_dims,
        approximate_quantiles=approximate_quantiles,
        mesh=self.mesh_,
        stream_chunk_rows=stream_chunk_rows,
        stream_cache_bytes=stream_cache_bytes,
    )

  def fit(self, table, seed, **kwargs):
    raise NotImplementedError('Should be implemented by subclass')

  # -- Fitted-model persistence (serving) ------------------------------------
  #
  # `utils/checkpoint.py` persists *training* state (params + optimizer +
  # RNG) for resumable fits; save/load here persist a *fitted* model —
  # constructor configuration, train-time data statistics, and ensemble
  # parameters — so a serving process can predict without refitting (the
  # reference keeps `params_` only in memory).

  def save(self, path: str) -> None:
    """Persist this fitted estimator to `path` (.npz).

    The artifact is self-describing: `load` reconstructs the estimator
    class, constructor arguments, the data handler's train-time statistics
    (z-score moments, time offset/scale), `params_`, and `losses_`.
    """
    import json

    if self.params_ is None:
      raise ValueError('Cannot save an unfitted estimator; call fit first.')
    h = self.data_handler

    def jsonable(v):
      if isinstance(v, np.ndarray):
        return v.tolist()
      if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
      if isinstance(v, (np.integer,)):
        return int(v)
      if isinstance(v, (np.floating,)):
        return float(v)
      return v

    spec = {
        'format': 'bayesnf-tpu-estimator-v1',
        'class': type(self).__name__,
        'kwargs': {
            'feature_cols': list(self.feature_cols),
            'target_col': self.target_col,
            'seasonality_periods': jsonable(self.seasonality_periods),
            'num_seasonal_harmonics': jsonable(self.num_seasonal_harmonics),
            'fourier_degrees': jsonable(self.fourier_degrees),
            'interactions': jsonable(self.interactions),
            'freq': self.freq,
            'timetype': self.timetype,
            'depth': int(self.depth),
            'width': int(self.width),
            'observation_model': self.observation_model,
            'standardize': jsonable(self.standardize),
        },
        'handler': {
            'mu': jsonable(h.mu_),
            'std': jsonable(h.std_),
            'time_min': jsonable(h.time_min_),
            'time_scale': jsonable(h.time_scale_),
        },
        'num_params': len(self.params_),
        # The fit-time mesh topology, so a serving process with the same
        # device count reconstructs the row-parallel placement instead of
        # silently predicting meshless.
        'fit_mesh': dict(self.mesh_.shape) if self.mesh_ is not None else None,
    }
    arrays = {
        f'param_{i}': np.asarray(p) for i, p in enumerate(self.params_)
    }
    if self.losses_ is not None:
      arrays['losses'] = np.asarray(self.losses_)
    surrogate = getattr(self, 'surrogate_', None)
    if surrogate is not None:
      # VI: persist the fitted mean-field surrogate too, so a loaded
      # estimator can draw FRESH posterior ensembles (resample_posterior)
      # instead of being frozen to the draws taken at fit time.
      locs, raw_scales = surrogate
      spec['num_surrogate_leaves'] = len(locs)
      for i, (loc, rs) in enumerate(zip(locs, raw_scales)):
        arrays[f'surrogate_loc_{i}'] = np.asarray(loc)
        arrays[f'surrogate_raw_scale_{i}'] = np.asarray(rs)
    # Write through a file object: np.savez(path) would append '.npz'.
    with open(path, 'wb') as f:
      np.savez(f, spec=np.asarray(json.dumps(spec)), **arrays)

  @classmethod
  def load(cls, path: str) -> 'BayesianNeuralFieldEstimator':
    """Reconstruct a fitted estimator saved with :meth:`save`.

    Callable from the base class (the saved artifact names its concrete
    class) or from the matching subclass.
    """
    import json

    with np.load(path, allow_pickle=False) as data:
      spec = json.loads(str(data['spec']))
      if spec.get('format') != 'bayesnf-tpu-estimator-v1':
        raise ValueError(f'Not a bayesnf-tpu estimator artifact: {path}')
      classes = {
          c.__name__: c
          for c in (
              BayesianNeuralFieldMAP,
              BayesianNeuralFieldMLE,
              BayesianNeuralFieldVI,
          )
      }
      target = classes[spec['class']]
      if cls is not BayesianNeuralFieldEstimator and cls is not target:
        raise ValueError(
            f'{path} holds a {spec["class"]}; load it via that class or the '
            'base BayesianNeuralFieldEstimator.'
        )
      model = target(**spec['kwargs'])
      h = model.data_handler
      hs = spec['handler']
      h.mu_ = np.asarray(hs['mu'], dtype=float)
      h.std_ = np.asarray(hs['std'], dtype=float)
      h.time_min_ = hs['time_min']
      h.time_scale_ = hs['time_scale']
      model.params_ = tuple(
          data[f'param_{i}'] for i in range(spec['num_params'])
      )
      model.losses_ = data['losses'] if 'losses' in data else None
      n_surr = spec.get('num_surrogate_leaves')
      if n_surr:
        model.surrogate_ = (
            tuple(data[f'surrogate_loc_{i}'] for i in range(n_surr)),
            tuple(data[f'surrogate_raw_scale_{i}'] for i in range(n_surr)),
        )
      fit_mesh = spec.get('fit_mesh')
      if fit_mesh:
        # Rebuild the fit-time placement when this process has the same
        # topology; otherwise stay meshless (single-program predict) —
        # the params_ shape contract is device-count independent.
        from bayesnf_tpu.parallel import mesh as mesh_lib

        ens = int(fit_mesh.get(mesh_lib.ENSEMBLE_AXIS, 1))
        dat = int(fit_mesh.get(mesh_lib.DATA_AXIS, 1))
        if ens * dat == len(jax.devices()):
          model.mesh_ = mesh_lib.default_mesh(
              ensemble_devices=ens, data_devices=dat
          )
    return model

  def likelihood_model(self, table: pd.DataFrame, stream_chunk_rows=None,
                       stream_cache_bytes=None):
    """Predictive distribution object over the target at new points.

    Must be called after `fit`. Returns an
    :class:`bayesnf_tpu.models.distributions.Independent` wrapping the
    observation distribution, with per-member ensemble batch dims.

    Rides the same stack as :meth:`predict`: the cached device-resident
    parameters and the fit mesh (row-parallel over `mesh_`, multi-process
    safe). With `stream_chunk_rows` set, rows stream from host RAM in bounded
    chunks and the distribution wraps host numpy parameter buffers
    (device memory stays O(chunk) plus the `stream_cache_bytes` batched-
    fetch budget; see :meth:`predict`).
    """
    test_data = self.data_handler.get_test(table)
    config = self._field_config(test_data.shape)
    distribution = likelihoods.LikelihoodDist(self.observation_model)

    fp = predict_lib.forecast_params_bnf(
        test_data,
        self.observation_model,
        self._device_params(),
        config,
        ensemble_dims=self._ensemble_dims,
        mesh=self.mesh_,
        stream_chunk_rows=stream_chunk_rows,
        stream_cache_bytes=stream_cache_bytes,
    )

    if distribution == likelihoods.LikelihoodDist.NORMAL:
      loc, scale = fp
      base = dist_lib.Normal(loc, scale[..., jnp.newaxis])
    else:
      total_count, logits, *maybe_pi = fp
      base = dist_lib.count_obs_dist(total_count, logits, *maybe_pi)
    return dist_lib.Independent(base, 1)


class BayesianNeuralFieldMAP(BayesianNeuralFieldEstimator):
  """Stochastic ensembles of maximum-a-posteriori estimates."""

  _ensemble_dims = 2

  def fit(
      self,
      table,
      seed,
      ensemble_size=16,
      learning_rate=0.005,
      num_epochs=5_000,
      batch_size=None,
      num_splits=1,
      mesh=None,
      checkpoint_dir=None,
      checkpoint_every=None,
      precision='f32',
      stream_chunk_steps=None,
      stream_member_remix=False,
  ) -> BayesianNeuralFieldEstimator:
    """Run stochastic ensemble MAP (or MLE) inference.

    Args:
      table: training DataFrame (see class docs).
      seed: `jax.random.PRNGKey` (or int).
      ensemble_size: number of particles; any positive int (issue #28 fixed).
      learning_rate: Adam learning rate.
      num_epochs: full passes over the training data.
      batch_size: SGD batch rows; None = full batch. Each epoch performs
        `len(table) // batch_size` updates (ragged tail dropped).
      num_splits: sequential ensemble splits (memory seam).
      mesh: optional ('ens', 'data') `jax.sharding.Mesh`.
      checkpoint_dir: when set, training checkpoints periodically and an
        interrupted fit resumes bit-exactly from the latest checkpoint.
      checkpoint_every: epochs between checkpoints (default num_epochs//10).
      precision: 'f32' (default: JAX's default matmul precision, which
        on an H100 may run f32 dots as TF32 — close to, not equal to,
        the reference's numerics), 'bf16' (bf16 matmul operands with f32
        accumulation), or 'highest' (exact f32 dots).
      stream_chunk_steps: when set (requires batch_size < len(table)),
        the training set stays in HOST memory and minibatches stream to
        the mesh in slices of this many SGD steps, double-buffered —
        the regime for datasets larger than device memory. Uses one
        shared per-epoch batch permutation across ensemble members (a
        documented RNG deviation; see `parallel/streaming.py`).
      stream_member_remix: (streaming only) each member repartitions
        every transferred slice's rows into its own batches on device,
        restoring per-member SGD-noise decorrelation at zero extra
        host->device traffic (measured in PARITY.md). Makes
        `stream_chunk_steps` semantic (the remix window).

    Returns:
      self.
    """
    seed = _as_key(seed)
    train_data = self.data_handler.get_train(table)
    train_target = self.data_handler.get_target(table)
    if batch_size is None:
      batch_size = train_data.shape[0]
    # A batch larger than the dataset degenerates to full batch (the
    # reference instead crashes on an assert; clamping is kinder and keeps
    # the epoch scaling factor >= 1).
    batch_size = min(batch_size, train_data.shape[0])
    if self._scale_epochs_by_batch_size:
      num_epochs = num_epochs * (train_data.shape[0] // batch_size)
    config = self._field_config((batch_size, train_data.shape[-1]))

    if stream_chunk_steps is not None:
      # Host-resident assembly: the augmented matrix never exists on the
      # device (seasonal features are computed in bounded device blocks).
      aug = field_lib.aug_features_host(config, train_data)
    else:
      # One jitted program for the encode (see field.py).
      aug = field_lib.aug_features_device(config, train_data)

    params, losses = map_lib.fit_map(
        aug,
        train_target,
        seed=seed,
        observation_model=self.observation_model,
        config=config,
        num_particles=ensemble_size,
        learning_rate=learning_rate,
        num_epochs=num_epochs,
        prior_weight=self._prior_weight,
        batch_size=batch_size,
        num_splits=num_splits,
        mesh=mesh,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        precision=precision,
        stream_chunk_steps=stream_chunk_steps,
        stream_member_remix=stream_member_remix,
    )
    g, m = _group_shape(ensemble_size, mesh)
    self.params_ = tuple(p.reshape((g, m) + p.shape[1:]) for p in params)
    self.losses_ = losses.reshape((g, m) + losses.shape[1:])
    self.mesh_ = mesh
    return self


class BayesianNeuralFieldMLE(BayesianNeuralFieldMAP):
  """Stochastic ensembles of maximum likelihood estimates."""

  _prior_weight = 0.0


class BayesianNeuralFieldVI(BayesianNeuralFieldEstimator):
  """Ensembles of mean-field surrogate posteriors via VI."""

  _ensemble_dims = 3
  _scale_epochs_by_batch_size = True

  def fit(
      self,
      table,
      seed,
      ensemble_size=16,
      learning_rate=0.01,
      num_epochs=1_000,
      sample_size_posterior=30,
      sample_size_divergence=5,
      kl_weight=0.1,
      batch_size=None,
      mesh=None,
      checkpoint_dir=None,
      checkpoint_every=None,
      precision='f32',
      stream_chunk_steps=None,
      stream_member_remix=False,
  ) -> BayesianNeuralFieldEstimator:
    """Run stochastic ensemble variational inference.

    Args:
      table: training DataFrame.
      seed: `jax.random.PRNGKey` (or int).
      ensemble_size: number of surrogate posteriors (total, not per-device —
        any positive int).
      learning_rate: Adam learning rate.
      num_epochs: epochs; total steps = num_epochs * (N // batch_size).
      sample_size_posterior: parameter draws per surrogate for prediction.
      sample_size_divergence: MC samples per ELBO estimate.
      kl_weight: weight of KL(q || prior) in the ELBO.
      batch_size: per-step batch rows; None = full batch.
      mesh: optional ('ens', 'data') `jax.sharding.Mesh`.
      checkpoint_dir: when set, VI optimization checkpoints periodically and
        an interrupted fit resumes bit-exactly.
      checkpoint_every: steps between checkpoints (default steps//10).
      precision: 'f32' (default: JAX's default matmul precision, which
        on an H100 may run f32 dots as TF32), 'bf16' (explicit bf16
        matmul operands), or 'highest' (exact f32 dots).
      stream_chunk_steps: when set (requires batch_size < len(table)),
        the training set stays in HOST memory and minibatches stream to
        the mesh in slices of this many steps, double-buffered — the
        regime for datasets larger than device memory. Batches are drawn
        per step (reference VI semantics) but shared across members (a
        documented RNG deviation; see `parallel/streaming.py`).
      stream_member_remix: (streaming only) per-member device-side
        repartitioning of each transferred slice — restores per-member
        SGD-noise decorrelation at zero extra transfer; see
        :class:`BayesianNeuralFieldMAP` and PARITY.md.

    Returns:
      self.
    """
    seed = _as_key(seed)
    train_data = self.data_handler.get_train(table)
    train_target = self.data_handler.get_target(table)
    if batch_size is None:
      batch_size = train_data.shape[0]
    # A batch larger than the dataset degenerates to full batch (the
    # reference instead crashes on an assert; clamping is kinder and keeps
    # the epoch scaling factor >= 1).
    batch_size = min(batch_size, train_data.shape[0])
    if self._scale_epochs_by_batch_size:
      num_epochs = num_epochs * (train_data.shape[0] // batch_size)
    config = self._field_config((batch_size, train_data.shape[-1]))

    if stream_chunk_steps is not None:
      # Host-resident assembly (see BayesianNeuralFieldMAP.fit).
      aug = field_lib.aug_features_host(config, train_data)
    else:
      aug = field_lib.aug_features_device(config, train_data)

    surrogate, losses, draws = vi_lib.fit_vi(
        aug,
        train_target,
        seed=seed,
        observation_model=self.observation_model,
        config=config,
        ensemble_size=ensemble_size,
        learning_rate=learning_rate,
        num_epochs=num_epochs,
        sample_size_divergence=sample_size_divergence,
        sample_size_posterior=sample_size_posterior,
        kl_weight=kl_weight,
        batch_size=batch_size,
        mesh=mesh,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        precision=precision,
        stream_chunk_steps=stream_chunk_steps,
        stream_member_remix=stream_member_remix,
    )
    self.surrogate_ = jax.tree_util.tree_map(np.array, surrogate)
    g, m = _group_shape(ensemble_size, mesh)
    s = int(sample_size_posterior)
    # Public contract: (num_devices, num_samples, ensemble_per_device, ...).
    self.params_ = tuple(
        np.asarray(p).reshape((g, m, s) + p.shape[2:]).swapaxes(1, 2)
        for p in draws
    )
    self.losses_ = np.asarray(losses).reshape((g, m) + losses.shape[1:])
    self.mesh_ = mesh
    return self

  def resample_posterior(self, seed, sample_size_posterior: int = 30):
    """Rebind `params_` with FRESH draws from the fitted surrogate.

    Works on loaded estimators too (`save` persists the surrogate): a
    serving process can refresh its posterior ensemble without refitting.
    Keeps the public `(num_devices, num_samples, ensemble, ...)` shape
    contract; returns self.
    """
    if getattr(self, 'surrogate_', None) is None:
      raise ValueError(
          'No fitted surrogate: call fit first (or load an artifact saved '
          'from a fitted VI estimator).'
      )
    from bayesnf_tpu.inference import vi as vi_lib

    if isinstance(seed, int):
      seed = jax.random.PRNGKey(seed)
    locs = tuple(jnp.asarray(p) for p in self.surrogate_[0])
    raw_scales = tuple(jnp.asarray(p) for p in self.surrogate_[1])
    ensemble_size = int(locs[0].shape[0])
    s = int(sample_size_posterior)
    keys = jax.random.split(seed, ensemble_size)

    def member_draw(loc, raw_scale, key):
      return vi_lib._surrogate_sample(  # pylint: disable=protected-access
          loc, vi_lib.surrogate_scales(raw_scale), key, (s,)
      )

    draws = jax.vmap(member_draw)(locs, raw_scales, keys)
    g, m = _group_shape(ensemble_size, self.mesh_)
    self.params_ = tuple(
        np.asarray(p).reshape((g, m, s) + p.shape[2:]).swapaxes(1, 2)
        for p in draws
    )
    return self
