"""Ensemble prediction: forecast parameters, means, and mixture quantiles.

Semantics parity with the reference predictor
(`/root/reference/src/bayesnf/inference.py:103-200,461-507`), redesigned:

- The reference loops on the host over 1024-row chunks and concatenates
  (inference.py:164-181). Here chunking happens **device-side** with
  `lax.map` inside one jit: N is padded to a chunk multiple, the forward
  runs per chunk vmapped over all ensemble members, and the padding is
  dropped at the end — no host round-trips.
- The forward runs in the features-major layout (`field.apply_field_t`),
  the same layout as the trainers: rows are the minor axis and each
  dense layer is one (width, fan_in) @ (fan_in, rows) matmul per member.
- Ensemble dims are flattened to one leading member axis for compute and
  restored to the public `(num_devices, [samples,] ensemble)` shape contract
  on the way out.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from bayesnf_tpu.inference import quantiles as quantiles_lib
from bayesnf_tpu.models import distributions as dist_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods
from bayesnf_tpu.parallel import distributed as distributed_lib
from bayesnf_tpu.parallel import mesh as mesh_lib


@functools.partial(
    jax.jit,
    static_argnames=(
        'config', 'distribution', 'chunk_size', 'mesh', 'ensemble_dims',
    ),
)
def _forecast_params_chunked(
    config, distribution, params_flat, aug, chunk_size=4096, mesh=None,
    ensemble_dims=None,
):
  """Per-member forecast distribution parameters over all rows.

  Args:
    config: static model config.
    distribution: observation model.
    params_flat: flat param tuple, leading member axis K — or, with
      `ensemble_dims` set, leaves carrying that many leading ensemble
      axes (flattened to K in-program).
    aug: (N, D + 2F) inputs with seasonal features appended — or, with
      `ensemble_dims` set, the raw (N, D) features (encoded in-program).
    chunk_size: rows per device-side chunk (the reference's 1024 is a
      host-loop chunk, inference.py:134).
    mesh: optional ('ens', 'data') mesh. Prediction is row-parallel: the
      rows *within* each chunk shard over every mesh device (params
      replicate — one small all-gather — after which forecast parameters,
      means, and the per-row quantile root-finds all run collective-free;
      rows, not members, are the large axis at prediction time).

  Returns:
    Tuple of arrays; per-observation entries have shape (K, N), scalar
    entries (per-member constants) have shape (K,) — with
    `ensemble_dims` set, K expands back to the leading ensemble axes.
  """
  ens_shape = None
  if ensemble_dims is not None:
    # In-program flatten + encode (the distribution-object path,
    # `forecast_params_bnf`): done eagerly these were ~20 primitive-sized
    # programs, each a dispatch and a compile of its own.
    ens_shape = params_flat[0].shape[:ensemble_dims]
    params_flat = tuple(
        p.reshape((-1,) + p.shape[ensemble_dims:]) for p in params_flat
    )
    aug = field_lib.aug_features(config, aug)
  d = config.num_inputs
  n = aug.shape[0]
  if mesh is not None:
    # Chunk rows split evenly across every device of the mesh.
    chunk_size = -(-chunk_size // mesh.size) * mesh.size
  num_chunks = -(-n // chunk_size)
  padded = num_chunks * chunk_size
  # Features-major: (D + 2F, padded) with rows on the minor axis, chunked
  # along the row axis for lax.map.
  aug_t = jnp.pad(aug, ((0, padded - n), (0, 0))).T
  chunks = jnp.moveaxis(
      aug_t.reshape(-1, num_chunks, chunk_size), 1, 0
  )  # (num_chunks, D + 2F, chunk)
  if mesh is not None:
    row_axes = (mesh_lib.ENSEMBLE_AXIS, mesh_lib.DATA_AXIS)
    chunks = jax.lax.with_sharding_constraint(
        chunks,
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(None, None, row_axes)
        ),
    )
    params_flat = tuple(
        jax.lax.with_sharding_constraint(
            p, mesh_lib.replicated_sharding(mesh)
        )
        for p in params_flat
    )

  def member_forecast(params, chunk_t):
    pred = field_lib.apply_field_t(config, params, chunk_t[:d], chunk_t[d:])
    return likelihoods.forecast_params(distribution, params, pred)

  ens_forecast = jax.vmap(member_forecast, in_axes=(0, None))
  out = jax.lax.map(lambda c: ens_forecast(params_flat, c), chunks)
  # Each per-observation leaf: (num_chunks, K, chunk) -> (K, N).
  # Scalar leaves: (num_chunks, K) -> (K,) (identical across chunks).
  merged = []
  for leaf in out:
    if leaf.ndim == 3:
      merged.append(
          jnp.moveaxis(leaf, 1, 0).reshape(leaf.shape[1], padded)[:, :n]
      )
    else:
      merged.append(leaf[0])
  if ens_shape is not None:
    merged = [m.reshape(ens_shape + m.shape[1:]) for m in merged]
  return tuple(merged)


@functools.lru_cache(maxsize=32)
def _make_predict_fn(
    config,
    distribution,
    quantiles,
    ensemble_dims,
    approximate_quantiles,
    chunk_size,
    mesh=None,
):
  """ONE jitted program for the whole predict: encode -> forecast params ->
  means -> every mixture-quantile root-find.

  The equivalent eager composition costs ~30 small dispatches per call
  (seasonal encode, param reshapes, one jit per quantile), each a
  host<->device round-trip. Fusing the call into one program leaves one
  dispatch plus the result fetches.
  """

  def predict(params, features):
    ens_shape = params[0].shape[:ensemble_dims]
    k = int(np.prod(ens_shape))
    params_flat = tuple(
        p.reshape((k,) + p.shape[ensemble_dims:]) for p in params
    )
    aug = field_lib.aug_features(config, features)

    fp = _forecast_params_chunked(
        config, distribution, params_flat, aug, chunk_size=chunk_size,
        mesh=mesh,
    )
    # Restore public ensemble axes.
    fp = tuple(f.reshape(ens_shape + f.shape[1:]) for f in fp)
    axis = tuple(range(ensemble_dims))

    if distribution == likelihoods.LikelihoodDist.NORMAL:
      means, scales = fp
      forecast_quantiles = quantiles_lib.normal_mixture_quantiles(
          means, scales, quantiles, axis=axis,
          approximate=approximate_quantiles,
      )
      return means, tuple(forecast_quantiles)

    total_count, logits, *maybe_pi = fp
    obs_d = dist_lib.count_obs_dist(total_count, logits, *maybe_pi)
    forecast_means = obs_d.mean()
    forecast_quantiles = tuple(
        quantiles_lib.count_mixture_quantile_root(obs_d, q, ensemble_axes=axis)
        for q in quantiles
    )
    return forecast_means, forecast_quantiles

  return jax.jit(predict)


def _prepare_predict_inputs(features, params, mesh, features_on_host=False):
  """Shared entry contract of the predict-stack public functions.

  Globalizes inputs on a multi-process mesh (every process holds the same
  full host values and contributes its shards; results gather back to
  full host arrays, as in the trainers), and collapses a 1-device mesh (it
  adds sharding constraints that constrain nothing).

  The streamed predictor (`predict_stream.py`) shares this exact
  resolution via `features_on_host=True`: features stay a host numpy
  array (never device-materialized whole); only params are placed. One
  implementation keeps the in-memory and streamed paths' mesh semantics
  identical by construction (their bit-identity contract depends on it).

  Returns (features, params, mesh, multiproc).
  """
  if features_on_host:
    features = np.asarray(features, dtype=np.float32)
  else:
    features = jnp.asarray(features, dtype=jnp.float32)
  params = tuple(jnp.asarray(p) for p in params)
  multiproc = mesh is not None and distributed_lib.is_multiprocess_mesh(mesh)
  if multiproc:
    rep = mesh_lib.replicated_sharding(mesh)
    if not features_on_host:
      features = distributed_lib.make_global(features, rep)
    params = tuple(distributed_lib.make_global(p, rep) for p in params)
  if mesh is not None and mesh.size == 1 and not multiproc:
    mesh = None
  return features, params, mesh, multiproc


def forecast_params_bnf(
    features,
    observation_model: str,
    params,
    config: field_lib.FieldConfig,
    ensemble_dims: int = 2,
    chunk_size: int = 4096,
    mesh=None,
    stream_chunk_rows: int | None = None,
    stream_cache_bytes: int | None = None,
):
  """Per-member forecast distribution parameters at new points.

  The distribution-object path (`likelihood_model`) rides the same stack
  as :func:`predict_bnf`: device-side chunking, row-parallel placement
  over a mesh, multi-process gather. Returns the raw per-observation-model
  parameter tuple (see `likelihoods.forecast_params`) with each leaf
  reshaped to the public ensemble axes: per-row leaves
  `ensemble_shape + (N,)`, scalar leaves `ensemble_shape`.

  `stream_chunk_rows`: when set, rows stream from host RAM through the
  device in chunks of this size and the returned leaves are host numpy
  buffers — device memory stays O(chunk) instead of O(members x N). Bit
  identical to the in-memory path (`inference/predict_stream.py`).
  """
  if stream_chunk_rows is not None:
    from bayesnf_tpu.inference import predict_stream

    return predict_stream.forecast_params_bnf_streamed(
        features, observation_model, params, config,
        ensemble_dims=ensemble_dims, chunk_size=chunk_size, mesh=mesh,
        stream_chunk_rows=stream_chunk_rows,
        **(
            {}
            if stream_cache_bytes is None
            else {'stream_cache_bytes': int(stream_cache_bytes)}
        ),
    )
  distribution = likelihoods.LikelihoodDist(observation_model)
  assert ensemble_dims >= 1
  features, params, mesh, multiproc = _prepare_predict_inputs(
      features, params, mesh
  )
  # Flatten/encode/reshape all happen inside the one jitted program
  # (static `ensemble_dims`) — no eager per-leaf setup dispatches.
  fp = _forecast_params_chunked(
      config, distribution, params, features, chunk_size=int(chunk_size),
      mesh=mesh, ensemble_dims=int(ensemble_dims),
  )
  if multiproc:
    fp = tuple(distributed_lib.host_value(f) for f in fp)
  return fp


def predict_bnf(
    features,
    observation_model: str,
    params,
    config: field_lib.FieldConfig,
    quantiles,
    ensemble_dims: int = 2,
    approximate_quantiles: bool = False,
    chunk_size: int = 4096,
    mesh=None,
    stream_chunk_rows: int | None = None,
    stream_cache_bytes: int | None = None,
):
  """Predict means and mixture quantiles at new points.

  Args:
    features: (N, D) raw feature matrix (post data-handler scaling).
    observation_model: 'NORMAL' | 'NB' | 'ZINB'.
    params: flat param tuple whose leaves carry `ensemble_dims` leading
      ensemble axes (e.g. (G, M, ...) for MAP, (G, S, M, ...) for VI).
    config: static model config.
    quantiles: sequence of quantiles in (0, 1).
    ensemble_dims: number of leading ensemble axes on each param leaf.
    approximate_quantiles: use the moment-matching heuristic instead of
      root-finding (NORMAL only).
    chunk_size: device-side prediction chunk rows.
    mesh: optional ('ens', 'data') mesh for row-parallel prediction (rows
      within each chunk shard over every device; see
      `_forecast_params_chunked`). None: single-program placement.
    stream_chunk_rows: when set, the grid streams from host RAM through
      the device in chunks of this many rows and results assemble into
      host numpy buffers — device memory stays O(chunk) instead of
      O(members x N), the predict-side twin of `stream_chunk_steps`
      training. Bit-identical outputs — except the
      `approximate_quantiles` heuristic, which is ulp-close
      (`inference/predict_stream.py`).
    stream_cache_bytes: streamed-predict device cache budget in bytes
      (None -> the streamed engine's 1 GiB default; 0 disables): pass-2
      root-find inputs stay device-resident up to this budget so
      in-budget grids stream with zero re-upload traffic. Ignored
      without `stream_chunk_rows`.

  Returns:
    (means, [quantile arrays]): means keeps the ensemble axes,
    shape `ensemble_shape + (N,)`; each quantile array is (N,).
  """
  if stream_chunk_rows is not None:
    from bayesnf_tpu.inference import predict_stream

    return predict_stream.predict_bnf_streamed(
        features, observation_model, params, config, quantiles,
        ensemble_dims=ensemble_dims,
        approximate_quantiles=approximate_quantiles, chunk_size=chunk_size,
        mesh=mesh, stream_chunk_rows=stream_chunk_rows,
        **(
            {}
            if stream_cache_bytes is None
            else {'stream_cache_bytes': int(stream_cache_bytes)}
        ),
    )
  distribution = likelihoods.LikelihoodDist(observation_model)
  assert ensemble_dims >= 1
  features, params, mesh, multiproc = _prepare_predict_inputs(
      features, params, mesh
  )
  means, forecast_quantiles = _make_predict_fn(
      config,
      distribution,
      tuple(float(q) for q in quantiles),
      int(ensemble_dims),
      bool(approximate_quantiles),
      int(chunk_size),
      mesh,
  )(params, features)
  if multiproc:
    means = distributed_lib.host_value(means)
    forecast_quantiles = tuple(
        distributed_lib.host_value(q) for q in forecast_quantiles
    )
  return means, list(forecast_quantiles)
