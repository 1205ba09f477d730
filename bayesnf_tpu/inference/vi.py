"""Ensemble mean-field variational inference.

Semantics parity with the reference VI path
(`/root/reference/src/bayesnf/inference.py:203-231,336-373,626-764`), which
delegates the optimizer loop to `tfp.vi.fit_surrogate_posterior_stateless`.
Here the loop is owned end-to-end:

- Surrogate: independent Normal(loc, 1e-4 + softplus(raw_scale)) per
  parameter entry (reference inference.py:711-720).
- Surrogate init: loc ~ TruncatedNormal(0,1,-2,2) for weight matrices,
  0 elsewhere; raw_scale = softplus_inverse(0.3) (reference
  inference.py:203-231).
- Per-step loss (one member): mean over `sample_size` reparametrized draws z
  of [log q(z) - prior.log_prob(z) - loglik(z, batch) * (N/B) / kl_weight];
  the returned loss history is multiplied back by kl_weight (reference
  inference.py:687-709,755-758).
- The minibatch is re-drawn each step via a seeded permutation prefix
  (reference inference.py:704-709).

Redesign: one jit over the ('ens', 'data') mesh; members are a
leading sharded axis; `lax.scan` over steps with no host sync; posterior
draws are produced inside the same program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax

from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods
from bayesnf_tpu.models import priors
from bayesnf_tpu.ops import special
from bayesnf_tpu.parallel import mesh as mesh_lib
from bayesnf_tpu.parallel import minibatch as minibatch_lib


def init_surrogate(config: field_lib.FieldConfig, key: jax.Array):
  """Initialize one member's surrogate (locs, raw_scales) tuples."""
  specs = field_lib.param_specs(config)
  keys = jax.random.split(key, len(specs))
  locs, raw_scales = [], []
  raw_scale_init = float(np.log(np.expm1(0.3)))  # softplus_inverse(0.3)
  for spec, k in zip(specs, keys):
    if spec.is_matrix:
      locs.append(jax.random.truncated_normal(k, -2.0, 2.0, spec.shape))
    else:
      locs.append(jnp.zeros(spec.shape, dtype=jnp.float32))
    raw_scales.append(jnp.full(spec.shape, raw_scale_init, dtype=jnp.float32))
  return tuple(locs), tuple(raw_scales)


def surrogate_scales(raw_scales):
  return tuple(1e-4 + jax.nn.softplus(r) for r in raw_scales)


def _surrogate_sample(locs, scales, key, sample_shape=()):
  keys = jax.random.split(key, len(locs))
  return tuple(
      loc + scale * jax.random.normal(k, sample_shape + loc.shape)
      for loc, scale, k in zip(locs, scales, keys)
  )


def _surrogate_log_prob(locs, scales, z):
  total = jnp.zeros((), dtype=jnp.float32)
  for loc, scale, zi in zip(locs, scales, z):
    total += jnp.sum(special.normal_log_prob(zi, loc, scale))
  return total


@functools.lru_cache(maxsize=32)
def _make_vi_fn(
    config: field_lib.FieldConfig,
    distribution: likelihoods.LikelihoodDist,
    num_steps: int,
    batch_size: int,
    data_size: int,
    learning_rate: float,
    sample_size: int,
    kl_weight: float,
    mesh,
    precision: str = 'f32',
    row_pad: int = 0,
):
  """Build the jitted ensemble-VI program for one static config.

  `row_pad`: trailing padding rows the caller appended so the stored rows
  divide the mesh's data axis; excluded from the likelihood via zero
  weights (full batch) or by never being indexed (minibatch permutation).
  """
  optimizer = optax.adam(learning_rate)
  d = config.num_inputs
  compute_dtype = {
      'f32': None, 'bf16': jnp.bfloat16, 'highest': 'highest'
  }[precision]
  full_batch = batch_size == data_size

  def unnormalized_target(z, aug_bt, y_b, w_b):
    # Features-major layout (rows on the minor axis), as in the MAP path.
    pred = field_lib.apply_field_t(
        config, z, aug_bt[:d], aug_bt[d:], compute_dtype=compute_dtype
    )
    loglik = likelihoods.log_likelihood(
        distribution, z, pred, y_b, weights=w_b
    )
    return priors.prior_log_prob(config, z) + (
        loglik * (data_size / batch_size) / kl_weight
    )

  data_shards = mesh.shape[mesh_lib.DATA_AXIS]
  # Balanced-layout stored-position map for the minibatch permutation
  # (identity when there is no padding); see inference/map.py.
  stored_pos = (
      jnp.asarray(minibatch_lib.stored_positions(data_size, data_shards))
      if row_pad
      else None
  )

  def member_fit(surrogate, opt_state, key, aug_t, target):
    row_w = (
        minibatch_lib.valid_row_weights(data_size, data_shards)
        if row_pad and full_batch
        else None
    )

    def elbo_loss(surrogate, sample_key, aug_bt, y_b, w_b):
      locs, raw_scales = surrogate
      scales = surrogate_scales(raw_scales)
      z_draws = _surrogate_sample(locs, scales, sample_key, (sample_size,))

      def one_draw(z):
        return _surrogate_log_prob(locs, scales, z) - unnormalized_target(
            z, aug_bt, y_b, w_b
        )

      return jnp.mean(jax.vmap(one_draw)(z_draws))

    def one_step(carry, _):
      surrogate, opt_state, key = carry
      key, sample_key, batch_key = jax.random.split(key, 3)
      if batch_size < data_size:
        idx = jax.random.permutation(batch_key, data_size)[:batch_size]
        if stored_pos is not None:
          idx = stored_pos[idx]
        aug_bt, y_b = aug_t[:, idx], target[idx]
      else:
        aug_bt, y_b = aug_t, target
      loss, grads = jax.value_and_grad(elbo_loss)(
          surrogate, sample_key, aug_bt, y_b, row_w
      )
      updates, opt_state = optimizer.update(grads, opt_state)
      surrogate = optax.apply_updates(surrogate, updates)
      return (surrogate, opt_state, key), loss

    (surrogate, opt_state, key), losses = jax.lax.scan(
        one_step, (surrogate, opt_state, key), None, length=num_steps
    )
    return surrogate, opt_state, key, losses * kl_weight

  fit = jax.vmap(member_fit, in_axes=(0, 0, 0, None, None))

  ens = mesh_lib.ensemble_sharding(mesh)
  data = mesh_lib.data_sharding(mesh)
  data_t = mesh_lib.data_sharding_t(mesh)
  num_leaves = len(field_lib.param_specs(config))
  param_shards = (ens,) * num_leaves
  surr_shards = (param_shards, param_shards)
  opt_shards = map_lib.adam_state_spec(
      config, learning_rate, ens, surrogate=True
  )
  return jax.jit(
      fit,
      in_shardings=(surr_shards, opt_shards, ens, data_t, data),
      out_shardings=(surr_shards, opt_shards, ens, ens),
      donate_argnums=(0, 1, 2),
  )


def init_vi_opt_state(learning_rate, surrogate):
  """Adam state for a batched (leading member axis) surrogate."""
  return jax.vmap(optax.adam(learning_rate).init)(surrogate)


@functools.lru_cache(maxsize=32)
def _make_vi_init_fn(
    config: field_lib.FieldConfig, learning_rate: float, padded: int, mesh=None
):
  """ONE jitted, module-cached program for the whole surrogate init:
  every key split, member surrogates, Adam state, per-member step keys.

  Cached at module scope — a jit wrapper created inside `fit_vi` would
  recompile on every fit; one program replaces ~60 primitive-sized eager
  setup compiles (inference/map.py `_make_init_fn`).
  The key derivation is the reference scheme verbatim (threefry is
  bit-identical under jit, so folding the splits in changes no RNG
  stream). With a (single-process) `mesh`, outputs come back already
  ensemble-sharded, matching the VI programs' in_shardings — the first
  chunk dispatches without eager per-leaf reshards. Multi-process
  callers pass mesh=None and globalize explicitly. `opt_seed` feeds the
  host-side streaming pipeline's batch schedule.
  """

  def init_all(seed):
    init_seed, opt_seed = jax.random.split(seed, 2)
    init_keys = jax.random.split(init_seed, padded)
    surrogate = jax.vmap(lambda k: init_surrogate(config, k))(init_keys)
    member_keys = jax.random.split(opt_seed, padded)
    return (
        surrogate,
        init_vi_opt_state(learning_rate, surrogate),
        member_keys,
        opt_seed,
    )

  if mesh is None:
    return jax.jit(init_all)
  ens = mesh_lib.ensemble_sharding(mesh)
  num_leaves = len(field_lib.param_specs(config))
  param_shards = (ens,) * num_leaves
  out_shardings = (
      (param_shards, param_shards),
      map_lib.adam_state_spec(config, learning_rate, ens, surrogate=True),
      ens,
      mesh_lib.replicated_sharding(mesh),
  )
  return jax.jit(init_all, out_shardings=out_shardings)


def _make_elbo_losses(
    config: field_lib.FieldConfig,
    distribution: likelihoods.LikelihoodDist,
    lik_scale: float,
    sample_size: int,
    precision: str,
    data_shards: int,
):
  """Per-step ensemble negative-ELBO function shared by the shard_map VI
  factories (`_make_shardmap_vi_fn`, `_make_stream_vi_fn`).

  Returns `elbo_losses(surrogate, sample_keys, aug_bt, y_b, n_valid=None)
  -> (E_local,)` per-member negative ELBO (mean over MC draws), where
  `aug_bt` is a shared (F, B) batch or per-member (E, F, B) batches. The
  losses are LOCAL to the data shard, with the replicated terms (log q,
  prior) pre-scaled by 1/data_shards so the caller's psum over 'data'
  counts them exactly once.
  """
  d = config.num_inputs
  compute_dtype = {
      'f32': None, 'bf16': jnp.bfloat16, 'highest': 'highest'
  }[precision]

  def nll(z, aug_bt, y_b, n_valid=None):
    """Local-shard NLL per (member, draw) via autodiff-able vmaps.

    Per-member batches serve all of a member's draws through vmap axes
    (no S-fold materialization). Returns the LOCAL shard's row sum, flat
    and draw-minor — the caller psums when the data axis is sharded.
    """

    def member(zm, aug_m, y_m):
      pred = field_lib.apply_field_t(
          config, zm, aug_m[:d], aug_m[d:], compute_dtype=compute_dtype
      )
      w = None
      if n_valid is not None:
        w = (jnp.arange(aug_m.shape[-1]) < n_valid).astype(jnp.float32)
      return -lik_scale * likelihoods.log_likelihood(
          distribution, zm, pred, y_m, weights=w
      )

    per_draw = jax.vmap(member, in_axes=(0, None, None))  # over S draws
    batch_axes = (0, None, None) if aug_bt.ndim == 2 else (0, 0, 0)
    return jax.vmap(per_draw, in_axes=batch_axes)(z, aug_bt, y_b).reshape(-1)

  def elbo_losses(surrogate, sample_keys, aug_bt, y_b, n_valid=None):
    """(E_local,) per-member negative ELBO (mean over MC draws)."""
    locs, raw_scales = surrogate
    scales = surrogate_scales(raw_scales)
    # Per-member draws, exactly as `_make_vi_fn`'s per-member
    # `_surrogate_sample(locs, scales, sample_key, (sample_size,))`.
    z = jax.vmap(
        lambda l, s, k: _surrogate_sample(l, s, k, (sample_size,))
    )(locs, scales, sample_keys)  # leaves (E_local, S, ...)
    e_local = z[0].shape[0]
    z_f = tuple(p.reshape((e_local * sample_size,) + p.shape[2:]) for p in z)
    rs = 1.0 / data_shards
    prior = jax.vmap(lambda p: priors.prior_log_prob(config, p))(z_f)
    target = (rs * prior - nll(z, aug_bt, y_b, n_valid)).reshape(
        e_local, sample_size
    )
    logq = jax.vmap(
        jax.vmap(_surrogate_log_prob, in_axes=(None, None, 0)),
        in_axes=(0, 0, 0),
    )(locs, scales, z)  # (E_local, S)
    return (rs * logq - target).mean(axis=1)

  return elbo_losses


@functools.lru_cache(maxsize=32)
def _make_shardmap_vi_fn(
    config: field_lib.FieldConfig,
    distribution: likelihoods.LikelihoodDist,
    num_steps: int,
    batch_size: int,
    data_size: int,
    learning_rate: float,
    sample_size: int,
    kl_weight: float,
    mesh,
    precision: str = 'f32',
):
  """Ensemble-VI step under explicit `jax.shard_map` over the mesh.

  Serves the sharded-data minibatch whose batch divides the data axis:
  each shard resamples `batch_size / data_shards` of its own rows every
  step (the per-shard local permutation of `parallel/minibatch.py`), and
  the NLL and its gradients psum over 'data'. A full batch over a sharded
  data axis is supported too (each shard masks its padded tail), as is an
  unsharded data axis, where per-member RNG (step key splits, draw
  sampling, minibatch permutation) matches `_make_vi_fn` exactly.
  """
  data_shards = mesh.shape[mesh_lib.DATA_AXIS]
  full_batch = batch_size == data_size
  if data_shards != 1 and not full_batch and batch_size % data_shards:
    raise ValueError(
        f'minibatch VI over a sharded data axis requires '
        f'batch_size % data_shards == 0 (got {batch_size=}, '
        f'{data_shards=}): each shard contributes batch_size/data_shards '
        'rows per step.'
    )
  local_rows, _ = minibatch_lib.shard_counts(data_size, data_shards)
  row_pad = local_rows * data_shards - data_size
  local_batch = batch_size // data_shards if data_shards > 1 else batch_size

  optimizer = optax.adam(learning_rate)
  elbo_losses = _make_elbo_losses(
      config,
      distribution,
      lik_scale=(data_size / batch_size) / kl_weight,
      sample_size=sample_size,
      precision=precision,
      data_shards=data_shards,
  )

  def shard_fit(surrogate, opt_state, keys, aug_t, target):
    if row_pad and full_batch:
      # Balanced layout: each shard masks its own padded tail.
      shard = jax.lax.axis_index(mesh_lib.DATA_AXIS)
      n_valid = minibatch_lib.local_valid_count(data_size, data_shards, shard)
    else:
      # Minibatch rows come from the valid prefix only — no mask needed.
      n_valid = None

    def one_step(carry, _):
      surrogate, opt_state, keys = carry
      split = jax.vmap(functools.partial(jax.random.split, num=3))(keys)
      keys, sample_keys, batch_keys = split[:, 0], split[:, 1], split[:, 2]
      if full_batch:
        aug_bt, y_b = aug_t, target
      elif data_shards == 1:
        idx = jax.vmap(
            lambda k: jax.random.permutation(k, data_size)[:batch_size]
        )(batch_keys)  # (E_local, B)
        aug_bt, y_b = aug_t[:, idx].transpose(1, 0, 2), target[idx]
      else:
        # Per-shard local resampling each step (documented RNG deviation;
        # see parallel/minibatch.py).
        shard = jax.lax.axis_index(mesh_lib.DATA_AXIS)
        nv = minibatch_lib.local_valid_count(data_size, data_shards, shard)
        idx = jax.vmap(
            lambda k: minibatch_lib.local_permutation(
                k, shard, local_rows, nv, local_batch
            )
        )(batch_keys)  # (E_local, B_local)
        aug_bt, y_b = aug_t[:, idx].transpose(1, 0, 2), target[idx]

      def total(surrogate):
        losses = elbo_losses(surrogate, sample_keys, aug_bt, y_b, n_valid)
        return losses.sum(), losses

      (_, losses), grads = jax.value_and_grad(total, has_aux=True)(surrogate)
      if data_shards > 1:
        # elbo_losses returned shard-local values (replicated terms
        # pre-scaled by 1/data_shards): reduce to the full ELBO here.
        losses = jax.lax.psum(losses, mesh_lib.DATA_AXIS)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, mesh_lib.DATA_AXIS), grads
        )
      updates, opt_state = jax.vmap(optimizer.update)(grads, opt_state)
      surrogate = optax.apply_updates(surrogate, updates)
      return (surrogate, opt_state, keys), losses

    (surrogate, opt_state, keys), losses = jax.lax.scan(
        one_step, (surrogate, opt_state, keys), None, length=num_steps
    )
    # (num_steps, E_local) -> (E_local, num_steps), x kl_weight as in the
    # reference's returned history (inference.py:755-758).
    return surrogate, opt_state, keys, losses.T * kl_weight

  num_leaves = len(field_lib.param_specs(config))
  p_ens = jax.sharding.PartitionSpec(mesh_lib.ENSEMBLE_AXIS)
  # Rows shard over 'data' (replication when the axis is 1).
  p_rows_t = jax.sharding.PartitionSpec(None, mesh_lib.DATA_AXIS)
  p_rows = jax.sharding.PartitionSpec(mesh_lib.DATA_AXIS)
  params_spec = (p_ens,) * num_leaves
  surr_spec = (params_spec, params_spec)
  opt_spec = map_lib.adam_state_spec(
      config, learning_rate, p_ens, surrogate=True
  )
  sharded = jax.shard_map(
      shard_fit,
      mesh=mesh,
      in_specs=(surr_spec, opt_spec, p_ens, p_rows_t, p_rows),
      out_specs=(surr_spec, opt_spec, p_ens, p_ens),
      check_vma=False,
  )
  return jax.jit(sharded, donate_argnums=(0, 1, 2))


@functools.lru_cache(maxsize=32)
def _make_stream_vi_fn(
    config: field_lib.FieldConfig,
    distribution: likelihoods.LikelihoodDist,
    slice_steps: int,
    batch_size: int,
    data_size: int,
    learning_rate: float,
    sample_size: int,
    kl_weight: float,
    mesh,
    precision: str = 'f32',
    member_remix: bool = False,
):
  """One slice of the host-streaming VI loop as a jitted program.

  Advances every surrogate by `slice_steps` ELBO steps on host-assembled
  batches: (S, F, B) inputs shared across members AND across each
  member's MC draws (vmap broadcasts a shared batch exactly as in
  full-batch training), batch rows sharded over 'data'. Device RNG is
  only used for the reparametrized draws — the minibatch sequence comes
  from the host stream (`parallel/streaming.py`, per-step resample).

  `member_remix`: same scheme as the MAP stream trainer — one extra
  raw-key argument, each member repartitions the slice's S x B rows into
  its own batches on device (per-member SGD-noise decorrelation at zero
  extra transfer; the slice size becomes the semantic remix window).
  """
  data_shards = mesh.shape[mesh_lib.DATA_AXIS]
  if batch_size % data_shards:
    raise ValueError(
        f'streaming VI over a sharded data axis requires '
        f'batch_size % data_shards == 0 (got {batch_size=}, {data_shards=}).'
    )

  optimizer = optax.adam(learning_rate)
  elbo_losses = _make_elbo_losses(
      config,
      distribution,
      lik_scale=(data_size / batch_size) / kl_weight,
      sample_size=sample_size,
      precision=precision,
      data_shards=data_shards,
  )

  def shard_fit_slice(surrogate, opt_state, keys, aug_s, y_s, *maybe_key):
    def one_step(carry, batch):
      surrogate, opt_state, keys = carry
      aug_bt, y_b = batch
      # Two-way split (no batch keys — the host stream owns batching).
      split = jax.vmap(functools.partial(jax.random.split, num=2))(keys)
      keys, sample_keys = split[:, 0], split[:, 1]

      def total(surrogate):
        losses = elbo_losses(surrogate, sample_keys, aug_bt, y_b, None)
        return losses.sum(), losses

      (_, losses), grads = jax.value_and_grad(total, has_aux=True)(surrogate)
      if data_shards > 1:
        # elbo_losses returned shard-local values (replicated terms
        # pre-scaled by 1/data_shards): reduce to the full ELBO here.
        losses = jax.lax.psum(losses, mesh_lib.DATA_AXIS)
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, mesh_lib.DATA_AXIS), grads
        )
      updates, opt_state = jax.vmap(optimizer.update)(grads, opt_state)
      surrogate = optax.apply_updates(surrogate, updates)
      return (surrogate, opt_state, keys), losses

    if member_remix:
      # Per-member repartition of the slice pool (plan shared with the MAP
      # trainer — `parallel/streaming.member_remix_plan`).
      from bayesnf_tpu.parallel import streaming as streaming_lib

      pool_aug, pool_y, idx_s = streaming_lib.member_remix_plan(
          maybe_key[0], aug_s, y_s, surrogate[0][0].shape[0]
      )

      def remix_step(carry, idx_b):
        aug_b = jnp.moveaxis(pool_aug[:, idx_b], 0, 1)  # (E, F, B)
        return one_step(carry, (aug_b, pool_y[idx_b]))

      (surrogate, opt_state, keys), losses = jax.lax.scan(
          remix_step, (surrogate, opt_state, keys), idx_s
      )
    else:
      (surrogate, opt_state, keys), losses = jax.lax.scan(
          one_step, (surrogate, opt_state, keys), (aug_s, y_s)
      )
    # (S, E_local) -> (E_local, S), x kl_weight as in the reference's
    # returned history (inference.py:755-758).
    return surrogate, opt_state, keys, losses.T * kl_weight

  num_leaves = len(field_lib.param_specs(config))
  p_ens = jax.sharding.PartitionSpec(mesh_lib.ENSEMBLE_AXIS)
  p_slice_t = jax.sharding.PartitionSpec(None, None, mesh_lib.DATA_AXIS)
  p_slice = jax.sharding.PartitionSpec(None, mesh_lib.DATA_AXIS)
  params_spec = (p_ens,) * num_leaves
  surr_spec = (params_spec, params_spec)
  opt_spec = map_lib.adam_state_spec(
      config, learning_rate, p_ens, surrogate=True
  )
  in_specs = (surr_spec, opt_spec, p_ens, p_slice_t, p_slice)
  if member_remix:
    in_specs = in_specs + (jax.sharding.PartitionSpec(),)
  sharded = jax.shard_map(
      shard_fit_slice,
      mesh=mesh,
      in_specs=in_specs,
      out_specs=(surr_spec, opt_spec, p_ens, p_ens),
      check_vma=False,
  )
  return jax.jit(sharded, donate_argnums=(0, 1, 2))


@functools.lru_cache(maxsize=32)
def _make_vi_draw_fn(config: field_lib.FieldConfig, num_samples: int, mesh):
  """Jitted posterior-draw program: (surrogate, keys) -> param draws."""

  def member_draw(surrogate, key):
    locs, raw_scales = surrogate
    return _surrogate_sample(
        locs, surrogate_scales(raw_scales), key, (num_samples,)
    )

  draw = jax.vmap(member_draw)
  ens = mesh_lib.ensemble_sharding(mesh)
  num_leaves = len(field_lib.param_specs(config))
  param_shards = (ens,) * num_leaves
  return jax.jit(
      draw,
      in_shardings=((param_shards, param_shards), ens),
      out_shardings=param_shards,
  )


def fit_vi(
    aug_features,
    target,
    seed: jax.Array,
    observation_model: str,
    config: field_lib.FieldConfig,
    ensemble_size: int,
    learning_rate: float,
    num_epochs: int,
    sample_size_divergence: int = 5,
    sample_size_posterior: int = 30,
    kl_weight: float = 1.0,
    batch_size: int | None = None,
    mesh=None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int | None = None,
    precision: str = 'f32',
    stream_chunk_steps: int | None = None,
    stream_member_remix: bool = False,
):
  """Fit an ensemble of mean-field surrogate posteriors.

  Args:
    aug_features: (N, D + 2F) inputs with precomputed seasonal features.
    target: (N,) targets.
    seed: PRNG key.
    observation_model: 'NORMAL' | 'NB' | 'ZINB'.
    config: static model config.
    ensemble_size: total surrogates to fit (any positive int; padded to the
      mesh, padding dropped — fixes reference issue #28).
    learning_rate: Adam learning rate.
    num_epochs: total optimization steps (callers pre-scale by N // B,
      matching the reference's `_scale_epochs_by_batch_size`).
    sample_size_divergence: MC samples per ELBO estimate.
    sample_size_posterior: posterior draws returned per surrogate.
    kl_weight: KL(q||p) weight in the ELBO.
    batch_size: minibatch rows; None means full batch.
    mesh: ('ens', 'data') mesh; defaults to all devices on 'ens'.
    checkpoint_dir: when set, optimization runs in `checkpoint_every`-step
      chunks persisted via orbax; an existing checkpoint resumes bit-exactly.
    checkpoint_every: steps per checkpoint chunk (default: 10% of steps).
    precision: 'f32' (default: JAX's default matmul precision, which on
      an H100 may run f32 dots as TF32), 'bf16' (explicit bf16 operands,
      f32 accumulation), or 'highest' (exact f32 dots).
    stream_chunk_steps: when set (minibatch fits only), the dataset stays
      in HOST memory — pass `aug_features` as numpy/memmap — and batches
      stream to the mesh in slices of this many steps, double-buffered
      (datasets larger than device memory). Batches are drawn per step (fresh
      permutation prefix, the reference's VI semantics) but SHARED across
      members, deterministically in (seed, step) — a documented RNG
      deviation; see `parallel/streaming.py`.
    stream_member_remix: (streaming only) each member repartitions every
      transferred slice's rows into its own batches on device — per-member
      SGD-noise decorrelation at zero extra transfer (scheme and measured
      effect: inference/map.py + PARITY.md). Makes `stream_chunk_steps`
      the semantic remix window (checkpoint chunks must cover whole
      windows; validated).

  Returns:
    (surrogate, losses, draws):
      surrogate: (locs, raw_scales) tuples with leading member axis E.
      losses: (E, num_steps) per-member loss history (x kl_weight).
      draws: flat param tuple with leading axes (E, sample_size_posterior).
  """
  from bayesnf_tpu.parallel import distributed as dist_lib

  if mesh is None:
    mesh = mesh_lib.default_mesh()
  data_size = int(target.shape[0])
  if batch_size is None or batch_size > data_size:
    batch_size = data_size
  data_shards = mesh.shape[mesh_lib.DATA_AXIS]
  streaming = stream_chunk_steps is not None
  if streaming:
    if int(stream_chunk_steps) < 1:
      raise ValueError(f'{stream_chunk_steps=} must be a positive int.')
    if batch_size == data_size:
      raise ValueError(
          'stream_chunk_steps requires minibatch VI (batch_size < '
          'len(table)): a full-batch fit re-reads the whole dataset every '
          'step, which defeats streaming — set batch_size or drop the flag.'
      )
    if batch_size % data_shards:
      raise ValueError(
          f'streaming VI over a sharded data axis requires '
          f'batch_size % data_shards == 0 (got {batch_size=}, '
          f'{data_shards=}): each slice batch splits evenly over shards.'
      )
  elif stream_member_remix:
    raise ValueError(
        'stream_member_remix applies to host-streaming fits only '
        '(set stream_chunk_steps); on-device minibatch VI already '
        'resamples per member.'
    )
  multiproc = dist_lib.is_multiprocess_mesh(mesh)
  distribution = likelihoods.LikelihoodDist(observation_model)

  padded = mesh_lib.pad_ensemble_size(ensemble_size, mesh)
  surrogate, opt_state, member_keys, opt_seed = _make_vi_init_fn(
      config, float(learning_rate), padded, None if multiproc else mesh
  )(seed)

  if streaming:
    # Host-resident dataset (no-copy views for float32 numpy input); no
    # device transfer, no padded-row layout — streamed batches are full.
    aug_host_t = np.asarray(aug_features, dtype=np.float32).T
    target_host = np.asarray(target, dtype=np.float32)
    aug_t = target = None
    row_pad = 0
  else:
    # One jitted, row-sharded layout program; uneven data axes store the
    # balanced padded layout (each shard a valid prefix), and the padding
    # is excluded exactly (see ensemble_map).
    row_pad = (-data_size) % data_shards
    aug_t, target = minibatch_lib.make_layout_fn(
        data_size, data_shards, None if multiproc else mesh
    )(aug_features, target)

  num_steps = int(num_epochs)
  start_step = 0
  loss_chunks = []
  checkpointer = None
  if checkpoint_dir is not None:
    from bayesnf_tpu.utils import checkpoint as ckpt_lib

    fp_kwargs = dict(
        kind='vi',
        config=config,
        distribution=distribution.value,
        ensemble_size=ensemble_size,
        learning_rate=float(learning_rate),
        # num_steps intentionally excluded: extending a run is a
        # supported resume.
        batch_size=int(batch_size),
        data_size=data_size,
        sample_size_divergence=int(sample_size_divergence),
        kl_weight=float(kl_weight),
        precision=precision,
        # Pinned for checkpoint compatibility; see inference/map.py.
        backend='xla',
        # Data-axis extent fixes row layout, psum grouping, and the
        # sharded-minibatch RNG scheme (see inference/map.py).
        data_shards=data_shards,
        # Streaming uses the shared host-side batch scheme — resuming
        # one scheme under the other would silently change batches.
        stream=streaming,
    )
    # With member remix the slice size is the remix window; keys appear
    # ONLY when remix is on so feature keys never churn pre-existing
    # non-remix fingerprints; one interim release always wrote the keys,
    # so non-remix digests of that recipe are accepted as legacy (see
    # inference/map.py).
    if streaming and stream_member_remix:
      fp_kwargs.update(
          stream_remix=True, stream_remix_window=int(stream_chunk_steps)
      )
      legacy = ()
    else:
      legacy = (
          ckpt_lib.run_fingerprint(
              **fp_kwargs, stream_remix=False, stream_remix_window=None
          ),
      )
    checkpointer = ckpt_lib.TrainCheckpointer(
        checkpoint_dir,
        fingerprint=ckpt_lib.run_fingerprint(**fp_kwargs),
        legacy_fingerprints=legacy,
    )
    restored = checkpointer.restore_latest()
    if restored is not None:
      # Restored host leaves land directly on the VI program's layout
      # (multi-process placement happens below via make_global instead).
      place = jnp.asarray
      if not multiproc:
        ens_restore = mesh_lib.ensemble_sharding(mesh)
        place = lambda x: jax.device_put(np.asarray(x), ens_restore)
      locs_scales = restored.params  # (locs..., raw_scales...) flat tuple
      num_leaves = len(locs_scales) // 2
      surrogate = (
          tuple(place(p) for p in locs_scales[:num_leaves]),
          tuple(place(p) for p in locs_scales[num_leaves:]),
      )
      opt_state = restored.opt_state(template=opt_state, place=place)
      member_keys = place(restored.keys)
      loss_chunks = [np.asarray(l) for l in restored.losses]
      start_step = restored.epoch
    if checkpoint_every is None:
      checkpoint_every = max(1, num_steps // 10)

  if multiproc:
    # Multi-process SPMD: every process computes the same full host values
    # (same script, same seed — and the same restored checkpoint) and
    # contributes its local shards (see inference/map.py).
    ens = mesh_lib.ensemble_sharding(mesh)
    surrogate = jax.tree_util.tree_map(
        lambda x: dist_lib.make_global(x, ens), surrogate
    )
    opt_state = jax.tree_util.tree_map(
        lambda x: dist_lib.make_global(x, ens), opt_state
    )
    member_keys = dist_lib.make_global(member_keys, ens)
    if not streaming:  # streamed slices are globalized per transfer instead
      aug_t = dist_lib.make_global(aug_t, mesh_lib.data_sharding_t(mesh))
      target = dist_lib.make_global(target, mesh_lib.data_sharding(mesh))

  def make_fit(chunk_steps):
    # Routing mirrors inference/map.py: only a sharded-data minibatch whose
    # batch divides the data axis runs the shard_map program.
    if (
        data_shards > 1
        and batch_size < data_size
        and batch_size % data_shards == 0
    ):
      return _make_shardmap_vi_fn(
          config,
          distribution,
          chunk_steps,
          int(batch_size),
          data_size,
          float(learning_rate),
          int(sample_size_divergence),
          float(kl_weight),
          mesh,
          precision,
      )
    return _make_vi_fn(
        config,
        distribution,
        chunk_steps,
        int(batch_size),
        data_size,
        float(learning_rate),
        int(sample_size_divergence),
        float(kl_weight),
        mesh,
        precision,
        row_pad=row_pad,
    )

  step = start_step
  if streaming:
    from bayesnf_tpu.parallel import streaming as streaming_lib

    stream = streaming_lib.HostBatchStream(
        aug_host_t, target_host, int(batch_size), opt_seed,
        per_step_resample=True,
    )
    if stream_member_remix:
      streaming_lib.validate_remix_alignment(
          int(stream_chunk_steps),
          step,
          None if checkpointer is None else checkpoint_every,
      )
    # Built only when remix is on: the fold_in inside is an eager
    # device dispatch (docs/roadmap.md item 3 discipline).
    slice_extra_fn = (
        streaming_lib.remix_slice_key_fn(opt_seed)
        if stream_member_remix
        else None
    )

    def make_stream_fn(slice_steps):
      return _make_stream_vi_fn(
          config,
          distribution,
          slice_steps,
          int(batch_size),
          data_size,
          float(learning_rate),
          int(sample_size_divergence),
          float(kl_weight),
          mesh,
          precision,
          member_remix=bool(stream_member_remix),
      )

    def on_chunk(state, losses_c, steps_done):
      # VI history is per-step (no epoch averaging), as in the resident
      # path.
      loss_chunks.append(losses_c)
      if checkpointer is not None:
        from bayesnf_tpu.utils import checkpoint as ckpt_lib

        chunk_surrogate, chunk_opt_state, chunk_keys = state
        checkpointer.save(
            ckpt_lib.TrainState.from_opt_state(
                params=jax.tree_util.tree_map(
                    dist_lib.host_value,
                    tuple(chunk_surrogate[0]) + tuple(chunk_surrogate[1]),
                ),
                opt_state=jax.tree_util.tree_map(
                    dist_lib.host_value, chunk_opt_state
                ),
                keys=dist_lib.host_value(chunk_keys),
                losses=loss_chunks,
                epoch=steps_done,
            )
        )

    surrogate, opt_state, member_keys = streaming_lib.run_stream_driver(
        stream,
        mesh=mesh,
        multiproc=multiproc,
        make_fn=make_stream_fn,
        state=(surrogate, opt_state, member_keys),
        start_step=step,
        num_steps=num_steps,
        slice_steps=int(stream_chunk_steps),
        checkpoint_steps=(
            None if checkpointer is None else checkpoint_every
        ),
        on_chunk=on_chunk,
        slice_extra_fn=slice_extra_fn,
    )
    step = num_steps  # the non-streaming loop below is a no-op
  while step < num_steps:
    chunk = (
        num_steps - step
        if checkpointer is None
        else min(checkpoint_every, num_steps - step)
    )
    surrogate, opt_state, member_keys, losses = make_fit(chunk)(
        surrogate, opt_state, member_keys, aug_t, target
    )
    loss_chunks.append(dist_lib.host_value(losses))
    step += chunk
    # Final chunk checkpointed too: a completed run re-invoked with the
    # same directory resumes at step == num_steps and is a no-op.
    if checkpointer is not None:
      from bayesnf_tpu.utils import checkpoint as ckpt_lib

      # Gather and save are both collectives on a multi-process mesh (see
      # inference/map.py): every process calls save, orbax's primary
      # writes, its internal barriers prevent races.
      checkpointer.save(
          ckpt_lib.TrainState.from_opt_state(
              params=jax.tree_util.tree_map(
                  dist_lib.host_value,
                  tuple(surrogate[0]) + tuple(surrogate[1]),
              ),
              opt_state=jax.tree_util.tree_map(
                  dist_lib.host_value, opt_state
              ),
              keys=dist_lib.host_value(member_keys),
              losses=loss_chunks,
              epoch=step,
          )
      )
  if checkpointer is not None:
    checkpointer.close()

  draw = _make_vi_draw_fn(config, int(sample_size_posterior), mesh)
  draws = draw(surrogate, member_keys)
  losses = jnp.concatenate([jnp.asarray(l) for l in loss_chunks], axis=-1)

  if multiproc:
    # Gather cross-process-sharded results to full host values everywhere.
    surrogate = jax.tree_util.tree_map(dist_lib.host_value, surrogate)
    draws = tuple(dist_lib.host_value(p) for p in draws)

  if padded != ensemble_size:
    surrogate = jax.tree_util.tree_map(lambda p: p[:ensemble_size], surrogate)
    losses = losses[:ensemble_size]
    draws = tuple(p[:ensemble_size] for p in draws)
  return surrogate, losses, draws
