"""Smoke test: BayesNF's fit/predict path on one NVIDIA GPU.

Drives the estimators (`BayesianNeuralField{MAP,VI}.fit` -> `predict`) at
the published widths of `bayesnf_tpu/cli/registry.py` on synthetic data
made from `--seed`, and compares every phase with a plain float32
reference: the row-major `models/field.apply_field` + likelihood + prior
under `jax.value_and_grad` and `jax.default_matmul_precision('highest')`.
The comparisons are made at identical parameters (the compiled train
program's first step, and predicted means); quantiles are checked against
the mixture CDF at their level.

Phases (one card):
  1. MAP, NORMAL, air_quality published config (full batch of 38,096).
  2. VI, air_quality published VI config (batch 3,500).
  3. NB and ZINB MAP fits at chickenpox's published model.
  4. Host-streamed MAP fit and streamed predict on the phase-1 data.

`--four-cards` runs only the mesh path over four cards (an ens=4 mesh and
an ens=2 x data=2 mesh), each leg compared with the same seeds on one card.

Exits non-zero, before any work, when JAX finds no GPU. The last line of
standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
and is printed only when every phase passed.

Usage:
  python chip_smoke.py
  python chip_smoke.py --four-cards
  python chip_smoke.py --measure OUT_DIR   # also time + trace phase 1
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
# Compile cache when JAX_COMPILATION_CACHE_DIR is unset (git-ignored).
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, '.jax_cache')

# Tolerances, per comparison and matmul precision, with their reasons.
# 'default' is JAX's default matmul precision: on an H100, f32 dots may run
# as TF32, which keeps 10 explicit mantissa bits per operand (unit roundoff
# ~4.9e-4); over fan-ins up to 512 and three layers that leaves relative
# errors of order 1e-3 on losses and predictions, and gradients (which
# difference such terms) a few times more. 'highest' runs exact f32 dots;
# what remains is summation order (chunked features-major program vs the
# unchunked row-major reference) over up to 38k rows: ~1e-5 relative.
TOLERANCES = {
    'default': {'loss': 1e-2, 'grad': 5e-2, 'pred': 1e-2},
    'highest': {'loss': 1e-4, 'grad': 1e-3, 'pred': 1e-4},
}
# The quantile root-finder stops at |F(x) - q| <= 1e-5 on the float32
# mixture CDF (inference/quantiles.py); recomputing that CDF in float64
# adds float32 rounding of the forecast parameters (~1e-6).
CDF_TOL = 1e-4
# Integer quantiles sit on a discretization cliff: a last-ulp CDF
# difference at an integer boundary moves a whole count (cli/selftest.py).
COUNT_QUANTILE_MIN_SHARE = 0.99
# Streamed predict runs the same forecast program per host chunk; only the
# chunk shapes differ, which may change GEMM algorithm choice.
STREAM_PRED_RTOL = 1e-5
# Mesh vs one card, both at default precision: the sharded programs see
# other GEMM shapes, so TF32 roundings may differ.
MESH_RTOL = 5e-3

QUANTILES = (0.5, 0.025, 0.975)
FULL = {
    'air_rows': 38096, 'air_sites': 12, 'map_epochs': 20,
    'vi_epochs': 2, 'counties': 20, 'weeks': 522, 'count_epochs': 5,
    'stream_epochs': 2, 'stream_chunk_steps': 4, 'stream_chunk_rows': 8192,
    'mesh_members': 64, 'mesh_epochs': 3,
}


class Checks:
  """Collects named comparisons; prints one PASS/FAIL line for each."""

  def __init__(self):
    self.failed = []

  def at_most(self, name, value, tol):
    ok = bool(np.isfinite(value) and value <= tol)
    print(f'{"PASS" if ok else "FAIL"} {name}: {value:.3e} (tol {tol:.1e})')
    if not ok:
      self.failed.append(name)
    return ok

  def at_least(self, name, value, tol):
    ok = bool(value >= tol)
    print(f'{"PASS" if ok else "FAIL"} {name}: {value:.4f} (min {tol})')
    if not ok:
      self.failed.append(name)
    return ok


def max_rel_err(got, want):
  """max |got - want| / |want| (for quantities bounded away from zero)."""
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def norm_rel_err(got, want):
  """||got - want|| / ||want|| (for gradients, whose entries cross zero)."""
  got = np.asarray(got, np.float64)
  want = np.asarray(want, np.float64)
  return float(
      np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
  )


def scaled_err(got, want, rtol, data_scale):
  """max |a-b| / (atol + rtol * max(|a|, |b|)), atol = rtol * data scale.

  Pure relative error is ill-conditioned where predictions cross zero;
  tying atol to the scale of the data keeps the bound meaningful there.
  <= 1 passes.
  """
  a = np.asarray(got, np.float64)
  b = np.asarray(want, np.float64)
  atol = rtol * max(float(data_scale), 1e-12)
  return float(
      np.max(np.abs(a - b) / (atol + rtol * np.maximum(np.abs(a), np.abs(b))))
  )


def normal_mixture_cdf(x, means, scales):
  """Ensemble-mixture Normal CDF at x (N,): means (K, N), scales (K,)."""
  from scipy import special

  z = (np.asarray(x, np.float64)[None] - np.asarray(means, np.float64))
  return special.ndtr(z / np.asarray(scales, np.float64)[:, None]).mean(0)


def count_mixture_cdf(k, total_count, logits, pi=None):
  """Ensemble-mixture (ZI)NB CDF at integers k (N,).

  total_count (K,), logits (K, N), pi (K, N) or None. TFP's
  NegativeBinomial(total_count, logits) is scipy's nbinom(n=total_count,
  p=sigmoid(-logits)).
  """
  from scipy import special
  from scipy import stats

  k = np.asarray(k, np.float64)[None]
  r = np.asarray(total_count, np.float64)[:, None]
  p = special.expit(-np.asarray(logits, np.float64))
  cdf = np.where(k < 0, 0.0, stats.nbinom.cdf(k, r, p))
  if pi is not None:
    pi = np.asarray(pi, np.float64)
    cdf = np.where(k < 0, 0.0, pi + (1.0 - pi) * cdf)
  return cdf.mean(0)


def count_quantile_share(q_int, level, cdf_fn):
  """Share of rows where integer q is the level-quantile of the mixture:
  F(q) >= level and F(q - 1) < level, each within CDF_TOL."""
  q_int = np.asarray(q_int, np.float64)
  upper = cdf_fn(q_int) >= level - CDF_TOL
  lower = (q_int <= 0) | (cdf_fn(q_int - 1.0) < level + CDF_TOL)
  return float(np.mean(upper & lower))


def card_description():
  """`nvidia-smi` name and power limit, from a child that never imports JAX."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
  except (OSError, subprocess.SubprocessError) as err:
    out = f'nvidia-smi unavailable ({err})'
  return out


def result_line(devices):
  """The last line of a passing run."""
  return json.dumps({
      'ok': True,
      'device': {
          'platform': devices[0].platform,
          'kind': devices[0].device_kind,
          'count': len(devices),
      },
  })


def selected_phases(four_cards):
  """Names of the phases one invocation runs."""
  if four_cards:
    return ('mesh',)
  return ('map', 'vi', 'counts', 'stream')


# ---------------------------------------------------------------------------
# Synthetic data at the published schemas.
# ---------------------------------------------------------------------------


def air_quality_table(seed, n_rows, n_sites):
  """Hourly PM10 over `n_sites` sites: the air_quality schema."""
  import pandas as pd

  rng = np.random.default_rng(seed)
  hours = -(-n_rows // n_sites)
  t = np.arange(hours, dtype=np.float64)
  lat = 51.5 + 0.05 * rng.normal(size=n_sites)
  lon = -0.1 + 0.1 * rng.normal(size=n_sites)
  level = 5.0 * rng.normal(size=n_sites)
  pm10 = (
      25.0
      + 6.0 * np.sin(2 * np.pi * t / 24.0)[:, None]
      + 3.0 * np.sin(2 * np.pi * t / 168.0)[:, None]
      + level[None]
      + 2.0 * rng.normal(size=(hours, n_sites))
  )
  df = pd.DataFrame({
      'datetime': np.repeat(
          pd.date_range('2019-01-01', periods=hours, freq='h'), n_sites
      ),
      'latitude': np.tile(lat, hours),
      'longitude': np.tile(lon, hours),
      'pm10': pm10.reshape(-1),
  })
  return df.iloc[:n_rows].reset_index(drop=True)


def chickenpox_table(seed, counties, weeks, zero_share=0.0):
  """Weekly case counts over `counties`: the chickenpox schema."""
  import pandas as pd

  rng = np.random.default_rng(seed)
  t = np.arange(weeks, dtype=np.float64)
  lat = 47.0 + 0.8 * rng.normal(size=counties)
  lon = 19.0 + 1.5 * rng.normal(size=counties)
  log_rate = (
      2.5
      + 1.2 * np.cos(2 * np.pi * t / 52.1775)[:, None]
      + 0.5 * rng.normal(size=counties)[None]
  )
  counts = rng.poisson(np.exp(log_rate)).astype(np.float64)
  if zero_share:
    counts[rng.random(size=counts.shape) < zero_share] = 0.0
  return pd.DataFrame({
      'datetime': np.repeat(
          pd.date_range('2005-01-03', periods=weeks, freq='W-MON'), counties
      ),
      'latitude': np.tile(lat, weeks),
      'longitude': np.tile(lon, weeks),
      'chickenpox': counts.reshape(-1),
  })


def make_estimator(cls, dataset, objective, observation_model='NORMAL'):
  """An estimator with the registry's published model for `dataset`."""
  from bayesnf_tpu.cli import registry

  data = registry.dataset_config(dataset)
  model = registry.model_config(dataset, objective)
  return cls(
      width=model['width'],
      depth=model['depth'],
      freq=data['freq'],
      seasonality_periods=[float(p) for p in model['seasonality_periods']],
      num_seasonal_harmonics=[
          int(h) for h in model['num_seasonal_harmonics']
      ],
      feature_cols=data['feature_cols'],
      target_col=data['target_col'],
      observation_model=observation_model,
      timetype=data['timetype'],
      standardize=data['standardize'],
  )


# ---------------------------------------------------------------------------
# The plain float32 reference and the compiled programs' first steps.
# ---------------------------------------------------------------------------


def reference_map_step(config, distribution, params, x, seasonal, y,
                       lik_scale, prior_weight, rows=None):
  """Per-member (loss, grads) of the MAP objective, row-major, exact f32.

  `rows`: optional (E, B) per-member row indices (a minibatch).
  """
  import jax
  import jax.numpy as jnp

  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.models import priors

  x, seasonal, y = (jnp.asarray(a, jnp.float32) for a in (x, seasonal, y))

  def loss(p, idx):
    xx, ss, yy = (x, seasonal, y) if idx is None else (
        x[idx], seasonal[idx], y[idx]
    )
    pred = field_lib.apply_field(config, p, xx, ss)
    return -(
        lik_scale * likelihoods.log_likelihood(distribution, p, pred, yy)
        + prior_weight * priors.prior_log_prob(config, p)
    )

  with jax.default_matmul_precision('highest'):
    fn = jax.vmap(jax.value_and_grad(loss), in_axes=(0, None if rows is None
                                                     else 0))
    return jax.jit(fn)(tuple(params), rows)


def program_map_step(config, distribution, aug, y, seed, ensemble,
                     learning_rate, prior_weight, mesh, precision):
  """First step of the compiled full-batch MAP train program.

  Returns (initial params as host arrays, per-member first-step losses,
  per-member gradients). The gradient is read back from Adam's first
  moment: after one step from a zero state it is (1 - b1) * grad.
  """
  import jax

  from bayesnf_tpu.inference import map as map_lib
  from bayesnf_tpu.parallel import mesh as mesh_lib
  from bayesnf_tpu.parallel import minibatch as minibatch_lib

  n = int(y.shape[0])
  padded = mesh_lib.pad_ensemble_size(ensemble, mesh)
  log_noise_init = np.float32(np.log(np.nanstd(np.asarray(y)) / 2.0))
  params, opt, keys, _ = map_lib._make_init_fn(  # pylint: disable=protected-access
      config, float(learning_rate), padded, mesh
  )(seed, log_noise_init)
  params0 = [np.asarray(p) for p in params]  # before the step donates them
  aug_t, target = minibatch_lib.make_layout_fn(n, 1, mesh)(aug, y)
  train = map_lib._make_train_fn(  # pylint: disable=protected-access
      config, distribution, 1, n, n, float(learning_rate),
      float(prior_weight), mesh, precision,
  )
  _, opt1, _, losses = train(params, opt, keys, aug_t, target)
  grads = [np.asarray(m) / 0.1 for m in opt1[0].mu]
  return params0, np.asarray(losses)[:, 0], grads


def compare_step(checks, label, precision, prog_losses, prog_grads,
                 ref_losses, ref_grads, names):
  tol = TOLERANCES[precision]
  checks.at_most(
      f'{label} [{precision}] first-step loss, max rel err vs reference',
      max_rel_err(prog_losses, ref_losses), tol['loss'],
  )
  worst, worst_name = 0.0, ''
  for name, g, r in zip(names, prog_grads, ref_grads):
    err = norm_rel_err(g, r)
    if err > worst:
      worst, worst_name = err, name
  checks.at_most(
      f'{label} [{precision}] first-step grads, worst leaf ({worst_name}) '
      'norm rel err vs reference',
      worst, tol['grad'],
  )


def reference_means(config, params_flat, x, members_per_call=16):
  """(K, N) row-major forward of every member, exact f32.

  Runs `members_per_call` members at a time: a whole VI posterior (480
  members x 38k rows x width 512) would not fit in device memory at once.
  """
  import jax
  import jax.numpy as jnp

  from bayesnf_tpu.models import field as field_lib

  x = jnp.asarray(x, jnp.float32)
  seasonal = field_lib.seasonal_features_for(config, x)
  fn = jax.jit(jax.vmap(
      lambda p: field_lib.apply_field(config, p, x, seasonal)
  ))
  k = len(params_flat[0])
  with jax.default_matmul_precision('highest'):
    return np.concatenate([
        np.asarray(fn(tuple(p[i:i + members_per_call] for p in params_flat)))
        for i in range(0, k, members_per_call)
    ])


def flat_members(params, ensemble_dims):
  return [
      np.asarray(p).reshape((-1,) + np.asarray(p).shape[ensemble_dims:])
      for p in params
  ]


def peak_bytes(device):
  stats = device.memory_stats() or {}
  return int(stats.get('peak_bytes_in_use', -1))


def timed(fn):
  t0 = time.perf_counter()
  out = fn()
  return out, time.perf_counter() - t0


def report_fit(name, device, cold_s, warm_s, steps):
  print(
      f'[{name}] fit: cold {cold_s:.2f} s (compile included), warm '
      f'{warm_s:.2f} s for {steps} steps = {warm_s / steps:.4f} s/step; '
      f'compile ~ cold - warm = {cold_s - warm_s:.2f} s; peak bytes in use '
      f'{peak_bytes(device)}'
  )


def report_call(name, device, cold_s, warm_s):
  print(
      f'[{name}] cold {cold_s:.2f} s, warm {warm_s:.3f} s/call; compile ~ '
      f'{cold_s - warm_s:.2f} s; peak bytes in use {peak_bytes(device)}'
  )


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------


def phase_map(checks, sizes, seed, device):
  """Phase 1: MAP, NORMAL, air_quality published config."""
  import jax

  import bayesnf_tpu as bnf
  from bayesnf_tpu.cli import registry
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import mesh as mesh_lib

  inf = registry.inference_config('air_quality', 'map')
  df = air_quality_table(seed, sizes['air_rows'], sizes['air_sites'])
  model = make_estimator(bnf.BayesianNeuralFieldMAP, 'air_quality', 'map')
  batch = min(inf['batch_size'], len(df))
  fit_kwargs = dict(
      seed=jax.random.PRNGKey(seed), ensemble_size=inf['num_particles'],
      learning_rate=inf['learning_rate'], batch_size=batch,
      num_epochs=sizes['map_epochs'],
  )
  _, cold = timed(lambda: model.fit(df, **fit_kwargs))
  _, warm = timed(lambda: model.fit(df, **fit_kwargs))
  report_fit('map', device, cold, warm, sizes['map_epochs'])
  losses = np.asarray(model.losses_)
  checks.at_most(
      'map fit losses finite and decreasing (0 = yes)',
      float(not (np.all(np.isfinite(losses))
                 and np.all(losses[..., -1] < losses[..., 0]))), 0.0,
  )

  # First step of the compiled train program vs the reference.
  x = model.data_handler.get_train(df)
  y = model.data_handler.get_target(df)
  config = model._field_config(x.shape)  # pylint: disable=protected-access
  aug = field_lib.aug_features_device(config, x)
  seasonal = np.asarray(aug)[:, config.num_inputs:]
  names = [s.name for s in field_lib.param_specs(config)]
  mesh = mesh_lib.default_mesh()
  ref = None
  for precision, setting in (('default', 'f32'), ('highest', 'highest')):
    params0, prog_l, prog_g = program_map_step(
        config, likelihoods.LikelihoodDist.NORMAL, aug, y,
        jax.random.PRNGKey(seed + 1), inf['num_particles'],
        inf['learning_rate'], 1.0, mesh, setting,
    )
    if ref is None:
      ref = reference_map_step(
          config, likelihoods.LikelihoodDist.NORMAL, params0,
          x, seasonal, y, 1.0, 1.0,
      )
    compare_step(checks, 'map/NORMAL', precision, prog_l, prog_g,
                 np.asarray(ref[0]), [np.asarray(g) for g in ref[1]], names)

  # Predict on the training grid; means vs the reference forward at the
  # fitted parameters; quantiles vs the mixture CDF.
  _, cold = timed(lambda: model.predict(df, quantiles=QUANTILES))
  (means, quants), warm = timed(lambda: model.predict(df, quantiles=QUANTILES))
  report_call('map predict', device, cold, warm)
  flat = flat_members(model.params_, 2)
  want = reference_means(config, flat, x)
  scale = float(np.std(y))
  got = np.asarray(means).reshape(want.shape)
  checks.at_most(
      'map predict [default] means, scaled err vs reference',
      scaled_err(got, want, TOLERANCES['default']['pred'], scale), 1.0,
  )
  with jax.default_matmul_precision('highest'):
    means_hi, _ = model.predict(df, quantiles=(0.5,))
  checks.at_most(
      'map predict [highest] means, scaled err vs reference',
      scaled_err(np.asarray(means_hi).reshape(want.shape), want,
                 TOLERANCES['highest']['pred'], scale), 1.0,
  )
  scales = 0.01 + np.exp(flat[field_lib.IDX_LOG_NOISE_SCALE])
  for level, q in zip(QUANTILES, quants):
    f = normal_mixture_cdf(q, got, scales)
    checks.at_most(
        f'map predict q{level}: max |mixture CDF - level|',
        float(np.max(np.abs(f - level))), CDF_TOL,
    )
  return df, model


def phase_vi(checks, sizes, seed, device):
  """Phase 2: VI, air_quality published VI config."""
  import jax
  import jax.numpy as jnp

  import bayesnf_tpu as bnf
  from bayesnf_tpu.cli import registry
  from bayesnf_tpu.inference import vi as vi_lib
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.models import priors
  from bayesnf_tpu.parallel import mesh as mesh_lib
  from bayesnf_tpu.parallel import minibatch as minibatch_lib

  inf = registry.inference_config('air_quality', 'vi')
  df = air_quality_table(seed, sizes['air_rows'], sizes['air_sites'])
  model = make_estimator(bnf.BayesianNeuralFieldVI, 'air_quality', 'vi')
  n = len(df)
  batch = min(inf['batch_size'], n // 2)
  fit_kwargs = dict(
      seed=jax.random.PRNGKey(seed), ensemble_size=inf['num_particles'],
      learning_rate=inf['learning_rate'], batch_size=batch,
      num_epochs=sizes['vi_epochs'], kl_weight=inf['kl_weight'],
      sample_size_divergence=inf['sample_size_divergence'],
  )
  steps = sizes['vi_epochs'] * (n // batch)
  _, cold = timed(lambda: model.fit(df, **fit_kwargs))
  _, warm = timed(lambda: model.fit(df, **fit_kwargs))
  report_fit('vi', device, cold, warm, steps)
  checks.at_most(
      'vi fit losses finite (0 = yes)',
      float(not np.all(np.isfinite(np.asarray(model.losses_)))), 0.0,
  )

  # First step of the compiled VI program vs the reference ELBO, with the
  # program's own member keys (step key -> sample key, batch key).
  x = model.data_handler.get_train(df)
  y = np.asarray(model.data_handler.get_target(df), np.float32)
  config = model._field_config((batch, x.shape[-1]))  # pylint: disable=protected-access
  aug = field_lib.aug_features_device(config, x)
  seasonal = np.asarray(aug)[:, config.num_inputs:]
  mesh = mesh_lib.default_mesh()
  e = inf['num_particles']
  s = inf['sample_size_divergence']
  kl = inf['kl_weight']
  lr = inf['learning_rate']
  dist = likelihoods.LikelihoodDist.NORMAL
  surr, opt, keys, _ = vi_lib._make_vi_init_fn(  # pylint: disable=protected-access
      config, lr, mesh_lib.pad_ensemble_size(e, mesh), mesh
  )(jax.random.PRNGKey(seed + 2))
  surr0 = jax.tree_util.tree_map(np.asarray, surr)
  opt0 = jax.tree_util.tree_map(np.asarray, opt)
  keys0 = np.asarray(keys)
  xj, sj, yj = (jnp.asarray(a) for a in (x, seasonal, y))

  def ref_elbo(locs, raws, key):
    _, sample_key, batch_key = jax.random.split(key, 3)
    idx = jax.random.permutation(batch_key, n)[:batch]

    def elbo(surrogate):
      locs, raws = surrogate
      scales = vi_lib.surrogate_scales(raws)
      z = vi_lib._surrogate_sample(locs, scales, sample_key, (s,))  # pylint: disable=protected-access

      def one(zd):
        pred = field_lib.apply_field(config, zd, xj[idx], sj[idx])
        target = priors.prior_log_prob(config, zd) + (
            likelihoods.log_likelihood(dist, zd, pred, yj[idx])
            * (n / batch) / kl
        )
        return vi_lib._surrogate_log_prob(locs, scales, zd) - target  # pylint: disable=protected-access

      return jnp.mean(jax.vmap(one)(z))

    return jax.value_and_grad(elbo)((locs, raws))

  with jax.default_matmul_precision('highest'):
    ref_l, ref_g = jax.jit(jax.vmap(ref_elbo))(surr0[0], surr0[1], keys0)
  ref_l = np.asarray(ref_l) * kl
  ref_g = [np.asarray(g) for g in jax.tree_util.tree_leaves(ref_g)]
  names = [f'{k}/{sp.name}' for k in ('loc', 'raw_scale')
           for sp in field_lib.param_specs(config)]
  aug_t, target = minibatch_lib.make_layout_fn(n, 1, mesh)(aug, y)
  for precision, setting in (('default', 'f32'), ('highest', 'highest')):
    fn = vi_lib._make_vi_fn(  # pylint: disable=protected-access
        config, dist, 1, batch, n, lr, s, kl, mesh, setting
    )
    surr_d, opt_d = jax.tree_util.tree_map(jnp.asarray, (surr0, opt0))
    _, opt1, _, losses = fn(surr_d, opt_d, jnp.asarray(keys0), aug_t, target)
    grads = [np.asarray(m) / 0.1
             for m in jax.tree_util.tree_leaves(opt1[0].mu)]
    compare_step(checks, 'vi/NORMAL', precision, np.asarray(losses)[:, 0],
                 grads, ref_l, ref_g, names)

  _, cold = timed(lambda: model.predict(df, quantiles=QUANTILES))
  (means, quants), warm = timed(lambda: model.predict(df, quantiles=QUANTILES))
  report_call('vi predict', device, cold, warm)
  flat = flat_members(model.params_, 3)
  want = reference_means(config, flat, x)
  got = np.asarray(means).reshape(want.shape)
  checks.at_most(
      'vi predict [default] means, scaled err vs reference',
      scaled_err(got, want, TOLERANCES['default']['pred'], float(np.std(y))),
      1.0,
  )
  scales = 0.01 + np.exp(flat[field_lib.IDX_LOG_NOISE_SCALE])
  for level, q in zip(QUANTILES, quants):
    f = normal_mixture_cdf(q, got, scales)
    checks.at_most(
        f'vi predict q{level}: max |mixture CDF - level|',
        float(np.max(np.abs(f - level))), CDF_TOL,
    )


def phase_counts(checks, sizes, seed, device):
  """Phase 3: NB and ZINB MAP at chickenpox's published model."""
  import jax

  import bayesnf_tpu as bnf
  from bayesnf_tpu.cli import registry
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import mesh as mesh_lib

  inf = registry.inference_config('chickenpox', 'map')
  for dist_name, zero_share in (('NB', 0.0), ('ZINB', 0.25)):
    dist = likelihoods.LikelihoodDist(dist_name)
    df = chickenpox_table(seed, sizes['counties'], sizes['weeks'], zero_share)
    model = make_estimator(
        bnf.BayesianNeuralFieldMAP, 'chickenpox', 'map', dist_name
    )
    fit_kwargs = dict(
        seed=jax.random.PRNGKey(seed), ensemble_size=inf['num_particles'],
        learning_rate=inf['learning_rate'],
        num_epochs=sizes['count_epochs'],
    )
    _, cold = timed(lambda: model.fit(df, **fit_kwargs))
    _, warm = timed(lambda: model.fit(df, **fit_kwargs))
    report_fit(f'counts/{dist_name}', device, cold, warm,
               sizes['count_epochs'])
    checks.at_most(
        f'counts/{dist_name} fit losses finite (0 = yes)',
        float(not np.all(np.isfinite(np.asarray(model.losses_)))), 0.0,
    )

    x = model.data_handler.get_train(df)
    y = model.data_handler.get_target(df)
    config = model._field_config(x.shape)  # pylint: disable=protected-access
    aug = field_lib.aug_features_device(config, x)
    seasonal = np.asarray(aug)[:, config.num_inputs:]
    names = [sp.name for sp in field_lib.param_specs(config)]
    ref = None
    for precision, setting in (('default', 'f32'), ('highest', 'highest')):
      params0, prog_l, prog_g = program_map_step(
          config, dist, aug, y, jax.random.PRNGKey(seed + 3),
          inf['num_particles'], inf['learning_rate'], 1.0,
          mesh_lib.default_mesh(), setting,
      )
      if ref is None:
        ref = reference_map_step(config, dist, params0, x, seasonal, y,
                                 1.0, 1.0)
      compare_step(checks, f'counts/{dist_name}', precision, prog_l, prog_g,
                   np.asarray(ref[0]), [np.asarray(g) for g in ref[1]],
                   names)

    _, cold = timed(lambda: model.predict(df, quantiles=QUANTILES))
    (means, quants), warm = timed(
        lambda: model.predict(df, quantiles=QUANTILES)
    )
    report_call(f'counts/{dist_name} predict', device, cold, warm)
    flat = flat_members(model.params_, 2)
    ref_fp = [np.asarray(f) for f in jax.vmap(
        lambda p, pr: likelihoods.forecast_params(dist, p, pr)
    )(tuple(flat), reference_means(config, flat, x))]
    nb_mean = ref_fp[0][:, None] * np.exp(ref_fp[1].astype(np.float64))
    want = nb_mean * (1.0 - ref_fp[2]) if dist_name == 'ZINB' else nb_mean
    got = np.asarray(means).reshape(want.shape)
    checks.at_most(
        f'counts/{dist_name} predict [default] means, scaled err vs '
        'reference',
        scaled_err(got, want, TOLERANCES['default']['pred'],
                   float(np.std(y))), 1.0,
    )
    # Integer quantiles against the mixture CDF of the program's own
    # forecast distribution (likelihood_model serves it).
    base = model.likelihood_model(df).distribution
    n_rows = len(df)
    total_count = np.asarray(base.total_count).reshape(-1)
    logits = np.asarray(base.logits).reshape(-1, n_rows)
    pi = None
    if dist_name == 'ZINB':
      pi = np.asarray(base.inflated_loc_probs).reshape(-1, n_rows)

    def cdf_fn(k):
      return count_mixture_cdf(k, total_count, logits, pi)
    for level, q in zip(QUANTILES, quants):
      checks.at_least(
          f'counts/{dist_name} predict q{level}: share of rows whose '
          'integer quantile matches the mixture CDF',
          count_quantile_share(q, level, cdf_fn), COUNT_QUANTILE_MIN_SHARE,
      )


def phase_stream(checks, sizes, seed, device, df):
  """Phase 4: host-streamed MAP fit and streamed predict (phase-1 data)."""
  import jax
  import jax.numpy as jnp

  import bayesnf_tpu as bnf
  from bayesnf_tpu.cli import registry
  from bayesnf_tpu.inference import map as map_lib
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import mesh as mesh_lib
  from bayesnf_tpu.parallel import streaming as streaming_lib

  inf = registry.inference_config('air_quality', 'map')
  n = len(df)
  batch = n // 8
  model = make_estimator(bnf.BayesianNeuralFieldMAP, 'air_quality', 'map')
  fit_kwargs = dict(
      seed=jax.random.PRNGKey(seed), ensemble_size=inf['num_particles'],
      learning_rate=inf['learning_rate'], batch_size=batch,
      num_epochs=sizes['stream_epochs'],
      stream_chunk_steps=sizes['stream_chunk_steps'],
  )
  _, cold = timed(lambda: model.fit(df, **fit_kwargs))
  _, warm = timed(lambda: model.fit(df, **fit_kwargs))
  report_fit('stream', device, cold, warm,
             sizes['stream_epochs'] * (n // batch))
  checks.at_most(
      'stream fit losses finite (0 = yes)',
      float(not np.all(np.isfinite(np.asarray(model.losses_)))), 0.0,
  )

  # First step of the compiled slice program on the first host batch.
  x = model.data_handler.get_train(df)
  y = np.asarray(model.data_handler.get_target(df), np.float32)
  config = model._field_config((batch, x.shape[-1]))  # pylint: disable=protected-access
  aug_host = field_lib.aug_features_host(config, x)
  seasonal = aug_host[:, config.num_inputs:]
  mesh = mesh_lib.default_mesh()
  e, lr = inf['num_particles'], inf['learning_rate']
  dist = likelihoods.LikelihoodDist.NORMAL
  init = map_lib._make_init_fn(  # pylint: disable=protected-access
      config, lr, mesh_lib.pad_ensemble_size(e, mesh), mesh
  )
  log_noise = np.float32(np.log(np.nanstd(y) / 2.0))
  params, _, _, opt_seed = init(jax.random.PRNGKey(seed + 4), log_noise)
  params0 = [np.asarray(p) for p in params]
  stream = streaming_lib.HostBatchStream(
      np.ascontiguousarray(aug_host.T), y, batch, opt_seed
  )
  aug_s, y_s = stream.slice_at(0, 1)
  rows = stream._batch_rows(0)  # pylint: disable=protected-access
  ref = reference_map_step(
      config, dist, params0, x[rows], seasonal[rows], y[rows], n / batch,
      1.0,
  )
  names = [sp.name for sp in field_lib.param_specs(config)]
  for precision, setting in (('default', 'f32'), ('highest', 'highest')):
    params, opt, _, _ = init(jax.random.PRNGKey(seed + 4), log_noise)
    fn = map_lib._make_stream_train_fn(  # pylint: disable=protected-access
        config, dist, 1, batch, n, lr, 1.0, mesh, setting
    )
    _, opt1, losses = fn(tuple(params), opt, jnp.asarray(aug_s),
                         jnp.asarray(y_s))
    grads = [np.asarray(m) / 0.1 for m in opt1[0].mu]
    compare_step(checks, 'stream/NORMAL slice program', precision,
                 np.asarray(losses)[:, 0], grads, np.asarray(ref[0]),
                 [np.asarray(g) for g in ref[1]], names)

  # Streamed predict vs in-memory predict of the same parameters.
  mem_means, mem_q = model.predict(df, quantiles=QUANTILES)
  kw = dict(quantiles=QUANTILES, stream_chunk_rows=sizes['stream_chunk_rows'])
  _, cold = timed(lambda: model.predict(df, **kw))
  (s_means, s_q), warm = timed(lambda: model.predict(df, **kw))
  report_call('stream predict', device, cold, warm)
  scale = float(np.std(y))
  bitwise = np.array_equal(np.asarray(s_means), np.asarray(mem_means)) and all(
      np.array_equal(np.asarray(a), np.asarray(b))
      for a, b in zip(s_q, mem_q)
  )
  print(f'stream predict bitwise equal to in-memory predict: {bitwise}')
  checks.at_most(
      'stream predict means, scaled err vs in-memory predict',
      scaled_err(s_means, mem_means, STREAM_PRED_RTOL, scale), 1.0,
  )
  for level, a, b in zip(QUANTILES, s_q, mem_q):
    checks.at_most(
        f'stream predict q{level}, scaled err vs in-memory predict',
        scaled_err(a, b, STREAM_PRED_RTOL, scale), 1.0,
    )


def phase_mesh(checks, sizes, seed, devices):
  """Four cards: ens=4 and ens=2 x data=2 meshes vs one card."""
  import jax
  import jax.numpy as jnp

  import bayesnf_tpu as bnf
  from bayesnf_tpu.cli import registry
  from bayesnf_tpu.inference import map as map_lib
  from bayesnf_tpu.inference import predict as predict_lib
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import mesh as mesh_lib
  from bayesnf_tpu.parallel import minibatch as minibatch_lib

  if len(devices) < 4:
    raise SystemExit(f'--four-cards needs 4 GPUs; JAX sees {len(devices)}.')
  devices = devices[:4]
  one = mesh_lib.default_mesh(devices=devices[:1])
  ens4 = mesh_lib.default_mesh(devices=devices, ensemble_devices=4)
  ens2_data2 = mesh_lib.default_mesh(devices=devices, data_devices=2)
  inf = registry.inference_config('air_quality', 'map')
  lr = inf['learning_rate']
  df = air_quality_table(seed, sizes['air_rows'], sizes['air_sites'])
  n = len(df)

  def fit(mesh, members, batch=None, epochs=sizes['mesh_epochs']):
    model = make_estimator(bnf.BayesianNeuralFieldMAP, 'air_quality', 'map')
    (_, secs) = timed(lambda: model.fit(
        df, seed=jax.random.PRNGKey(seed), ensemble_size=members,
        learning_rate=lr, batch_size=batch, num_epochs=epochs, mesh=mesh,
    ))
    return model, np.asarray(model.losses_).reshape(members, -1), secs

  # ens=4: 64 members, step-1 losses vs one card; row-parallel predict vs
  # a one-card predict of the same parameters.
  members = sizes['mesh_members']
  m4, l4, s4 = fit(ens4, members)
  m1, l1, s1 = fit(one, members)
  print(f'[mesh ens=4] fit {s4:.2f} s (one card {s1:.2f} s), compile '
        'included')
  checks.at_most('mesh ens=4 step-1 losses, max rel err vs one card',
                 max_rel_err(l4[:, 0], l1[:, 0]), MESH_RTOL)
  (means4, q4), t4 = timed(lambda: m4.predict(df, quantiles=QUANTILES))
  x = m4.data_handler.get_test(df)
  config = m4._field_config(x.shape)  # pylint: disable=protected-access
  with jax.default_device(devices[0]):
    (means1, q1), t1 = timed(lambda: predict_lib.predict_bnf(
        x, 'NORMAL', m4.params_, config, QUANTILES, ensemble_dims=2,
    ))
  print(f'[mesh ens=4] predict {t4:.2f} s (one card {t1:.2f} s)')
  scale = float(np.std(df['pm10']))
  checks.at_most('mesh ens=4 predict means, scaled err vs one card',
                 scaled_err(means4, means1, MESH_RTOL, scale), 1.0)
  for level, a, b in zip(QUANTILES, q4, q1):
    checks.at_most(f'mesh ens=4 predict q{level}, scaled err vs one card',
                   scaled_err(a, b, MESH_RTOL, scale), 1.0)

  # ens=2 x data=2, full batch: gradients psum over 'data'.
  e = inf['num_particles']
  m22, l22, s22 = fit(ens2_data2, e)
  m1, l1, s1 = fit(one, e)
  print(f'[mesh ens=2 x data=2 full batch] fit {s22:.2f} s (one card '
        f'{s1:.2f} s)')
  checks.at_most(
      'mesh ens=2 x data=2 full-batch step-1 losses, max rel err vs one '
      'card', max_rel_err(l22[:, 0], l1[:, 0]), MESH_RTOL,
  )

  # Non-divisible minibatch (GSPMD, global permutation): one card runs the
  # same batches.
  odd_batch = n // 2 + 1 if (n // 2 + 1) % 2 else n // 2 + 2
  _, lo22, _ = fit(ens2_data2, e, batch=odd_batch, epochs=1)
  _, lo1, _ = fit(one, e, batch=odd_batch, epochs=1)
  checks.at_most(
      f'mesh ens=2 x data=2 minibatch {odd_batch} (GSPMD) step-1 losses, '
      'max rel err vs one card', max_rel_err(lo22[:, 0], lo1[:, 0]),
      MESH_RTOL,
  )

  # Divisible minibatch through the shard_map program: each shard draws
  # its own rows, so the one-card side is the reference evaluated on the
  # rows the program drew (rebuilt from its keys).
  even_batch = odd_batch + 1  # still one step per epoch
  x = m22.data_handler.get_train(df)
  y = np.asarray(m22.data_handler.get_target(df), np.float32)
  config = m22._field_config((even_batch, x.shape[-1]))  # pylint: disable=protected-access
  aug = field_lib.aug_features_device(config, x)
  seasonal = np.asarray(aug)[:, config.num_inputs:]
  params, opt, keys, _ = map_lib._make_init_fn(  # pylint: disable=protected-access
      config, lr, e, ens2_data2
  )(jax.random.PRNGKey(seed + 5), np.float32(np.log(np.nanstd(y) / 2.0)))
  params0 = [np.asarray(p) for p in params]
  keys0 = jax.device_get(keys)
  aug_t, target = minibatch_lib.make_layout_fn(n, 2, ens2_data2)(aug, y)
  fn = map_lib._make_shardmap_train_fn(  # pylint: disable=protected-access
      config, likelihoods.LikelihoodDist.NORMAL, 1, even_batch, n, lr, 1.0,
      ens2_data2,
  )
  _, opt1, _, losses = fn(tuple(params), opt, keys, aug_t, target)
  grads = [np.asarray(m) / 0.1 for m in opt1[0].mu]
  local_rows, _ = minibatch_lib.shard_counts(n, 2)
  local_batch = even_batch // 2

  def member_rows(key):
    permute_key = jax.random.split(key, 2)[1]
    parts = []
    for shard in range(2):
      nv = minibatch_lib.local_valid_count(n, 2, jnp.int32(shard))
      idx = minibatch_lib.local_permutation(
          permute_key, shard, local_rows, nv, local_batch
      )
      parts.append(shard * local_rows + idx)
    return jnp.concatenate(parts)

  with jax.default_device(devices[0]):
    rows = np.asarray(jax.vmap(member_rows)(jnp.asarray(keys0)))
    stored = minibatch_lib.stored_positions(n, 2)
    rows = np.argsort(stored)[rows]  # stored position -> original row
    ref = reference_map_step(
        config, likelihoods.LikelihoodDist.NORMAL, params0, x, seasonal, y,
        n / even_batch, 1.0, rows=rows,
    )
  names = [sp.name for sp in field_lib.param_specs(config)]
  compare_step(checks, f'mesh ens=2 x data=2 minibatch {even_batch} '
               '(shard_map)', 'default', np.asarray(losses)[:, 0], grads,
               np.asarray(ref[0]), [np.asarray(g) for g in ref[1]], names)


def measure(out_dir, sizes, seed, precisions=('f32', 'bf16')):
  """Warm step times of the phase-1 train program and a profiler trace.

  Writes the trace under `out_dir` and prints the device-time split of a
  ~5-step train window and of one predict forward.
  """
  import jax

  from bayesnf_tpu.inference import map as map_lib
  from bayesnf_tpu.inference import predict as predict_lib
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import mesh as mesh_lib
  from bayesnf_tpu.parallel import minibatch as minibatch_lib
  from bayesnf_tpu.utils import profiling
  import bayesnf_tpu as bnf

  df = air_quality_table(seed, sizes['air_rows'], sizes['air_sites'])
  model = make_estimator(bnf.BayesianNeuralFieldMAP, 'air_quality', 'map')
  x = model.data_handler.get_train(df)
  y = model.data_handler.get_target(df)
  config = model._field_config(x.shape)  # pylint: disable=protected-access
  aug = field_lib.aug_features_device(config, x)
  mesh = mesh_lib.default_mesh()
  n, e, lr = len(df), 16, 0.005
  init = map_lib._make_init_fn(config, lr, e, mesh)  # pylint: disable=protected-access
  log_noise = np.float32(np.log(np.nanstd(y) / 2.0))
  aug_t, target = minibatch_lib.make_layout_fn(n, 1, mesh)(aug, y)
  dist = likelihoods.LikelihoodDist.NORMAL
  steps = 20
  for precision in precisions:
    fn = map_lib._make_train_fn(  # pylint: disable=protected-access
        config, dist, steps, n, n, lr, 1.0, mesh, precision
    )
    times = []
    for rep in range(4):
      params, opt, keys, _ = init(jax.random.PRNGKey(rep), log_noise)
      jax.block_until_ready(params)
      t0 = time.perf_counter()
      jax.block_until_ready(fn(params, opt, keys, aug_t, target))
      times.append(time.perf_counter() - t0)
    warm = sorted(times[1:])
    print(f'[measure] train program precision={precision}: {steps} steps, '
          f'warm runs {["%.4f" % t for t in warm]} s; median '
          f'{warm[len(warm) // 2] / steps * 1e3:.3f} ms/step (cold run '
          f'{times[0]:.2f} s)')

  trace_steps = 5
  fn = map_lib._make_train_fn(  # pylint: disable=protected-access
      config, dist, trace_steps, n, n, lr, 1.0, mesh, 'f32'
  )
  params, opt, keys, _ = init(jax.random.PRNGKey(0), log_noise)
  jax.block_until_ready(fn(params, opt, keys, aug_t, target))
  params, opt, keys, _ = init(jax.random.PRNGKey(1), log_noise)
  jax.block_until_ready(params)
  train_dir = os.path.join(out_dir, 'train')
  with jax.profiler.trace(train_dir):
    jax.block_until_ready(fn(params, opt, keys, aug_t, target))
  print('[measure] train trace split:',
        json.dumps(profiling.device_time_split(train_dir)))

  model.fit(df, seed=jax.random.PRNGKey(seed), ensemble_size=64,
            num_epochs=1)
  predict_fn = predict_lib._make_predict_fn(  # pylint: disable=protected-access
      config, dist, QUANTILES, 2, False, 4096, None
  )
  params = model._device_params()  # pylint: disable=protected-access
  xd = jax.device_put(x)
  jax.block_until_ready(predict_fn(params, xd))
  predict_dir = os.path.join(out_dir, 'predict')
  with jax.profiler.trace(predict_dir):
    jax.block_until_ready(predict_fn(params, xd))
  print('[measure] predict trace split (64 members, 3 quantiles):',
        json.dumps(profiling.device_time_split(predict_dir)))


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--four-cards', action='store_true',
                      help='run only the four-card mesh path and its '
                           'one-card comparisons')
  parser.add_argument('--measure', default=None, metavar='OUT_DIR',
                      help='also time the phase-1 train program and write '
                           'profiler traces to OUT_DIR')
  args = parser.parse_args(argv)

  import jax

  devices = jax.devices()
  if devices[0].platform != 'gpu':
    print(f'chip_smoke.py: no GPU found (JAX platform '
          f'{devices[0].platform!r}); nothing was run.', file=sys.stderr)
    return 2

  from bayesnf_tpu.utils import profiling

  cache = profiling.enable_compile_cache(DEFAULT_CACHE_DIR)
  print('card (nvidia-smi name, power.limit):')
  print(card_description())
  print(f'jax {jax.__version__}; XLA_FLAGS={os.environ.get("XLA_FLAGS")!r}; '
        f'compile cache {cache}')
  print(f'devices: {len(devices)} x {devices[0].device_kind}')

  checks = Checks()
  sizes = FULL
  t0 = time.perf_counter()
  phases = selected_phases(args.four_cards)
  if 'mesh' in phases:
    phase_mesh(checks, sizes, args.seed, devices)
  if 'map' in phases:
    df, _ = phase_map(checks, sizes, args.seed, devices[0])
  if 'vi' in phases:
    phase_vi(checks, sizes, args.seed, devices[0])
  if 'counts' in phases:
    phase_counts(checks, sizes, args.seed, devices[0])
  if 'stream' in phases:
    phase_stream(checks, sizes, args.seed, devices[0], df)
  if args.measure:
    measure(args.measure, sizes, args.seed)
  print(f'wall {time.perf_counter() - t0:.1f} s')
  if checks.failed:
    print(f'chip_smoke.py: {len(checks.failed)} check(s) failed: '
          f'{checks.failed}', file=sys.stderr)
    return 1
  print(result_line(devices))
  return 0


if __name__ == '__main__':
  sys.exit(main())
