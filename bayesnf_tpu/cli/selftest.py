"""Hardware self-test: default-precision vs exact-f32 agreement on a device.

Qualification tool for a new card, topology, or toolchain bump: runs the
REAL production paths (`inference.map.fit_map`, `inference.vi.fit_vi`,
`inference.predict.predict_bnf`) twice — at JAX's default matmul precision
(on an H100, f32 dots may run as TF32) and under
`jax.default_matmul_precision('highest')` (exact f32) — on a small
synthetic spatiotemporal workload, and asserts the two agree within
tolerance for every observation model. Losses are compared at the first
epoch, where both runs evaluate identical initial parameters; predictions
at identical fitted parameters.

Usage:

    python -m bayesnf_tpu.cli.selftest            # current JAX device
    python -m bayesnf_tpu.cli.selftest --epochs 50 --rows 1024

Prints one line per check and a final JSON summary; exit code is non-zero
on any disagreement.
"""

import argparse
import contextlib
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.inference import predict as predict_lib
from bayesnf_tpu.inference import vi as vi_lib
from bayesnf_tpu.models import field as field_lib


def _workload(rows, width, seed=0):
  """Small but representative config + synthetic data (counts included)."""
  config = field_lib.FieldConfig.create(
      width=width,
      depth=2,
      input_scales=[168.0, 1.0, 1.0],
      fourier_degrees=[5, 3, 3],
      interactions=[(0, 1), (1, 2)],
      seasonality_periods=[24.0, 24.0 * 7],
      num_seasonal_harmonics=[3, 2],
  )
  rng = np.random.default_rng(seed)
  t = np.arange(rows, dtype=np.float32) % 720.0
  space = rng.normal(size=(rows, 2)).astype(np.float32)
  x = np.concatenate([t[:, None], space], axis=-1)
  rate = np.exp(
      1.0
      + 0.8 * np.sin(2 * np.pi * t / 24.0)
      + 0.3 * space[:, 0]
  )
  y_counts = rng.poisson(rate).astype(np.float32)
  y_counts[:: 11] = 0.0  # exercise the ZINB zero branch
  y_normal = (rate + rng.normal(scale=0.5, size=rows)).astype(np.float32)

  x = jnp.asarray(x)
  aug = field_lib.aug_features(config, x)
  return config, aug, jnp.asarray(y_normal), jnp.asarray(y_counts)


PRECISIONS = ('default', 'highest')


def _at(precision):
  """Context for one leg: JAX's default matmul precision, or exact f32."""
  if precision == 'default':
    return contextlib.nullcontext()
  return jax.default_matmul_precision(precision)


def _loss_agreement(name, losses_a, losses_b, rtol, checks):
  a = np.asarray(losses_a, dtype=np.float64)
  b = np.asarray(losses_b, dtype=np.float64)
  # Per-member losses. Pure relative error is well-conditioned here: losses are O(1e2) and
  # bounded away from zero. Predictions are NOT (they cross zero) — those
  # go through `_pred_agreement` instead.
  rel = np.max(np.abs(a - b) / (np.abs(b) + 1e-6))
  ok = bool(rel < rtol)
  checks.append({'check': name, 'max_rel': float(rel), 'tol': rtol, 'ok': ok})
  print(f'{"PASS" if ok else "FAIL"} {name}: max_rel={rel:.2e} (tol {rtol})')
  return ok


def _pred_agreement(name, pred_a, pred_b, rtol, data_scale, checks):
  """Scale-aware agreement for signed predictions.

  Pure relative error |a-b|/|b| is ill-conditioned where predictions cross
  zero (a 5e-4 absolute difference near b=0 reads as 'rel=0.2'). Contract:
  |a - b| <= atol + rtol * max(|a|, |b|) elementwise, with atol tied to the
  scale of the *data* (rtol * std(y)) rather than of the predictions — a
  barely-trained model predicts near zero, and a reduced-precision
  forward-pass floor is agreement, not divergence, whenever it is tiny
  against the observable signal.
  """
  a = np.asarray(pred_a, dtype=np.float64)
  b = np.asarray(pred_b, dtype=np.float64)
  atol = rtol * max(float(data_scale), 1e-12)
  err = np.max(np.abs(a - b) / (atol + rtol * np.maximum(np.abs(a), np.abs(b))))
  ok = bool(err <= 1.0)
  checks.append({'check': name, 'scaled_err': float(err), 'atol': atol,
                 'rtol': rtol, 'ok': ok})
  print(f'{"PASS" if ok else "FAIL"} {name}: scaled_err={err:.2e} '
        f'(tol: |a-b| <= {atol:.2e} + {rtol}*max|a|,|b|)')
  return ok


def _count_quantile_agreement(name, q_a, q_b, checks):
  """Integer quantiles sit on a discretization cliff: the root-find's ceil
  flips a whole count when the two programs' CDFs differ in the last few
  ulps at an integer boundary. Agreement contract: every row within one
  count, and at most max(1, 1% of rows) rows differ at all (the floor of
  one keeps the bound meaningful at small --rows, where a single flip
  exceeds 1%)."""
  a = np.asarray(q_a, dtype=np.float64)
  b = np.asarray(q_b, dtype=np.float64)
  max_abs = float(np.max(np.abs(a - b))) if a.size else 0.0
  mismatches = int(np.sum(a != b))
  allowed = max(1, int(np.ceil(0.01 * a.size)))
  ok = bool(max_abs <= 1.0 and mismatches <= allowed)
  checks.append({'check': name, 'max_abs_counts': max_abs,
                 'mismatches': mismatches, 'allowed_mismatches': allowed,
                 'ok': ok})
  print(f'{"PASS" if ok else "FAIL"} {name}: max_abs={max_abs:.0f} counts, '
        f'mismatches={mismatches}/{a.size} '
        f'(tol: <=1 count, <={allowed} rows)')
  return ok


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--rows', type=int, default=512)
  parser.add_argument('--width', type=int, default=64)
  parser.add_argument('--epochs', type=int, default=30)
  parser.add_argument('--ensemble', type=int, default=4)
  parser.add_argument('--rtol', type=float, default=5e-3,
                      help='relative tolerance on first-epoch per-member '
                           'losses and on predictions')
  parser.add_argument('--json-out', type=str, default=None,
                      help='also write the full JSON summary (per-check '
                           'detail, device, args) to this path')
  args = parser.parse_args(argv)

  platform = jax.default_backend()
  print(f'device: {platform} ({jax.devices()[0].device_kind})')
  config, aug, y_normal, y_counts = _workload(args.rows, args.width)

  def fit_map(precision, y, distribution, **kw):
    with _at(precision):
      return map_lib.fit_map(
          aug if 'stream_chunk_steps' not in kw else np.asarray(aug), y,
          seed=jax.random.PRNGKey(7),
          observation_model=distribution,
          config=config,
          num_particles=args.ensemble,
          learning_rate=0.005,
          num_epochs=args.epochs,
          **kw,
      )

  def fit_vi(precision, **kw):
    with _at(precision):
      return vi_lib.fit_vi(
          aug if 'stream_chunk_steps' not in kw else np.asarray(aug),
          y_normal,
          seed=jax.random.PRNGKey(7),
          observation_model='NORMAL',
          config=config,
          ensemble_size=args.ensemble,
          learning_rate=0.01,
          num_epochs=args.epochs,
          sample_size_divergence=3,
          kl_weight=0.1,
          **kw,
      )

  def predict(precision, features, distribution, params, **kw):
    with _at(precision):
      return predict_lib.predict_bnf(
          features, distribution, params, config, **kw
      )

  x = aug[:, : config.num_inputs]
  checks = []
  t0 = time.perf_counter()
  for distribution in ('NORMAL', 'NB', 'ZINB'):
    y = y_normal if distribution == 'NORMAL' else y_counts
    results = {pr: fit_map(pr, y, distribution) for pr in PRECISIONS}
    _loss_agreement(
        f'map/{distribution} first-epoch losses',
        results['default'][1][:, 0], results['highest'][1][:, 0],
        args.rtol, checks,
    )

    # Predict agreement on the params the exact fit produced (shared
    # input to both programs; count models exercise the root-finder).
    p = tuple(v[jnp.newaxis] for v in results['highest'][0])  # (1, E, ...)
    if distribution == 'NORMAL':
      normal_params = results['highest'][0]  # for the streamed-predict leg
    preds = {}
    for pr in PRECISIONS:
      means, (q50, q975) = predict(
          pr, x, distribution, p, quantiles=(0.5, 0.975), ensemble_dims=2
      )
      preds[pr] = (means, q50, q975)
    count_model = distribution != 'NORMAL'
    for i, part in enumerate(('means', 'q50', 'q975')):
      name = f'predict/{distribution} {part}'
      if count_model and part != 'means':
        _count_quantile_agreement(
            name, preds['default'][i], preds['highest'][i], checks)
      else:
        _pred_agreement(
            name, preds['default'][i], preds['highest'][i], args.rtol,
            np.std(np.asarray(y)), checks)

  # VI: first-step ELBO agreement (NORMAL is the representative cell; the
  # per-distribution likelihoods are already covered by the MAP loop).
  vi = {pr: fit_vi(pr, sample_size_posterior=4) for pr in PRECISIONS}
  _loss_agreement(
      'vi/NORMAL first-step losses',
      np.asarray(vi['default'][1])[:, 0], np.asarray(vi['highest'][1])[:, 0],
      args.rtol, checks,
  )

  # VI predict: the ensemble_dims=3 path (groups x samples x members) —
  # means + an exact mixture quantile over the posterior-draw ensemble,
  # on the exact fit's draws.
  vi_p = tuple(d[jnp.newaxis] for d in vi['highest'][2])  # (1, E, S, ...)
  vi_preds = {}
  for pr in PRECISIONS:
    means, (q50,) = predict(
        pr, x, 'NORMAL', vi_p, quantiles=(0.5,), ensemble_dims=3
    )
    vi_preds[pr] = (means, q50)
  for i, part in enumerate(('means', 'q50')):
    _pred_agreement(
        f'vi-predict/NORMAL {part}',
        vi_preds['default'][i], vi_preds['highest'][i], args.rtol,
        np.std(np.asarray(y_normal)), checks)

  # likelihood_model's engine: raw forecast distribution parameters
  # (total_count/logits/pi) — the path `estimator.likelihood_model` serves
  # distributions from.
  p_zinb = tuple(v[jnp.newaxis] for v in results['highest'][0])  # ZINB fit
  fp = {}
  for pr in PRECISIONS:
    with _at(pr):
      fp[pr] = predict_lib.forecast_params_bnf(
          x, 'ZINB', p_zinb, config, ensemble_dims=2
      )
  for i, part in enumerate(('total_count', 'logits', 'pi')):
    _pred_agreement(
        f'likelihood-model/ZINB {part}',
        fp['default'][i], fp['highest'][i], args.rtol,
        float(np.std(np.asarray(fp['highest'][i]))) or 1.0, checks)

  # Streaming: host-resident dataset shipped to the device in step slices.
  # Two on-device contracts: (a) precision agreement on a streamed
  # minibatch fit; (b) slice-size bit-invariance — the slice size is pure
  # transfer granularity and must not change the math.
  # Streaming requires a true minibatch (batch < rows); cap at rows // 2 so
  # small --rows invocations stay legal instead of crashing the self-test.
  stream_batch = max(1, min(max(32, args.rows // 4), args.rows // 2))
  stream = {
      pr: fit_map(
          pr, y_normal, 'NORMAL', batch_size=stream_batch,
          stream_chunk_steps=2,
      )[1]
      for pr in PRECISIONS
  }
  _loss_agreement(
      'stream/NORMAL first-epoch losses',
      stream['default'][:, 0], stream['highest'][:, 0], args.rtol, checks,
  )
  _, losses_s3 = fit_map(
      'default', y_normal, 'NORMAL', batch_size=stream_batch,
      stream_chunk_steps=3,
  )
  bit_ok = bool(np.array_equal(stream['default'], losses_s3))
  checks.append({'check': 'stream/NORMAL slice bit-invariance',
                 'bitwise_equal': bit_ok, 'ok': bit_ok})
  print(f'{"PASS" if bit_ok else "FAIL"} stream/NORMAL slice '
        f'bit-invariance: chunk_steps 2 vs 3 '
        f'{"bitwise equal" if bit_ok else "DIFFER"}')

  # Count-model streaming under the streamed slice program.
  nb_stream = {
      pr: fit_map(
          pr, y_counts, 'NB', batch_size=stream_batch, stream_chunk_steps=2,
      )[1]
      for pr in PRECISIONS
  }
  _loss_agreement(
      'stream/NB first-epoch losses',
      nb_stream['default'][:, 0], nb_stream['highest'][:, 0], args.rtol,
      checks,
  )

  # VI streaming: per-step host-resampled batches.
  vi_stream = {
      pr: np.asarray(
          fit_vi(
              pr, sample_size_posterior=2, batch_size=stream_batch,
              stream_chunk_steps=2,
          )[1]
      )[:, 0]
      for pr in PRECISIONS
  }
  _loss_agreement(
      'stream-vi/NORMAL first-step losses',
      vi_stream['default'], vi_stream['highest'], args.rtol, checks,
  )

  # Out-of-core streamed predict: host-chunked rows with the global-
  # bracket two-pass scheme must reproduce the in-memory predict program
  # (same precision, meshless => bit-level expected; the tolerance guards
  # against cross-program fusion ulps on real hardware).
  p_norm = tuple(v[jnp.newaxis] for v in normal_params)
  sp_kwargs = dict(quantiles=(0.5, 0.975), ensemble_dims=2)
  mem = predict('default', x, 'NORMAL', p_norm, **sp_kwargs)
  streamed = predict(
      'default', np.asarray(x), 'NORMAL', p_norm,
      stream_chunk_rows=max(64, args.rows // 3), **sp_kwargs
  )
  _pred_agreement(
      'stream-predict/NORMAL means', streamed[0], mem[0], args.rtol,
      np.std(np.asarray(y_normal)), checks)
  for qi, part in enumerate(('q50', 'q975')):
    _pred_agreement(
        f'stream-predict/NORMAL {part}', streamed[1][qi], mem[1][qi],
        args.rtol, np.std(np.asarray(y_normal)), checks)

  ok = all(c['ok'] for c in checks)
  summary = {
      'platform': platform,
      'ok': ok,
      'num_checks': len(checks),
      'wall_s': round(time.perf_counter() - t0, 1),
      'failed': [c['check'] for c in checks if not c['ok']],
  }
  if args.json_out:
    with open(args.json_out, 'w') as f:
      json.dump(
          {
              **summary,
              'device_kind': jax.devices()[0].device_kind,
              'num_devices': jax.device_count(),
              'args': {
                  'rows': args.rows, 'width': args.width,
                  'epochs': args.epochs, 'ensemble': args.ensemble,
                  'rtol': args.rtol,
              },
              'checks': checks,
          },
          f,
          indent=2,
      )
      f.write('\n')
  print(json.dumps(summary))
  return 0 if ok else 1


if __name__ == '__main__':
  sys.exit(main())
