"""Executed competitor head-to-head: sklearn baselines vs BayesNF-TPU.

The framework exists to beat the paper's competitor methods
(`/root/reference/scripts/evaluate_baseline.py:821-1098` — RF, GBOOST
quantile regression, trend-surface OLS/RIDGE/LASSO on BayesNF's own
features), and the drivers have long been in `cli/evaluate_baseline.py`
— this runner actually EXECUTES them alongside BayesNF-TPU and commits
the comparison. Three legs:

- ``synthetic``: the ground-truth suite generator (`cli/synthetic.py` —
  the same field the correctness suite gates on), several seeds, NORMAL
  likelihood. Held-out rows are interleaved (field recovery, not
  forecasting), and the TRUE conditional mean is known, so test-region
  comparison is unconfounded. BayesNF MAP and VI run at the suite's
  budgets; the featurized GBOOST/TSREG legs are the headline baseline
  variants (the paper's strongest — they ride BayesNF's own
  seasonal/Fourier features).
- ``synthetic_nb``: the same protocol with Poisson counts around the
  known field — the paper's count-valued home domain. The sklearn
  baselines regress counts as continuous targets (what a practitioner
  without a count model does); BayesNF fits its native NB likelihood
  with integer zero-clamped quantiles.
- ``chickenpox8``: the bundled reference protocol (published MAP config,
  the PARITY.md §3 run). Train-region metrics are the parity-grade
  comparison (vs the reference golden); test-region numbers are
  reported but the bundled fixture's split is wildly extrapolative —
  train 100 weeks of ONE county, test 8 years later on four unseen
  counties — so they measure extrapolation conservatism, not paper-
  protocol forecast quality (see the leg's caveat field). VI is omitted
  here: the published VI batch size exceeds the bundled series
  (PARITY.md §3).

Per method and region: RMSE, MAE, CRPS, 95% coverage (and RMSE vs the
true mean on the synthetic leg). CRPS estimators per method:
- BayesNF: fair ensemble CRPS over posterior-predictive draws
  (`likelihood_model(...).sample`), as everywhere in this repo.
- RF: fair ensemble CRPS over the per-tree predictions (the forest IS an
  ensemble; its interval is the per-tree 2.5/97.5% quantiles).
- GBOOST: moment-matched Normal from the 50% head and the
  (2.5, 97.5)% heads' width (its three quantile heads define no full
  distribution).
- TSREG: closed-form Gaussian CRPS from the residual-variance band.

Usage (writes the committed artifact):

    python -m bayesnf_tpu.cli.baseline_headtohead --json-out baselines.json

Runs both synthetic legs × 3 seeds + the published chickenpox config.
`--quick` shrinks budgets for smoke runs;
`--legs` selects legs.

The CI gates live in `tests/test_baseline_headtohead.py`: on the NORMAL
synthetic leg BayesNF-MAP must beat every sklearn baseline on held-out
CRPS and true-mean recovery; on the count leg it must win RMSE / MAE /
true-mean recovery (CRPS deliberately ungated there — the featurized
GBOOST's pinball heads edge it ~9% at this budget, a calibration-width
trade documented in PARITY.md §2c).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from bayesnf_tpu import metrics as metrics_lib
from bayesnf_tpu.cli import evaluate_baseline
from bayesnf_tpu.cli import synthetic as synthetic_lib

_Z95 = 1.959964

# The synthetic protocol (mirrors tests/test_synthetic_suite.py budgets).
def synth_model(observation_model='NORMAL'):
  return dict(
      width=64,
      depth=2,
      seasonality_periods=[13.0, 52.0],
      num_seasonal_harmonics=[2, 4],
      feature_cols=['datetime', 'latitude', 'longitude'],
      target_col='y',
      observation_model=observation_model,
      timetype='index',
      freq='W',
      standardize=['latitude', 'longitude'],
  )


SYNTH_MODEL = synth_model()


def _metrics(y, yhat, lower, upper, crps, true_mean=None):
  out = {
      'rmse': round(float(metrics_lib.rmse(y, yhat)), 3),
      'mae': round(float(metrics_lib.mae(y, yhat)), 3),
      'crps': round(float(crps), 3),
      'coverage_95': round(float(metrics_lib.coverage(y, lower, upper)), 3),
  }
  if true_mean is not None:
    out['rmse_vs_true_mean'] = round(
        float(metrics_lib.rmse(true_mean, yhat)), 3
    )
  return out


def _timed(fn):
  start = time.perf_counter()
  out = fn()
  return out, round(time.perf_counter() - start, 2)


# --- sklearn baselines on raw (x, y) matrices ------------------------------
#
# Same estimators/hyperparameters as the artifact CLI
# (`evaluate_baseline.run_rf/run_gboost/run_tsreg`), returning predictions
# instead of writing CSVs so each method's native uncertainty
# representation feeds its CRPS estimator. `random_state=0` pins the
# stochastic fits so the committed artifact is regenerable bit-for-bit
# (the artifact CLI, like the reference, leaves them unseeded).


def fit_rf(x_tr, y_tr, x_te):
  from sklearn.ensemble import RandomForestRegressor

  model, secs = _timed(
      lambda: RandomForestRegressor(random_state=0).fit(x_tr, y_tr)
  )
  tree_preds = np.stack([est.predict(x_te) for est in model.estimators_])
  return {
      'yhat': model.predict(x_te),
      'lower': np.quantile(tree_preds, 0.025, axis=0),
      'upper': np.quantile(tree_preds, 0.975, axis=0),
      'crps_fn': lambda y: metrics_lib.crps_ensemble(y, tree_preds, fair=True),
      'fit_seconds': secs,
  }


def fit_gboost(x_tr, y_tr, x_te):
  from sklearn.ensemble import GradientBoostingRegressor

  def build():
    return {
        alpha: GradientBoostingRegressor(
            loss='quantile', alpha=alpha, random_state=0,
            **evaluate_baseline.GBOOST_PARAMS,
        ).fit(x_tr, y_tr)
        for alpha in (0.025, 0.5, 0.975)
    }

  models, secs = _timed(build)
  yhat = models[0.5].predict(x_te)
  lower = models[0.025].predict(x_te)
  upper = models[0.975].predict(x_te)
  scale = np.maximum((upper - lower) / (2 * _Z95), 1e-6)
  return {
      'yhat': yhat,
      'lower': lower,
      'upper': upper,
      'crps_fn': lambda y: metrics_lib.crps_normal(y, yhat, scale),
      'fit_seconds': secs,
  }


def fit_tsreg(x_tr, y_tr, x_te, method='OLS'):
  import sklearn.linear_model

  cls = {
      'OLS': sklearn.linear_model.LinearRegression,
      'RIDGE': sklearn.linear_model.Ridge,
      'LASSO': sklearn.linear_model.Lasso,
  }[method]
  model, secs = _timed(lambda: cls().fit(x_tr, y_tr))
  rss = np.sum(np.square(model.predict(x_tr) - y_tr))
  dof = max(x_tr.shape[0] - x_tr.shape[1], 1)
  std = float(np.sqrt(rss / dof))
  yhat = model.predict(x_te)
  return {
      'yhat': yhat,
      'lower': yhat - _Z95 * std,
      'upper': yhat + _Z95 * std,
      'crps_fn': lambda y: metrics_lib.crps_normal(y, yhat, std),
      'fit_seconds': secs,
  }


def sklearn_methods(x_tr, y_tr, x_te, featurize):
  """All seven sklearn baseline variants on one split.

  `featurize` maps a raw handler matrix to the seasonal/Fourier design
  the featurized GBOOST/TSREG variants train on (the paper's strongest
  versions of those baselines).
  """
  xf_tr, xf_te = featurize(x_tr), featurize(x_te)
  out = {
      'rf': fit_rf(x_tr, y_tr, x_te),
      'gboost_raw': fit_gboost(x_tr, y_tr, x_te),
      'gboost_featurized': fit_gboost(xf_tr, y_tr, xf_te),
  }
  for method in ('OLS', 'RIDGE', 'LASSO'):
    out[f'tsreg_{method.lower()}'] = fit_tsreg(
        xf_tr, y_tr, xf_te, method=method
    )
  return out


# --- BayesNF on DataFrames -------------------------------------------------


def _bnf_predictions(model, df_test, key):
  """(yhat, lower, upper, crps_fn) via the public predict + draw paths."""
  means, (q50, lo, hi) = model.predict(
      df_test, quantiles=(0.5, 0.025, 0.975)
  )
  del q50
  yhat = np.asarray(means)
  yhat = yhat.reshape(-1, yhat.shape[-1]).mean(axis=0)
  dist = model.likelihood_model(df_test)
  draws = np.asarray(dist.sample(key, sample_shape=(8,))).reshape(
      -1, len(df_test)
  )
  return {
      'yhat': yhat,
      'lower': np.asarray(lo),
      'upper': np.asarray(hi),
      'crps_fn': lambda y: metrics_lib.crps_ensemble(y, draws, fair=True),
  }


def fit_bnf_synthetic(objective, df_train, df_test, quick,
                      observation_model='NORMAL'):
  import jax

  from bayesnf_tpu import spatiotemporal

  cls = {
      'map': spatiotemporal.BayesianNeuralFieldMAP,
      'vi': spatiotemporal.BayesianNeuralFieldVI,
  }[objective]
  model = cls(**synth_model(observation_model))
  fit_kwargs = dict(seed=jax.random.PRNGKey(1), ensemble_size=8)
  if objective == 'vi':
    # NORMAL converges by 500 ELBO steps (the suite's budget); the count
    # likelihood's shape/mean surrogate needs more — measured on seed 0:
    # 500/1000/2000 steps -> CRPS 3.23/2.82/2.26, rmse_vs_true
    # 3.76/3.42/1.37 (2000 is converged; MAP's count budget gets the
    # same treatment at 800).
    full = 500 if observation_model == 'NORMAL' else 2000
    fit_kwargs.update(
        num_epochs=50 if quick else full, learning_rate=0.01,
        batch_size=None, sample_size_posterior=10,
    )
  else:
    # Count likelihoods need more steps to converge at lr 0.005 (the
    # suite's budgets — tests/test_synthetic_suite.py).
    full = 300 if observation_model == 'NORMAL' else 800
    fit_kwargs.update(
        num_epochs=50 if quick else full, learning_rate=0.005
    )
  _, secs = _timed(lambda: model.fit(df_train, **fit_kwargs))
  out = _bnf_predictions(model, df_test, jax.random.PRNGKey(5))
  out['fit_seconds'] = secs
  return out


# --- legs ------------------------------------------------------------------


def run_synthetic_leg(seeds, quick, observation_model='NORMAL',
                      include_vi=True):
  """Per-seed head-to-head on the known-field generator; mean-aggregated.

  With a count `observation_model` (NB), the sklearn baselines regress
  the counts as continuous targets (exactly what a practitioner without
  a count model does) while BayesNF fits its native count likelihood —
  the comparison the paper's count-valued domains actually pose.
  """
  from bayesnf_tpu.data import SpatiotemporalDataHandler

  per_method = {}
  for seed in range(seeds):
    df_train, df_test = synthetic_lib.make_series(
        observation_model, seed=seed
    )
    handler = SpatiotemporalDataHandler(
        SYNTH_MODEL['feature_cols'], SYNTH_MODEL['target_col'],
        SYNTH_MODEL['timetype'], SYNTH_MODEL['freq'],
        standardize=SYNTH_MODEL['standardize'],
    )
    x_tr = np.asarray(handler.get_train(df_train), dtype=np.float64)
    y_tr = np.asarray(handler.get_target(df_train), dtype=np.float64)
    x_te = np.asarray(
        handler.get_test(handler.copy_and_filter_table(df_test)),
        dtype=np.float64,
    )
    y_te = df_test['y'].to_numpy(dtype=np.float64)
    mu_te = df_test['true_mean'].to_numpy(dtype=np.float64)

    featurize = lambda x: evaluate_baseline.featurize(
        x,
        seasonality_periods=SYNTH_MODEL['seasonality_periods'],
        num_seasonal_harmonics=SYNTH_MODEL['num_seasonal_harmonics'],
    )
    runs = sklearn_methods(x_tr, y_tr, x_te, featurize)
    runs['bnf_map'] = fit_bnf_synthetic(
        'map', df_train, df_test, quick, observation_model
    )
    if include_vi:  # the CI gates pin MAP only and skip the VI fit
      runs['bnf_vi'] = fit_bnf_synthetic(
          'vi', df_train, df_test, quick, observation_model
      )

    for name, run in runs.items():
      m = _metrics(
          y_te, run['yhat'], run['lower'], run['upper'],
          run['crps_fn'](y_te), true_mean=mu_te,
      )
      m['fit_seconds'] = run['fit_seconds']
      per_method.setdefault(name, []).append(m)

  leg = {}
  for name, runs in per_method.items():
    leg[name] = {
        'per_seed': runs,
        'mean': {
            k: round(float(np.mean([r[k] for r in runs])), 3)
            for k in runs[0]
        },
    }
  return leg


def run_chickenpox_leg(data_root, quick):
  """The bundled reference protocol: published BNF-MAP config + baselines."""
  import jax

  from bayesnf_tpu.cli import evaluate
  from bayesnf_tpu.cli import registry

  inference = registry.inference_config('chickenpox', 'map')
  if quick:
    inference.update(num_particles=8, num_epochs=200)

  out_dir = tempfile.mkdtemp(prefix='bnf_h2h_')
  evaluate.run_experiment(
      dataset='chickenpox',
      data_root=data_root,
      series_id='8',
      output_dir=out_dir,
      objective='map',
      seed=jax.random.PRNGKey(2023100400 + 8),
      inference_config=inference,
  )
  run_log = json.load(
      open(os.path.join(out_dir, 'bnf-map.chickenpox.8.log.json'))
  )
  leg = {
      'bnf_map': {
          region: {
              k: round(float(v), 3) for k, v in vals.items()
          }
          for region, vals in run_log['metrics'].items()
      }
  }
  leg['bnf_map']['fit_seconds'] = round(run_log['runtime'], 1)

  x_tr, y_tr, x_te, y_te, _, _ = evaluate_baseline.load_series(
      data_root, 'chickenpox', '8'
  )
  x_tr = np.asarray(x_tr, np.float64)
  x_te = np.asarray(x_te, np.float64)
  y_tr = np.asarray(y_tr, np.float64)
  y_te = np.asarray(y_te, np.float64)
  featurize = lambda x: evaluate_baseline.featurize(x, 'chickenpox')
  for name, run in sklearn_methods(x_tr, y_tr, x_te, featurize).items():
    # Refit-free train-region scores: each fit_* predicts on the matrix
    # it was handed; run them again on the train matrix for the train
    # region (sklearn fits here are sub-second).
    leg[name] = {
        'test': _metrics(
            y_te, run['yhat'], run['lower'], run['upper'],
            run['crps_fn'](y_te),
        ),
        'fit_seconds': run['fit_seconds'],
    }
  for name, run in sklearn_methods(
      x_tr, y_tr, x_tr, featurize
  ).items():
    leg[name]['train'] = _metrics(
        y_tr, run['yhat'], run['lower'], run['upper'], run['crps_fn'](y_tr)
    )
  leg['caveat'] = (
      'the bundled fixture is a wildly extrapolative mini-split: train = '
      '100 weeks (2005-06) of ONE county, test = 2014 (8 years later) of '
      'FOUR counties never seen in training. Test numbers here measure '
      'how conservatively a method extrapolates (range-clamped trees '
      'fare best), not forecast quality on the paper protocol, which '
      'trains on the full panel (PARITY.md §3). The parity-grade '
      'comparison on this leg is bnf_map vs the reference golden '
      '(PARITY_rNN.json: our train RMSE/CRPS slightly beat the golden); '
      'the unconfounded method comparison is the synthetic leg. VI '
      'omitted: the published VI batch size exceeds the bundled series.'
  )
  return leg


_DATA_ROOT = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    'tests', 'test_data',
)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--json-out', required=True)
  parser.add_argument('--legs', default='synthetic,synthetic_nb,chickenpox8')
  parser.add_argument('--seeds', type=int, default=3,
                      help='synthetic-leg seeds (mean-aggregated)')
  parser.add_argument('--quick', action='store_true',
                      help='shrunken budgets (smoke runs only)')
  parser.add_argument('--data_root', default=_DATA_ROOT)
  args = parser.parse_args(argv)

  import jax

  artifact = {
      'command': (
          'python -m bayesnf_tpu.cli.baseline_headtohead '
          f'--json-out {os.path.basename(args.json_out)}'
          + (f' --seeds {args.seeds}' if args.seeds != 3 else '')
          + (' --quick' if args.quick else '')
      ),
      'device_kind': jax.devices()[0].device_kind,
      'backend': jax.default_backend(),
      'quick': bool(args.quick),
      'legs': {},
  }
  legs = [l.strip() for l in args.legs.split(',') if l.strip()]
  if 'synthetic' in legs:
    artifact['legs']['synthetic'] = {
        'protocol': (
            f'cli/synthetic.py make_series("NORMAL", seed), '
            f'{args.seeds} seeds, ~187 held-out rows each; BNF at the '
            'synthetic-suite budgets; featurized GBOOST/TSREG are the '
            'headline baseline variants'
        ),
        **run_synthetic_leg(args.seeds, args.quick),
    }
  if 'synthetic_nb' in legs:
    artifact['legs']['synthetic_nb'] = {
        'protocol': (
            f'cli/synthetic.py make_series("NB", seed) — Poisson counts '
            f'around the known field — {args.seeds} seeds; sklearn '
            'baselines regress the counts as continuous targets, '
            'BayesNF fits its native NB likelihood (integer zero-clamped '
            'quantiles)'
        ),
        **run_synthetic_leg(args.seeds, args.quick, observation_model='NB'),
    }
  if 'chickenpox8' in legs:
    artifact['legs']['chickenpox8'] = run_chickenpox_leg(
        args.data_root, args.quick
    )

  with open(args.json_out, 'w') as f:
    json.dump(artifact, f, indent=2)
    f.write('\n')

  # Human-readable summary: the synthetic mean tables.
  for leg_name in ('synthetic', 'synthetic_nb'):
    synth = artifact['legs'].get(leg_name)
    if not synth:
      continue
    rows = [
        (name, vals['mean'])
        for name, vals in synth.items()
        if isinstance(vals, dict) and 'mean' in vals
    ]
    rows.sort(key=lambda r: r[1]['crps'])
    print(f'-- {leg_name}')
    print(f'{"method":<20} {"crps":>7} {"rmse":>7} {"mae":>7} '
          f'{"cov95":>6} {"rmse_true":>9}')
    for name, m in rows:
      print(f'{name:<20} {m["crps"]:>7} {m["rmse"]:>7} {m["mae"]:>7} '
            f'{m["coverage_95"]:>6} {m["rmse_vs_true_mean"]:>9}')
  print(f'wrote {args.json_out}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
