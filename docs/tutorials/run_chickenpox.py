"""Executable chickenpox tutorial: data -> fit -> forecast -> figures.

Mirrors the reference's Hungarian-chickenpox notebook
(/root/reference/docs/tutorials/BayesNF_Tutorial_on_Hungarian_Chickenpox.md)
end-to-end. The notebook downloads the UCI dataset at runtime; this
environment has no network egress, so the script builds a synthetic
stand-in with the same schema and scale — 20 county-level weekly series,
2005-2014, winter-peaked seasonality, count noise — and documents it as
such. Everything downstream (model config, fit budget, prediction,
figures) matches the published tutorial.

Run:  python docs/tutorials/run_chickenpox.py
Outputs: docs/tutorials/figures/chickenpox_*.png + stdout metrics block
(the executed outputs embedded in docs/tutorials/chickenpox.md).
"""

import os
import time

import jax
import matplotlib

matplotlib.use('Agg')
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd

from bayesnf_tpu import BayesianNeuralFieldMAP
from bayesnf_tpu.utils import profiling

FIGDIR = os.path.join(os.path.dirname(__file__), 'figures')
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Data-viz palette (skill reference instance, light mode).
C1, C2, C3 = '#2a78d6', '#eb6834', '#1baf7a'
INK, INK2, GRID, SURFACE = '#0b0b0b', '#52514e', '#e5e4e0', '#fcfcfb'

plt.rcParams.update({
    'figure.facecolor': SURFACE,
    'axes.facecolor': SURFACE,
    'savefig.facecolor': SURFACE,
    'text.color': INK,
    'axes.labelcolor': INK2,
    'xtick.color': INK2,
    'ytick.color': INK2,
    'axes.edgecolor': GRID,
    'axes.grid': True,
    'grid.color': GRID,
    'grid.linewidth': 0.6,
    'axes.spines.top': False,
    'axes.spines.right': False,
    'font.size': 11,
})

# Approximate centroids of the 20 Hungarian counties (as in the UCI data).
COUNTIES = {
    'BACS': (46.57, 19.38), 'BARANYA': (46.05, 18.23), 'BEKES': (46.68, 21.10),
    'BORSOD': (48.10, 20.78), 'BUDAPEST': (47.50, 19.04),
    'CSONGRAD': (46.25, 20.15), 'FEJER': (47.19, 18.41), 'GYOR': (47.68, 17.63),
    'HAJDU': (47.53, 21.63), 'HEVES': (47.90, 20.37), 'JASZ': (47.17, 20.20),
    'KOMAROM': (47.69, 18.27), 'NOGRAD': (48.00, 19.50), 'PEST': (47.40, 19.33),
    'SOMOGY': (46.36, 17.80), 'SZABOLCS': (47.96, 22.00), 'TOLNA': (46.47, 18.56),
    'VAS': (47.23, 16.62), 'VESZPREM': (47.09, 17.91), 'ZALA': (46.84, 16.85),
}


def make_dataset(seed=0):
  """Synthetic 20-county weekly chickenpox counts, 2005-2014.

  Winter-peaked annual cycle with a school-term sub-harmonic, county scale
  set by a smooth spatial gradient, negative-binomial-like dispersion —
  the same long-format schema as the UCI download used by the reference.
  """
  rng = np.random.default_rng(seed)
  dates = pd.date_range('2005-01-03', '2014-12-29', freq='W-MON')
  phase = 2 * np.pi * (dates.dayofyear.values / 365.25)
  rows = []
  for county, (lat, lon) in COUNTIES.items():
    scale = np.exp(
        3.2 + 0.45 * (lat - 47.1) + 0.25 * (lon - 19.2)
        + 0.2 * rng.normal()
    )
    season = np.exp(
        0.95 * np.cos(phase - 0.5)          # winter peak
        + 0.18 * np.cos(2 * phase - 1.2)    # school-term harmonic
    )
    mean = scale * season
    # Gamma-Poisson mixture => NB-like overdispersion (r = 12).
    lam = rng.gamma(12.0, mean / 12.0)
    y = rng.poisson(lam)
    for i, d in enumerate(dates):
      rows.append(dict(location=county, datetime=d, latitude=lat,
                       longitude=lon, chickenpox=float(y[i])))
  df = pd.DataFrame(rows)
  df.index = np.arange(len(df))
  return df


def main():
  os.makedirs(FIGDIR, exist_ok=True)
  # Cached reruns skip the XLA compile of the fit and predict programs.
  profiling.enable_compile_cache(os.path.join(REPO_ROOT, '.jax_cache'))
  print(f'devices: {jax.devices()}')

  df = make_dataset()
  df_train = df[df.datetime < '2014-01-01'].copy()
  df_test = df[df.datetime >= '2014-01-01'].copy()
  print(f'train rows: {len(df_train)}  test rows: {len(df_test)} '
        f'({df.location.nunique()} counties)')

  # --- Figure 1: the raw series for three counties.
  fig, ax = plt.subplots(figsize=(9, 3.2), layout='constrained')
  for county, color in [('PEST', C1), ('BACS', C2), ('ZALA', C3)]:
    d = df[df.location == county]
    ax.plot(d.datetime, d.chickenpox, color=color, lw=1.4, label=county)
  ax.legend(frameon=False, ncols=3, loc='upper right')
  ax.set_ylabel('weekly cases')
  ax.set_title('Synthetic Hungarian chickenpox data (3 of 20 counties)',
               loc='left', color=INK)
  fig.savefig(os.path.join(FIGDIR, 'chickenpox_data.png'), dpi=120)
  plt.close(fig)

  # --- Fit: the reference tutorial's exact model configuration.
  model = BayesianNeuralFieldMAP(
      width=256,
      depth=2,
      freq='W',
      seasonality_periods=['M', 'Y'],     # ~4.35 and ~52.18 weeks
      num_seasonal_harmonics=[2, 10],
      feature_cols=['datetime', 'latitude', 'longitude'],
      target_col='chickenpox',
      observation_model='NORMAL',
      timetype='index',
      standardize=['latitude', 'longitude'],
  )
  fit_kwargs = dict(
      seed=jax.random.PRNGKey(0), ensemble_size=64, learning_rate=0.005,
  )
  # Warm the XLA caches with a tiny fit at the same shapes, so the
  # reported fit time measures training, not one-time compilation.
  t0 = time.perf_counter()
  model.fit(df_train, num_epochs=10, **fit_kwargs)
  warm_s = time.perf_counter() - t0
  t0 = time.perf_counter()
  model.fit(df_train, num_epochs=5000, **fit_kwargs)
  fit_s = time.perf_counter() - t0
  n_chips = len(jax.devices())
  print(f'fit: 64 members x 5000 epochs in {fit_s:.1f} s on {n_chips} '
        f'chip(s) = {64 * 5000 / fit_s / n_chips:.0f} member-steps/s/chip '
        f'(one-time compile: {warm_s:.0f} s)')

  # --- Figure 2: ensemble loss curves.
  losses = np.asarray(model.losses_).reshape(-1, np.asarray(model.losses_).shape[-1])
  fig, ax = plt.subplots(figsize=(7, 3.0), layout='constrained')
  ax.plot(losses.T, color=C1, alpha=0.12, lw=0.8)
  ax.plot(losses.mean(axis=0), color=C1, lw=2.0, label='ensemble mean')
  ax.set_xlabel('epoch')
  ax.set_ylabel('negative log joint')
  ax.set_yscale('log')
  ax.legend(frameon=False)
  ax.set_title('MAP ensemble training loss (64 members)', loc='left',
               color=INK)
  fig.savefig(os.path.join(FIGDIR, 'chickenpox_losses.png'), dpi=120)
  plt.close(fig)

  # --- Predict the 2014 hold-out year with calibrated intervals.
  t0 = time.perf_counter()
  yhat, (p50, lo, hi) = model.predict(
      df_test, quantiles=(0.5, 0.025, 0.975)
  )
  pred_s = time.perf_counter() - t0
  yhat_mean = np.asarray(yhat).reshape(-1, len(df_test)).mean(axis=0)
  y = df_test.chickenpox.values
  rmse = float(np.sqrt(np.mean((yhat_mean - y) ** 2)))
  mae = float(np.mean(np.abs(yhat_mean - y)))
  cov = float(np.mean((y >= np.asarray(lo)) & (y <= np.asarray(hi))))
  print(f'predict: {len(df_test)} rows in {pred_s:.1f} s')
  print(f'holdout 2014: RMSE {rmse:.2f}  MAE {mae:.2f}  '
        f'(target std {y.std():.2f})  95% coverage {cov:.3f}')

  # --- Figure 3: forecasts with 95% bands, three counties.
  fig, axes = plt.subplots(3, 1, figsize=(9, 6.6), sharex=True,
                           layout='constrained')
  for ax, (county, color) in zip(
      axes, [('PEST', C1), ('BACS', C2), ('ZALA', C3)]
  ):
    m = (df_test.location == county).values
    d = df_test[m]
    ax.fill_between(d.datetime, np.asarray(lo)[m], np.asarray(hi)[m],
                    color=color, alpha=0.18, lw=0)
    ax.plot(d.datetime, yhat_mean[m], color=color, lw=2.0,
            label='forecast mean')
    ax.plot(d.datetime, d.chickenpox, color=INK2, lw=0, marker='o', ms=3.0,
            label='observed')
    ax.set_ylabel(county, color=INK2)
    if ax is axes[0]:
      ax.legend(frameon=False, ncols=2, loc='upper right')
  axes[0].set_title('2014 hold-out forecasts with 95% intervals',
                    loc='left', color=INK)
  fig.savefig(os.path.join(FIGDIR, 'chickenpox_forecasts.png'), dpi=120)
  plt.close(fig)

  print('figures written to', FIGDIR)


if __name__ == '__main__':
  main()
