"""Executable air-quality tutorial: hourly PM10 -> fit -> forecast -> figures.

Mirrors the reference's London air-quality notebook
(/root/reference/docs/tutorials/BayesNF_Tutorial_on_London_Air_Quality.md):
hourly PM10 across a network of monitoring sites, daily + weekly
seasonality, width-512 MAP ensemble. The notebook reads the London
Air Quality Network extract; with no network egress here the script
builds a synthetic stand-in with the same schema and scale (12 sites,
hourly, ~4 months) and documents it as such.

Run:  python docs/tutorials/run_air_quality.py
Outputs: docs/tutorials/figures/air_quality_*.png + stdout metrics block
(the executed outputs embedded in docs/tutorials/air_quality.md).
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

# 12 monitoring sites scattered over Greater London.
SITES = {
    'Bloomsbury': (51.522, -0.126), 'Eltham': (51.453, 0.071),
    'Haringey': (51.599, -0.068), 'Harlington': (51.488, -0.442),
    'Hillingdon': (51.496, -0.461), 'Lewisham': (51.445, -0.020),
    'Marylebone': (51.523, -0.155), 'N.Kensington': (51.521, -0.214),
    'Southwark': (51.505, -0.092), 'Teddington': (51.424, -0.313),
    'Thurrock': (51.477, 0.318), 'Westminster': (51.494, -0.132),
}


def make_dataset(seed=0):
  """Synthetic hourly PM10 (ug/m3): daily + weekly cycles, site offsets."""
  rng = np.random.default_rng(seed)
  times = pd.date_range('2019-02-01', '2019-05-31 23:00', freq='h')
  hour = times.hour.values
  dow = times.dayofweek.values
  t = np.arange(len(times))
  # Slow synoptic weather driver shared across sites.
  synoptic = 6.0 * np.sin(2 * np.pi * t / (24 * 11.0) + 1.0)
  rows = []
  for site, (lat, lon) in SITES.items():
    base = 22.0 + 16.0 * np.exp(-((lat - 51.52) ** 2 +
                                  (lon + 0.14) ** 2) / 0.02)
    daily = 5.5 * np.cos(2 * np.pi * (hour - 9) / 24.0) + 2.5 * np.cos(
        4 * np.pi * (hour - 9) / 24.0
    )
    weekly = -3.0 * ((dow >= 5).astype(float)) + 1.0 * np.cos(
        2 * np.pi * dow / 7.0
    )
    mean = base + daily + weekly + synoptic
    y = np.maximum(mean + 3.0 * rng.standard_gamma(2.0, len(times)) - 6.0
                   + 1.5 * rng.normal(size=len(times)), 0.5)
    for i, ts in enumerate(times):
      rows.append(dict(location=site, datetime=ts, latitude=lat,
                       longitude=lon, pm10=float(y[i])))
  df = pd.DataFrame(rows)
  df.index = np.arange(len(df))
  return df


def main():
  os.makedirs(FIGDIR, exist_ok=True)
  # Cached reruns skip the XLA compile of the fit and predict programs.
  profiling.enable_compile_cache(os.path.join(REPO_ROOT, '.jax_cache'))
  print(f'devices: {jax.devices()}')

  df = make_dataset()
  df_train = df[df.datetime < '2019-05-18'].copy()
  df_test = df[df.datetime >= '2019-05-18'].copy()
  print(f'train rows: {len(df_train)}  test rows: {len(df_test)} '
        f'({df.location.nunique()} sites)')

  # --- Figure 1: one week of data at three sites.
  fig, ax = plt.subplots(figsize=(9, 3.2), layout='constrained')
  window = (df.datetime >= '2019-03-04') & (df.datetime < '2019-03-11')
  for site, color in [('Marylebone', C1), ('Teddington', C2),
                      ('Thurrock', C3)]:
    d = df[window & (df.location == site)]
    ax.plot(d.datetime, d.pm10, color=color, lw=1.4, label=site)
  ax.legend(frameon=False, ncols=3, loc='upper right')
  ax.set_ylabel('PM10 (ug/m3)')
  ax.set_title('Synthetic London PM10, one week (3 of 12 sites)',
               loc='left', color=INK)
  fig.savefig(os.path.join(FIGDIR, 'air_quality_data.png'), dpi=120)
  plt.close(fig)

  # --- Fit: the reference tutorial's configuration.
  model = BayesianNeuralFieldMAP(
      width=512,
      depth=2,
      freq='h',
      seasonality_periods=['D', 'W'],     # 24 h and 168 h
      num_seasonal_harmonics=[4, 4],
      feature_cols=['datetime', 'latitude', 'longitude'],
      target_col='pm10',
      observation_model='NORMAL',
      timetype='index',
      standardize=['latitude', 'longitude'],
  )
  fit_kwargs = dict(
      seed=jax.random.PRNGKey(0), ensemble_size=8, learning_rate=0.005,
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
  print(f'fit: 8 members x 5000 epochs on {len(df_train)} rows in '
        f'{fit_s:.1f} s on {n_chips} chip(s) = '
        f'{8 * 5000 / fit_s / n_chips:.0f} member-steps/s/chip '
        f'(one-time compile: {warm_s:.0f} s)')

  # --- Predict the final two weeks.
  t0 = time.perf_counter()
  yhat, (p50, lo, hi) = model.predict(
      df_test, quantiles=(0.5, 0.025, 0.975)
  )
  pred_s = time.perf_counter() - t0
  yhat_mean = np.asarray(yhat).reshape(-1, len(df_test)).mean(axis=0)
  y = df_test.pm10.values
  rmse = float(np.sqrt(np.mean((yhat_mean - y) ** 2)))
  mae = float(np.mean(np.abs(yhat_mean - y)))
  cov = float(np.mean((y >= np.asarray(lo)) & (y <= np.asarray(hi))))
  print(f'predict: {len(df_test)} rows in {pred_s:.1f} s')
  print(f'holdout (last 2 weeks): RMSE {rmse:.2f}  MAE {mae:.2f}  '
        f'(target std {y.std():.2f})  95% coverage {cov:.3f}')

  # --- Figure 2: 3-day forecast zoom at two sites.
  fig, axes = plt.subplots(2, 1, figsize=(9, 5.0), sharex=True,
                           layout='constrained')
  zoom = (df_test.datetime >= '2019-05-20') & (df_test.datetime < '2019-05-23')
  for ax, (site, color) in zip(axes, [('Marylebone', C1),
                                      ('Teddington', C2)]):
    m = (zoom & (df_test.location == site)).values
    d = df_test[m]
    ax.fill_between(d.datetime, np.asarray(lo)[m], np.asarray(hi)[m],
                    color=color, alpha=0.18, lw=0)
    ax.plot(d.datetime, yhat_mean[m], color=color, lw=2.0,
            label='forecast mean')
    ax.plot(d.datetime, d.pm10, color=INK2, lw=0, marker='o', ms=2.5,
            label='observed')
    ax.set_ylabel(f'{site}\nPM10 (ug/m3)', color=INK2)
    if ax is axes[0]:
      ax.legend(frameon=False, ncols=2, loc='upper right')
  axes[0].set_title('Hold-out forecasts with 95% intervals (3-day zoom)',
                    loc='left', color=INK)
  fig.savefig(os.path.join(FIGDIR, 'air_quality_forecasts.png'), dpi=120)
  plt.close(fig)

  print('figures written to', FIGDIR)


if __name__ == '__main__':
  main()
