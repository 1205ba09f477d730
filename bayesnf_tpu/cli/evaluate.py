"""Experiment CLI: train + predict on the paper's spatiotemporal datasets.

Artifact parity with the reference harness (`scripts/evaluate.py:50-152`):
per (objective, dataset, series) run it writes

- ``bnf-{objective}.{dataset}.{series}.log.json`` — runtime + configs,
- ``...loss.csv``   — per-particle loss curves (columns = particles),
- ``...pred.csv``   — yhat (ensemble-mean), yhat_p50 / yhat_lower /
  yhat_upper at quantiles (0.5, 0.025, 0.975), sorted by original index.

Usage:
  python -m bayesnf_tpu.cli.evaluate --dataset=chickenpox --objective=map \
      --data_root=/path/to/csvs --output_dir=/tmp/out --start_id=5 --stop_id=6

Input files follow the reference layout: ``{dataset}.{series}.train.csv``
and ``{dataset}.{series}.test.csv`` with a ``datetime`` column.
"""

import argparse
import json
import os
import time

import jax
import numpy as np
import pandas as pd

from bayesnf_tpu import spatiotemporal
from bayesnf_tpu.cli import registry
from bayesnf_tpu.utils import profiling

_ESTIMATORS = {
    'map': spatiotemporal.BayesianNeuralFieldMAP,
    'mle': spatiotemporal.BayesianNeuralFieldMLE,
    'vi': spatiotemporal.BayesianNeuralFieldVI,
}


def run_experiment(
    dataset: str,
    data_root: str,
    series_id,
    output_dir: str,
    objective: str,
    seed: jax.Array,
    dataset_config: dict | None = None,
    model_config: dict | None = None,
    inference_config: dict | None = None,
    quantiles=(0.5, 0.025, 0.975),
):
  """Train one series, predict train+test, write the three artifacts."""
  dataset_config = dataset_config or registry.dataset_config(dataset)
  model_config = dict(model_config or registry.model_config(dataset, objective))
  inference_config = dict(
      inference_config or registry.inference_config(dataset, objective)
  )

  df_train = pd.read_csv(
      os.path.join(data_root, f'{dataset}.{series_id}.train.csv'),
      index_col=0,
      parse_dates=['datetime'],
  )
  df_test = pd.read_csv(
      os.path.join(data_root, f'{dataset}.{series_id}.test.csv'),
      index_col=0,
      parse_dates=['datetime'],
  )

  os.makedirs(output_dir, exist_ok=True)
  stem = os.path.join(output_dir, f'bnf-{objective}.{dataset}.{series_id}')

  model_config.update(
      feature_cols=dataset_config['feature_cols'],
      target_col=dataset_config['target_col'],
      timetype=dataset_config['timetype'],
      freq=dataset_config.get('freq'),
      standardize=dataset_config.get('standardize'),
  )

  fit_kwargs = dict(
      learning_rate=inference_config['learning_rate'],
      num_epochs=inference_config['num_epochs'],
      batch_size=inference_config.get('batch_size'),
      ensemble_size=inference_config['num_particles'],
  )
  for key in ('precision', 'stream_chunk_steps', 'stream_member_remix'):
    if key in inference_config:
      fit_kwargs[key] = inference_config[key]
  if inference_config.get('data_devices'):
    from bayesnf_tpu.parallel import mesh as mesh_lib

    fit_kwargs['mesh'] = mesh_lib.default_mesh(
        data_devices=int(inference_config['data_devices'])
    )
  if objective == 'vi':
    fit_kwargs.update(
        kl_weight=inference_config.get('kl_weight', 1.0),
        sample_size_divergence=inference_config.get(
            'sample_size_divergence', 10
        ),
    )
  else:
    fit_kwargs.update(
        num_splits=inference_config.get('num_particle_splits', 1)
    )

  start = time.perf_counter()
  with profiling.maybe_trace(os.environ.get('BNF_PROFILE_DIR')):
    model = _ESTIMATORS[objective](**model_config).fit(
        df_train, seed, **fit_kwargs
    )
    df_all = pd.concat([df_train, df_test])
    means, quants = model.predict(
        df_all, quantiles=quantiles,
        stream_chunk_rows=inference_config.get('stream_chunk_rows'),
        stream_cache_bytes=inference_config.get('stream_cache_bytes'),
    )
  runtime = time.perf_counter() - start
  losses = model.losses_

  # Accuracy metrics per region (the paper's headline comparison is
  # CRPS-based — reference README.md:24-30; its baseline harness logs
  # RMSE/NLPD at scripts/evaluate_baseline.py:523-548, while the BNF CLI
  # itself logged only runtime). CRPS uses the fair ensemble estimator
  # over posterior-predictive draws from the public likelihood_model path.
  from bayesnf_tpu import metrics as metrics_lib

  # `means`/`draws` cover every row of df_all (prediction keeps NaN-target
  # rows); metrics restrict POSITIONALLY to the valid-target rows. The
  # train/test split is positional too — concat preserves row order, and
  # train/test CSVs routinely reuse index labels, so index-set membership
  # would mislabel test rows.
  target_col = dataset_config['target_col']
  valid = df_all[target_col].notna().to_numpy()
  y_all = df_all.loc[valid, target_col].to_numpy(dtype=np.float64)
  means_host = np.asarray(means)  # one device->host materialization
  yhat_all = means_host.mean(
      axis=tuple(range(means_host.ndim - 1))
  )[valid]
  key = jax.random.PRNGKey(seed) if isinstance(seed, int) else seed
  sample_key = jax.random.fold_in(key, 1)
  stream_rows = inference_config.get('stream_chunk_rows')
  if stream_rows is None:
    dist = model.likelihood_model(df_all)
    draws = np.asarray(
        dist.sample(sample_key, sample_shape=(8,))
    ).reshape(-1, len(valid))[:, valid]
  else:
    # Out-of-core metrics: with --stream_chunk_rows the grid may exceed
    # device memory, so the draws buffer assembles chunk-wise — each
    # row chunk gets its own streamed likelihood_model + sample, keeping
    # device memory O(chunk) like the prediction above. Per-chunk folded
    # keys mean the draw VALUES differ from an in-memory run's single
    # key (CRPS is a stochastic estimate either way; the in-memory path
    # could not run at this scale at all).
    lm_kwargs = dict(
        stream_chunk_rows=stream_rows,
        stream_cache_bytes=inference_config.get('stream_cache_bytes'),
    )
    parts = []
    for ci, lo in enumerate(range(0, len(df_all), stream_rows)):
      sub = df_all.iloc[lo:lo + stream_rows]
      d = model.likelihood_model(sub, **lm_kwargs)
      parts.append(
          np.asarray(
              d.sample(jax.random.fold_in(sample_key, ci), sample_shape=(8,))
          ).reshape(-1, len(sub))
      )
    draws = np.concatenate(parts, axis=1)[:, valid]
  n_train_valid = int(df_train[target_col].notna().sum())
  is_train = np.arange(len(y_all)) < n_train_valid
  metrics_block = {}
  for region, mask in (('train', is_train), ('test', ~is_train)):
    if not np.any(mask):
      continue
    metrics_block[region] = {
        'rmse': float(metrics_lib.rmse(y_all[mask], yhat_all[mask])),
        'mae': float(metrics_lib.mae(y_all[mask], yhat_all[mask])),
        'crps': float(
            metrics_lib.crps_ensemble(y_all[mask], draws[:, mask], fair=True)
        ),
    }

  with open(f'{stem}.log.json', 'w') as f:
    json.dump(
        {
            'dataset': dataset,
            'series_id': series_id,
            'runtime': runtime,
            'objective': objective,
            'metrics': metrics_block,
            'dataset_config': dataset_config,
            'model_config': model_config,
            'inference_config': inference_config,
        },
        f,
        indent=2,
        default=repr,
    )

  loss_df = pd.DataFrame(np.reshape(losses, (-1, losses.shape[-1])).T)
  loss_df.to_csv(f'{stem}.loss.csv', index=False)

  # Predictions cover EVERY row of df_all (NaN-target rows are legitimate
  # grid points), so the artifact indexes all of them. Identical to the
  # reference's filtered index on its NaN-free experiment CSVs
  # (scripts/evaluate.py:137-150), but robust when targets are missing.
  pred_index = df_all.index
  means = means_host  # already materialized once for the metrics block
  pred_df = pd.DataFrame(
      {
          'yhat': means.mean(axis=tuple(range(means.ndim - 1))),
          'yhat_p50': np.asarray(quants[0]),
          'yhat_lower': np.asarray(quants[1]),
          'yhat_upper': np.asarray(quants[2]),
      },
      index=pred_index,
  )
  pred_df.sort_index(inplace=True)
  pred_df.to_csv(f'{stem}.pred.csv', index=True)

  return losses, means, quants


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--output_dir', required=True)
  parser.add_argument('--data_root', required=True)
  parser.add_argument(
      '--dataset', required=True, choices=registry.runnable_datasets()
  )
  parser.add_argument(
      '--objective', default='map', choices=['map', 'mle', 'vi']
  )
  parser.add_argument('--start_id', type=int, default=5)
  parser.add_argument('--stop_id', type=int, default=None)
  parser.add_argument(
      '--num_particles', type=int, default=None,
      help='Override the ensemble size.',
  )
  parser.add_argument(
      '--precision', default=None, choices=['f32', 'bf16', 'highest'],
      help='Matmul precision (all objectives).',
  )
  parser.add_argument(
      '--data_devices', type=int, default=None,
      help="Devices on the mesh's 'data' axis (rows sharded; the rest go "
      "to 'ens'). Default: all devices on 'ens'.",
  )
  parser.add_argument(
      '--num_epochs', type=int, default=None,
      help='Override the registry epoch budget (smoke runs, streamed runs).',
  )
  parser.add_argument(
      '--batch_size', type=int, default=None,
      help='Override the registry batch size (required for '
      '--stream_chunk_steps when the published config is full-batch).',
  )
  parser.add_argument(
      '--stream_chunk_steps', type=int, default=None,
      help='Host-streaming training: keep the dataset in host RAM and '
      'stream batches in slices of this many SGD steps (requires the '
      "config's batch_size < rows) — for datasets larger than device "
      'memory.',
  )
  parser.add_argument(
      '--stream_chunk_rows', type=int, default=None,
      help='Out-of-core prediction: stream the (train+test) grid from '
      'host RAM in chunks of this many rows (bit-identical outputs, '
      'device memory O(chunk) + the cache budget).',
  )
  parser.add_argument(
      '--stream_cache_bytes', type=int, default=None,
      help='With --stream_chunk_rows: device cache budget for the '
      'streamed predictor (default 1 GiB; 0 = strict O(chunk) device '
      'memory — grids within the budget stream at in-memory speed).',
  )
  parser.add_argument(
      '--stream_member_remix', action='store_true',
      help='With --stream_chunk_steps: per-member device-side slice '
      'repartitioning (per-member SGD-noise decorrelation at zero extra '
      'transfer; see PARITY.md §2b).',
  )
  args = parser.parse_args(argv)

  data_cfg = registry.dataset_config(args.dataset)
  stop_id = args.stop_id if args.stop_id is not None else data_cfg['num_series']
  for series_id in range(args.start_id, stop_id):
    inference = registry.inference_config(args.dataset, args.objective)
    # `is not None` (not truthiness) so an explicit 0 is passed through to
    # fit()'s own validation instead of silently falling back to the
    # registry's full budget.
    if args.num_particles is not None:
      inference['num_particles'] = args.num_particles
    if args.precision is not None:
      inference['precision'] = args.precision
    if args.data_devices is not None:
      inference['data_devices'] = args.data_devices
    if args.num_epochs is not None:
      inference['num_epochs'] = args.num_epochs
    if args.batch_size is not None:
      inference['batch_size'] = args.batch_size
    if args.stream_chunk_steps is not None:
      inference['stream_chunk_steps'] = args.stream_chunk_steps
    if args.stream_member_remix:
      # Applied regardless of where stream_chunk_steps came from (flag or
      # registry config); if streaming is not configured at all, fit()
      # raises its "streaming only" ValueError rather than silently
      # running the shared-permutation scheme.
      inference['stream_member_remix'] = True
    if args.stream_chunk_rows is not None:
      inference['stream_chunk_rows'] = args.stream_chunk_rows
    if args.stream_cache_bytes is not None:
      inference['stream_cache_bytes'] = args.stream_cache_bytes
    sid = data_cfg['series_id_fmt'](series_id)
    print(f'{args.dataset} series {sid} ({args.objective})')
    run_experiment(
        dataset=args.dataset,
        data_root=args.data_root,
        series_id=sid,
        output_dir=args.output_dir,
        objective=args.objective,
        inference_config=inference,
        seed=jax.random.PRNGKey(2023100400 + series_id),
    )


if __name__ == '__main__':
  main()
