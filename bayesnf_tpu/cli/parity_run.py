"""Regenerate the full-config chickenpox-8 parity evidence (PARITY.md §3).

Runs the reference's published MAP configuration (width 256, depth 2,
seasonalities [4, 52.1775] x harmonics [2, 10], 64 particles x 10,000
epochs, lr 0.005, seed PRNGKey(2023100400 + 8) — reference
`scripts/evaluate.py:194-307` + `scripts/dataset_config.py:77-183`) on the
bundled chickenpox series 8, computes train-region metrics (RMSE, 95%
coverage, mean interval width, CRPS) for this run AND the same metrics
derived from the reference's committed full-run golden predictions
(`tests/test_data/bnf-map.chickenpox.8.train-golden.pred.csv` — the
train-region extract of the reference repo's
`tests/test_data/bnf-map.chickenpox.8.pred.csv`; its CRPS is
moment-matched Normal from the golden's mean and 95% interval), and
writes a machine-readable artifact for the repo history:

    python -m bayesnf_tpu.cli.parity_run --json-out parity.json

The caveats of this comparison
(protocol-matched, not data-matched — the golden was fit on the complete
dataset) are documented in PARITY.md §3 and carried into the artifact.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import pandas as pd

import jax

from bayesnf_tpu import metrics as metrics_lib
from bayesnf_tpu.cli import evaluate

_DATA_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    'tests', 'test_data',
)
_Z95 = 1.959964


def _region_metrics(y, yhat, lower, upper, crps):
  return {
      'rmse': float(metrics_lib.rmse(y, yhat)),
      'coverage_95': float(metrics_lib.coverage(y, lower, upper)),
      'mean_interval_width': float(metrics_lib.interval_width(lower, upper)),
      'crps': float(crps),
  }


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--json-out', required=True,
                      help='path of the parity artifact to write')
  parser.add_argument('--data_root', default=_DATA_ROOT)
  parser.add_argument('--output_dir', default=None,
                      help='where the CLI run artifacts go (default: tmp)')
  parser.add_argument('--num_particles', type=int, default=None,
                      help='override the published 64 (for quick checks)')
  parser.add_argument('--num_epochs', type=int, default=None,
                      help='override the published 10000 (for quick checks)')
  args = parser.parse_args(argv)

  out_dir = args.output_dir or tempfile.mkdtemp(prefix='bnf_parity_')
  from bayesnf_tpu.cli import registry

  inference = registry.inference_config('chickenpox', 'map')
  if args.num_particles:
    inference['num_particles'] = args.num_particles
  if args.num_epochs:
    inference['num_epochs'] = args.num_epochs

  start = time.perf_counter()
  evaluate.run_experiment(
      dataset='chickenpox',
      data_root=args.data_root,
      series_id='8',
      output_dir=out_dir,
      objective='map',
      seed=jax.random.PRNGKey(2023100400 + 8),
      inference_config=inference,
  )
  wall_s = time.perf_counter() - start

  train = pd.read_csv(
      os.path.join(args.data_root, 'chickenpox.8.train.csv'), index_col=0
  )
  y = train['chickenpox'].values.astype(np.float64)
  run_log = json.load(open(os.path.join(out_dir, 'bnf-map.chickenpox.8.log.json')))
  pred = pd.read_csv(
      os.path.join(out_dir, 'bnf-map.chickenpox.8.pred.csv'), index_col=0
  ).loc[train.index].sort_index()
  y_sorted = train.sort_index()['chickenpox'].values.astype(np.float64)
  ours = _region_metrics(
      y_sorted, pred['yhat'].values, pred['yhat_lower'].values,
      pred['yhat_upper'].values,
      # CRPS from the run's own log.json (fair ensemble estimator over
      # posterior-predictive draws via likelihood_model).
      run_log['metrics']['train']['crps'],
  )

  golden_path = os.path.join(
      args.data_root, 'bnf-map.chickenpox.8.train-golden.pred.csv'
  )
  golden = pd.read_csv(golden_path, index_col=0).sort_index()
  g_scale = (golden['yhat_upper'].values - golden['yhat_lower'].values) / (
      2 * _Z95
  )
  golden_metrics = _region_metrics(
      y_sorted, golden['yhat'].values, golden['yhat_lower'].values,
      golden['yhat_upper'].values,
      metrics_lib.crps_normal(y_sorted, golden['yhat'].values, g_scale),
  )

  artifact = {
      'experiment': 'chickenpox.8 full published MAP config (PARITY.md §3)',
      'device_kind': jax.devices()[0].device_kind,
      'backend': jax.default_backend(),
      'num_devices': jax.device_count(),
      'config': {
          'num_particles': inference['num_particles'],
          'num_epochs': inference['num_epochs'],
          'learning_rate': inference['learning_rate'],
      },
      'fit_predict_wall_s': round(run_log['runtime'], 1),
      'total_wall_s': round(wall_s, 1),
      'train_region': {
          'ours': ours,
          'reference_golden': golden_metrics,
          'golden_crps_note': (
              'golden CRPS is moment-matched Normal from the committed '
              'mean/95% interval; ours is the fair ensemble estimator '
              'over 8 x num_particles posterior-predictive draws'
          ),
      },
      'caveat': (
          'protocol-matched, not data-matched: the reference golden was '
          'fit on the complete (unbundled) dataset — see PARITY.md §3'
      ),
  }
  with open(args.json_out, 'w') as f:
    json.dump(artifact, f, indent=2)
    f.write('\n')
  print(json.dumps(artifact['train_region'], indent=2))
  print(f'wrote {args.json_out}')
  return 0


if __name__ == '__main__':
  sys.exit(main())
