"""CI gate: BayesNF-TPU beats the executed sklearn baselines.

Runs the head-to-head runner's synthetic leg (one seed, full budgets —
the same protocol as `cli.baseline_headtohead`'s artifact, same
code path) and asserts BayesNF-MAP wins. Everything is seeded (sklearn
`random_state=0`, fixed jax keys, CPU numerics), so these are pinned
deterministic comparisons, not statistical ones: a regression in either
the model or the quantile engine shows up as a flipped inequality.

The featurized GBOOST/TSREG variants ride BayesNF's OWN seasonal/Fourier
features (the paper's strongest versions of those baselines) — beating
them is the meaningful claim; the raw variants and RF are the floor.
"""

import numpy as np
import pytest

from bayesnf_tpu.cli import baseline_headtohead


@pytest.mark.slow
def test_bnf_map_beats_sklearn_baselines_on_synthetic():
  leg = baseline_headtohead.run_synthetic_leg(
      seeds=1, quick=False, include_vi=False
  )
  m = {name: vals['mean'] for name, vals in leg.items()}
  bnf = m.pop('bnf_map')

  # Probabilistic forecast quality: lower CRPS than EVERY baseline,
  # including the featurized GBOOST (seed-0 margin is ~2% there — thin
  # but deterministic; the field-recovery margin below is the 2x one).
  for name, vals in m.items():
    assert bnf['crps'] < vals['crps'], (name, bnf['crps'], vals['crps'])

  # Field recovery: the point prediction tracks the TRUE conditional
  # mean about 2x better than the best baseline.
  for name, vals in m.items():
    assert bnf['rmse_vs_true_mean'] < vals['rmse_vs_true_mean'], (
        name, bnf['rmse_vs_true_mean'], vals['rmse_vs_true_mean']
    )

  # Calibration: 95% intervals actually cover ~95%.
  assert 0.9 <= bnf['coverage_95'] <= 1.0, bnf['coverage_95']

  # And the margins are not degenerate artifacts of broken baselines:
  # every baseline must itself be a sane fit (beats predicting the mean).
  for name, vals in m.items():
    assert np.isfinite(vals['rmse']) and vals['rmse'] < 2.5, (name, vals)


@pytest.mark.slow
def test_bnf_map_beats_sklearn_on_counts_point_metrics():
  """The count-model gate: BNF's native NB likelihood vs count-as-
  continuous sklearn regression (the paper's count-valued home domain).

  Pins what the committed artifact shows for MAP (deterministic,
  seeded): BNF-MAP wins RMSE, MAE, and true-mean recovery on every
  baseline. MAP's CRPS is deliberately NOT gated — the featurized
  GBOOST's pinball-loss quantile heads edge it by ~9% at MAP's budget (a
  calibration-width trade, documented in PARITY.md §2c). The CRPS win on
  counts belongs to BNF-VI at its converged 2000-step budget (CRPS 2.26
  vs 2.33 best baseline, best field recovery outright) — carried by the
  committed artifact rather than gated here because a 2000-step VI fit
  is minutes of CPU per CI run.
  """
  leg = baseline_headtohead.run_synthetic_leg(
      seeds=1, quick=False, observation_model='NB', include_vi=False
  )
  m = {name: vals['mean'] for name, vals in leg.items()}
  bnf = m.pop('bnf_map')

  for name, vals in m.items():
    assert bnf['rmse'] < vals['rmse'], (name, bnf['rmse'], vals['rmse'])
    assert bnf['mae'] < vals['mae'], (name, bnf['mae'], vals['mae'])
    assert bnf['rmse_vs_true_mean'] < vals['rmse_vs_true_mean'], (
        name, bnf['rmse_vs_true_mean'], vals['rmse_vs_true_mean']
    )
  # Conservative-but-valid intervals on counts.
  assert 0.9 <= bnf['coverage_95'] <= 1.0, bnf['coverage_95']
