"""Cold-fit compile-count regression guard.

A cold `fit` used to trigger ~120 primitive-sized eager-setup compiles
(un-jitted vmapped init, eager seasonal encode, opt-state templates,
per-leaf reshards), each a compile and a dispatch of its own. The setup
path now runs as a handful of
jitted programs (trainer `init_all`, `minibatch.make_layout_fn`,
`field.aug_features_device`), with outputs born in the train program's
sharding. This test pins the program count so an innocent-looking eager
`jnp.*` call in the fit path can't silently re-open the regression.

Runs the fit in a SUBPROCESS with the persistent compilation cache
disabled, counting `jax_log_compiles` records — in-process counting
would see this suite's warm cache and already-imported jit wrappers.
"""

import os
import subprocess
import sys

import pytest

_FIT_SCRIPT = r"""
import io, logging
import numpy as np
import jax
jax.config.update('jax_log_compiles', True)
stream = io.StringIO()
logging.getLogger('jax._src.dispatch').addHandler(logging.StreamHandler(stream))
logging.getLogger('jax._src.dispatch').setLevel(logging.WARNING)

import pandas as pd
from bayesnf_tpu import BayesianNeuralFieldMAP

rng = np.random.default_rng(0)
n = 200
df = pd.DataFrame({
    'lat': rng.uniform(0, 1, n),
    'time': np.arange(n, dtype=float),
    'y': rng.normal(size=n),
})
model = BayesianNeuralFieldMAP(
    width=32, depth=2, seasonality_periods=[12.0],
    feature_cols=['lat', 'time'], target_col='y',
    observation_model='NORMAL', timetype='float',
)
def drain():
  names = []
  for line in stream.getvalue().splitlines():
    if 'Finished XLA compilation of' in line:
      names.append(line.split('Finished XLA compilation of ')[1].split(' in ')[0])
  stream.truncate(0)
  stream.seek(0)
  return names

model.fit(df, seed=jax.random.PRNGKey(0), ensemble_size=8,
          num_epochs=2, batch_size=50)
print('FIT::' + '|'.join(drain()))
model.predict(df, quantiles=(0.5, 0.025, 0.975))
print('PREDICT::' + '|'.join(drain()))
model.likelihood_model(df)
print('LM::' + '|'.join(drain()))
"""


@pytest.mark.slow
def test_cold_fit_compile_count_stays_small(tmp_path):
  env = dict(os.environ)
  env['JAX_PLATFORMS'] = 'cpu'
  env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
  # A warm persistent cache would hide re-introduced programs' compile
  # cost but NOT their count (log_compiles logs cache hits as compiles
  # only in some versions) — disable it so the count is deterministic.
  env['JAX_COMPILATION_CACHE_DIR'] = str(tmp_path / 'never_warm')
  out = subprocess.run(
      [sys.executable, '-c', _FIT_SCRIPT],
      env=env,
      capture_output=True,
      text=True,
      timeout=900,
      cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
  )
  assert out.returncode == 0, out.stderr[-4000:]

  def names_for(tag):
    marker = [l for l in out.stdout.splitlines() if l.startswith(tag + '::')]
    assert marker, (tag, out.stdout[-2000:])
    return [n for n in marker[0][len(tag) + 2:].split('|') if n]

  # Round-4 measured floors: fit = 7 programs (convert_element_type x2
  # for the two scalar seeds, _threefry_seed, init_all, layout, the
  # estimator encode, member_train); cold predict = 1 (the whole predict
  # is one program); cold likelihood_model = 2 (_forecast_params_chunked
  # + the newaxis broadcast). Headroom tolerates JAX-version drift in
  # singleton utilities; the eager-setup regression this guards against
  # shows up as tens of extra programs, far past each bound.
  #
  # LOWER bounds too: the drain parses a private jax
  # logger's 'Finished XLA compilation of' lines — if jax renames either,
  # drain() returns [] and every upper bound passes vacuously, silently
  # disabling this guard. A cold fit/predict MUST compile at least one
  # program each, so an empty list means the probe broke, not that the
  # code stopped compiling.
  fit = names_for('FIT')
  assert 1 <= len(fit) <= 12, (len(fit), fit)
  predict = names_for('PREDICT')
  assert 1 <= len(predict) <= 4, (len(predict), predict)
  lm = names_for('LM')
  assert 1 <= len(lm) <= 6, (len(lm), lm)
