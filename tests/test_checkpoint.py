"""Checkpoint/resume tests: chunked training matches uninterrupted runs."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from bayesnf_tpu.inference import map as map_lib
from bayesnf_tpu.models import field as field_lib
from bayesnf_tpu.models import likelihoods


def _setup():
  config = field_lib.FieldConfig.create(
      width=8, depth=1, input_scales=[30.0, 1.0], fourier_degrees=[2, 2],
      interactions=[], seasonality_periods=[], num_seasonal_harmonics=[],
  )
  rng = np.random.default_rng(1)
  x = np.stack(
      [np.arange(60, dtype=np.float32), rng.normal(size=60).astype(np.float32)],
      -1,
  )
  y = (x[:, 1] + np.sin(x[:, 0] / 5)).astype(np.float32)
  aug = jnp.concatenate(
      [jnp.asarray(x), field_lib.seasonal_features_for(config, jnp.asarray(x))],
      -1,
  )
  return config, aug, y


def _run(config, aug, y, **kwargs):
  return map_lib.ensemble_map(
      aug, y, config, likelihoods.LikelihoodDist.NORMAL,
      ensemble_size=2, learning_rate=0.01, num_epochs=20,
      seed=jax.random.PRNGKey(0), batch_size=20, **kwargs,
  )


def test_chunked_checkpointed_run_matches_single_run(tmp_path):
  config, aug, y = _setup()
  p_ref, l_ref = _run(config, aug, y)
  p_ck, l_ck = _run(
      config, aug, y, checkpoint_dir=str(tmp_path / 'ck'), checkpoint_every=7
  )
  np.testing.assert_array_equal(np.asarray(l_ref), np.asarray(l_ck))
  for a, b in zip(p_ref, p_ck):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_resume_from_checkpoint_is_bit_exact(tmp_path):
  config, aug, y = _setup()
  p_ref, l_ref = _run(config, aug, y)

  # Simulate an interrupted run: train only 14 of 20 epochs, checkpointing
  # every 7. The final-state checkpoint at epoch 14 remains on disk.
  ckdir = str(tmp_path / 'ck')
  map_lib.ensemble_map(
      aug, y, config, likelihoods.LikelihoodDist.NORMAL,
      ensemble_size=2, learning_rate=0.01, num_epochs=14,
      seed=jax.random.PRNGKey(0), batch_size=20,
      checkpoint_dir=ckdir, checkpoint_every=7,
  )
  # Resume to 20 epochs from the on-disk state.
  p_res, l_res = _run(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  np.testing.assert_array_equal(np.asarray(l_ref), np.asarray(l_res))
  for a, b in zip(p_ref, p_res):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mismatched_config_checkpoint_raises(tmp_path):
  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  _run(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  # Same shapes, different learning rate: without the fingerprint this
  # would silently resume the wrong run.
  with pytest.raises(ValueError, match='different configuration'):
    map_lib.ensemble_map(
        aug, y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=2, learning_rate=0.02, num_epochs=20,
        seed=jax.random.PRNGKey(0), batch_size=20,
        checkpoint_dir=ckdir, checkpoint_every=7,
    )


def test_stale_fingerprint_without_checkpoints_is_reclaimed(tmp_path):
  """A run that died before its first save must not block retries.

  The fingerprint marker is written at checkpointer construction; if the
  process then crashed with zero saved steps there is nothing to resume,
  so a differently-configured retry claims the directory instead of
  refusing.
  """
  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  # Simulate the crashed first run: construct (writes fingerprint.json),
  # save nothing.
  ckpt_lib.TrainCheckpointer(ckdir, fingerprint='dead-run').close()
  # Retry with a different configuration: must run, not raise.
  p, l = _run(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  assert np.all(np.isfinite(np.asarray(l)))
  # Once real checkpoints exist, a mismatched config still refuses.
  with pytest.raises(ValueError, match='different configuration'):
    map_lib.ensemble_map(
        aug, y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=2, learning_rate=0.02, num_epochs=20,
        seed=jax.random.PRNGKey(0), batch_size=20,
        checkpoint_dir=ckdir, checkpoint_every=7,
    )


def test_legacy_fingerprint_recipe_still_resumes(tmp_path):
  """Markers written by the superseded digest recipe keep resuming.

  One interim release always included stream_remix=False /
  stream_remix_window=None in non-remix fingerprints; the keys are now
  conditional, so those directories carry a different digest of the SAME
  configuration. The trainer passes the old-recipe digest as a legacy
  fingerprint — rewrite the marker to it and the resume must proceed
  bit-exactly.
  """
  import json as json_lib
  import os

  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  config, aug, y = _setup()
  p_ref, l_ref = _run(config, aug, y)

  captured = {}
  real_ctor = ckpt_lib.TrainCheckpointer

  class Capturing(real_ctor):

    def __init__(self, directory, **kwargs):
      captured['legacy'] = kwargs.get('legacy_fingerprints', ())
      super().__init__(directory, **kwargs)

  ckdir = str(tmp_path / 'ck')
  orig = ckpt_lib.TrainCheckpointer
  ckpt_lib.TrainCheckpointer = Capturing
  try:
    map_lib.ensemble_map(
        aug, y, config, likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=2, learning_rate=0.01, num_epochs=14,
        seed=jax.random.PRNGKey(0), batch_size=20,
        checkpoint_dir=ckdir, checkpoint_every=7,
    )
  finally:
    ckpt_lib.TrainCheckpointer = orig
  assert len(captured['legacy']) == 1  # non-remix run: one legacy digest

  # Simulate the directory having been written by the old recipe.
  marker = os.path.join(ckdir, 'fingerprint.json')
  with open(marker, 'w') as f:
    json_lib.dump({'fingerprint': captured['legacy'][0]}, f)

  p_res, l_res = _run(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  np.testing.assert_array_equal(np.asarray(l_ref), np.asarray(l_res))
  for a, b in zip(p_ref, p_res):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

  # An unrelated digest still refuses.
  with open(marker, 'w') as f:
    json_lib.dump({'fingerprint': 'someone-else'}, f)
  with pytest.raises(ValueError, match='different configuration'):
    _run(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)


def test_reclaimed_directory_fails_the_original_runs_save(tmp_path):
  """If run B reclaims a zero-step directory, run A's first save refuses.

  Closes the race in the stale-marker reclaim: A (pre-first-save) and B
  cannot interleave checkpoints — whoever saves after losing the marker
  gets a loud error instead of silently mixing runs.
  """
  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  ckdir = str(tmp_path / 'ck')
  a = ckpt_lib.TrainCheckpointer(ckdir, fingerprint='run-a')
  b = ckpt_lib.TrainCheckpointer(ckdir, fingerprint='run-b')  # reclaims
  state = ckpt_lib.TrainState(
      params=(np.zeros((1, 2), np.float32),),
      opt_leaves=[np.zeros((1, 2), np.float32)],
      keys=np.zeros((1, 2), np.uint32),
      losses=[np.zeros((1, 1), np.float32)],
      epoch=1,
  )
  with pytest.raises(ValueError, match='claimed by a different run'):
    a.save(state)
  b.save(state)  # the claimant saves fine
  b.close()
  a.close()


def test_completed_run_reinvocation_is_noop(tmp_path):
  config, aug, y = _setup()
  ckdir = str(tmp_path / 'ck')
  p1, l1 = _run(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  # The run completed; its final state is checkpointed, so re-invoking with
  # the same directory restores (no retraining) and returns identical state.
  p2, l2 = _run(config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7)
  np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))
  for a, b in zip(p1, p2):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestVICheckpoint:

  def _run_vi(self, config, aug, y, **kwargs):
    from bayesnf_tpu.inference import vi as vi_lib

    return vi_lib.fit_vi(
        aug, y, jax.random.PRNGKey(0), 'NORMAL', config,
        ensemble_size=2, learning_rate=0.02, num_epochs=20,
        sample_size_divergence=2, sample_size_posterior=3,
        batch_size=20, **kwargs,
    )

  def test_vi_chunked_checkpoint_matches_single_run(self, tmp_path):
    config, aug, y = _setup()
    s_ref, l_ref, d_ref = self._run_vi(config, aug, y)
    s_ck, l_ck, d_ck = self._run_vi(
        config, aug, y, checkpoint_dir=str(tmp_path / 'vi'), checkpoint_every=7
    )
    np.testing.assert_array_equal(np.asarray(l_ref), np.asarray(l_ck))
    for a, b in zip(jax.tree_util.tree_leaves(s_ref),
                    jax.tree_util.tree_leaves(s_ck)):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(d_ref, d_ck):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

  def test_vi_resume_bit_exact(self, tmp_path):
    from bayesnf_tpu.inference import vi as vi_lib

    config, aug, y = _setup()
    _, l_ref, d_ref = self._run_vi(config, aug, y)
    ckdir = str(tmp_path / 'vi')
    vi_lib.fit_vi(
        aug, y, jax.random.PRNGKey(0), 'NORMAL', config,
        ensemble_size=2, learning_rate=0.02, num_epochs=14,
        sample_size_divergence=2, sample_size_posterior=3,
        batch_size=20, checkpoint_dir=ckdir, checkpoint_every=7,
    )
    _, l_res, d_res = self._run_vi(
        config, aug, y, checkpoint_dir=ckdir, checkpoint_every=7
    )
    np.testing.assert_array_equal(np.asarray(l_ref), np.asarray(l_res))
    for a, b in zip(d_ref, d_res):
      np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_remote_uri_directories_pass_through_unmangled():
  """abspath must not rewrite gs://bucket to <cwd>/gs:/bucket — that would
  silently redirect a pod's collective checkpoint to per-host local disk."""
  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  assert (
      ckpt_lib._normalize_directory('gs://bucket/ckpt') == 'gs://bucket/ckpt'
  )
  assert ckpt_lib._normalize_directory('s3://b/x') == 's3://b/x'
  assert ckpt_lib._normalize_directory('relative/dir').startswith('/')


def test_fingerprint_marker_survives_torn_reads(tmp_path):
  """The marker publishes atomically and a torn/empty file (external
  damage) reads as absent instead of crashing a collective save."""
  import os

  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  c = ckpt_lib.TrainCheckpointer(str(tmp_path), fingerprint='abc')
  assert c._read_marker() == 'abc'
  marker = os.path.join(str(tmp_path), 'fingerprint.json')
  with open(marker, 'w') as f:
    f.write('{"fingerpr')  # torn write from a dying external process
  assert c._read_marker() is None
  c._write_marker('abc')
  assert c._read_marker() == 'abc'
  # No temp debris left behind by the atomic publish.
  assert [p for p in tmp_path.iterdir() if 'tmp' in p.name] == []


def _captured_fingerprint(run):
  """The fingerprint a trainer hands its TrainCheckpointer."""
  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  captured = {}
  real_ctor = ckpt_lib.TrainCheckpointer

  class Capturing(real_ctor):

    def __init__(self, directory, **kwargs):
      captured['fingerprint'] = kwargs['fingerprint']
      super().__init__(directory, **kwargs)

  ckpt_lib.TrainCheckpointer = Capturing
  try:
    run()
  finally:
    ckpt_lib.TrainCheckpointer = real_ctor
  return captured['fingerprint']


def test_map_fingerprint_keeps_pinned_backend(tmp_path):
  """Checkpoints written while the trainer had a backend choice recorded
  the resolved 'xla' in their fingerprint; the one remaining trainer pins
  that value, so those directories keep resuming."""
  from bayesnf_tpu.parallel import mesh as mesh_lib
  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  config, aug, y = _setup()
  got = _captured_fingerprint(lambda: _run(
      config, aug, y, checkpoint_dir=str(tmp_path / 'ck'),
      mesh=mesh_lib.default_mesh(),
  ))
  want = ckpt_lib.run_fingerprint(
      kind='map', config=config, distribution='NORMAL', ensemble_size=2,
      learning_rate=0.01, batch_size=20, data_size=int(y.shape[0]),
      prior_weight=1.0, precision='f32', backend='xla', data_shards=1,
      stream=False,
  )
  assert got == want


def test_vi_fingerprint_keeps_pinned_backend(tmp_path):
  from bayesnf_tpu.inference import vi as vi_lib
  from bayesnf_tpu.utils import checkpoint as ckpt_lib

  config, aug, y = _setup()
  got = _captured_fingerprint(lambda: vi_lib.fit_vi(
      aug, y, jax.random.PRNGKey(0), 'NORMAL', config, ensemble_size=2,
      learning_rate=0.01, num_epochs=2, sample_size_divergence=2,
      sample_size_posterior=2, kl_weight=0.5, batch_size=20,
      checkpoint_dir=str(tmp_path / 'ck'),
  ))
  want = ckpt_lib.run_fingerprint(
      kind='vi', config=config, distribution='NORMAL', ensemble_size=2,
      learning_rate=0.01, batch_size=20, data_size=int(y.shape[0]),
      sample_size_divergence=2, kl_weight=0.5, precision='f32',
      backend='xla', data_shards=1, stream=False,
  )
  assert got == want
