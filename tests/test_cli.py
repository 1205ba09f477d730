"""CLI harness tests: artifact schema parity with the reference
(`scripts/evaluate.py:119-150`: .log.json / .loss.csv / .pred.csv)."""

import json
import os

import numpy as np
import pandas as pd
import jax
import pytest

from bayesnf_tpu.cli import evaluate
from bayesnf_tpu.cli import registry

_DATA_ROOT = os.path.join(os.path.dirname(__file__), 'test_data')


def _mini_inference(objective):
  cfg = registry.inference_config('chickenpox', objective)
  cfg.update(num_particles=4, num_epochs=5)
  if objective == 'vi':
    cfg.update(num_particles=1, num_epochs=2, batch_size=50)
  return cfg


def _mini_model(objective):
  cfg = registry.model_config('chickenpox', objective)
  cfg.update(width=16)
  return cfg


@pytest.mark.parametrize('objective', ['map', 'mle', 'vi'])
def test_run_experiment_artifacts(tmp_path, objective):
  losses, means, quants = evaluate.run_experiment(
      dataset='chickenpox',
      data_root=_DATA_ROOT,
      series_id='8',
      output_dir=str(tmp_path),
      objective=objective,
      seed=jax.random.PRNGKey(0),
      model_config=_mini_model(objective),
      inference_config=_mini_inference(objective),
  )
  stem = str(tmp_path / f'bnf-{objective}.chickenpox.8')

  log = json.loads(open(f'{stem}.log.json').read())
  assert log['dataset'] == 'chickenpox'
  assert log['objective'] == objective
  assert log['runtime'] > 0
  # Accuracy block: RMSE/MAE/CRPS per region (CRPS is the paper's headline
  # metric; the reference CLI logged only runtime).
  for region in ('train', 'test'):
    for metric in ('rmse', 'mae', 'crps'):
      assert np.isfinite(log['metrics'][region][metric])
    assert log['metrics'][region]['crps'] <= log['metrics'][region]['rmse']

  loss_df = pd.read_csv(f'{stem}.loss.csv')
  n_particles = _mini_inference(objective)['num_particles']
  assert loss_df.shape[1] == n_particles
  assert np.all(np.isfinite(loss_df.values))

  pred_df = pd.read_csv(f'{stem}.pred.csv', index_col=0)
  assert list(pred_df.columns) == [
      'yhat', 'yhat_p50', 'yhat_lower', 'yhat_upper'
  ]
  # train rows (100) + test rows (208), sorted by original index.
  assert len(pred_df) == 308
  assert pred_df.index.is_monotonic_increasing
  # Quantile ordering holds everywhere.
  assert (pred_df.yhat_lower <= pred_df.yhat_p50).all()
  assert (pred_df.yhat_p50 <= pred_df.yhat_upper).all()


def test_run_experiment_streamed_out_of_core_metrics(tmp_path):
  """With stream_chunk_rows, predict AND the metrics draws stay O(chunk).

  The CRPS draws assemble chunk-wise through the streamed
  likelihood_model (per-chunk folded keys), so a grid larger than device
  memory never materializes whole on device anywhere in run_experiment.
  This runs the 308-row fixture with 128-row chunks and checks the
  artifact is complete and finite end to end.
  """
  inference = _mini_inference('map')
  inference.update(stream_chunk_rows=128, stream_cache_bytes=0)
  evaluate.run_experiment(
      dataset='chickenpox',
      data_root=_DATA_ROOT,
      series_id='8',
      output_dir=str(tmp_path),
      objective='map',
      seed=jax.random.PRNGKey(0),
      model_config=_mini_model('map'),
      inference_config=inference,
  )
  stem = str(tmp_path / 'bnf-map.chickenpox.8')
  log = json.loads(open(f'{stem}.log.json').read())
  for region in ('train', 'test'):
    for metric in ('rmse', 'mae', 'crps'):
      assert np.isfinite(log['metrics'][region][metric])
  pred_df = pd.read_csv(f'{stem}.pred.csv', index_col=0)
  assert len(pred_df) == 308
  assert np.all(np.isfinite(pred_df.values))


def test_run_experiment_data_devices(tmp_path):
  """`data_devices` in the inference config shards rows over the mesh.

  Chickenpox series 8 has 100 train rows — 100 % 8 != 0, so this also
  exercises the uneven-row padding through the CLI path.
  """
  cfg = _mini_inference('map')
  cfg.update(data_devices=8, batch_size=None)
  evaluate.run_experiment(
      dataset='chickenpox',
      data_root=_DATA_ROOT,
      series_id='8',
      output_dir=str(tmp_path),
      objective='map',
      seed=jax.random.PRNGKey(0),
      model_config=_mini_model('map'),
      inference_config=cfg,
  )
  loss_df = pd.read_csv(str(tmp_path / 'bnf-map.chickenpox.8.loss.csv'))
  assert np.all(np.isfinite(loss_df.values))


def test_run_experiment_nan_targets_overlapping_index(tmp_path):
  """Metrics/artifacts survive NaN-target rows and train/test index overlap.

  Predictions cover every df_all row while metrics drop NaN targets, so
  the alignment must be positional: this fixture injects NaN targets into
  both splits AND resets both CSVs to overlapping RangeIndexes (real
  exports routinely reuse index labels), which an index-set train/test
  split would mislabel.
  """
  train = pd.read_csv(
      os.path.join(_DATA_ROOT, 'chickenpox.8.train.csv'), index_col=0
  ).head(40)
  test = pd.read_csv(
      os.path.join(_DATA_ROOT, 'chickenpox.8.test.csv'), index_col=0
  ).head(30)
  train = train.reset_index(drop=True)
  test = test.reset_index(drop=True)  # indexes 0..29 now collide with train
  train.loc[[3, 17], 'chickenpox'] = np.nan
  test.loc[[0, 21], 'chickenpox'] = np.nan
  data_root = tmp_path / 'data'
  data_root.mkdir()
  train.to_csv(data_root / 'chickenpox.nan.train.csv')
  test.to_csv(data_root / 'chickenpox.nan.test.csv')

  evaluate.run_experiment(
      dataset='chickenpox',
      data_root=str(data_root),
      series_id='nan',
      output_dir=str(tmp_path),
      objective='map',
      seed=jax.random.PRNGKey(0),
      model_config=_mini_model('map'),
      inference_config=_mini_inference('map'),
  )
  stem = str(tmp_path / 'bnf-map.chickenpox.nan')
  log = json.loads(open(f'{stem}.log.json').read())
  for region, n_valid in (('train', 38), ('test', 28)):
    for metric in ('rmse', 'mae', 'crps'):
      assert np.isfinite(log['metrics'][region][metric])
  # Predictions still cover every row, including the NaN-target ones.
  pred_df = pd.read_csv(f'{stem}.pred.csv', index_col=0)
  assert len(pred_df) == 70
  assert np.all(np.isfinite(pred_df.values))


def test_registry_covers_reference_suite():
  assert sorted(registry.REGISTRY) == [
      'M3Month', 'air', 'air_quality', 'chickenpox', 'coprecip', 'sst', 'wind'
  ]
  for name in registry.REGISTRY:
    if name == 'M3Month':
      continue  # model-only stanza, exactly as upstream (see registry.py)
    for objective in ('map', 'mle', 'vi'):
      model = registry.model_config(name, objective)
      assert model['observation_model'] == 'NORMAL'
      inference = registry.inference_config(name, objective)
      assert inference['num_particles'] >= 8
  # M3Month: model configs for map/mle only, no dataset/inference entries
  # (the reference's tree cannot run it either).
  assert registry.model_config('M3Month', 'map')['width'] == 1024
  assert registry.model_config('M3Month', 'mle')['width'] == 1024
  with pytest.raises(KeyError):
    registry.model_config('M3Month', 'vi')
  with pytest.raises(KeyError):
    registry.dataset_config('M3Month')
  # Spot checks against the published experiment table.
  assert registry.inference_config('sst', 'map')['batch_size'] == 221127
  assert registry.model_config('sst', 'map')['width'] == 768
  assert registry.inference_config('chickenpox', 'map')['num_particles'] == 64
  assert registry.dataset_config('sst')['feature_cols'][-1] == 'soi'


@pytest.mark.slow
def test_selftest_cli_agrees_on_cpu(capsys, tmp_path):
  """The hardware self-test passes on the CI mesh: default-precision vs
  exact-f32 agreement through the real fit/predict entry points.

  conftest.py pins JAX_PLATFORMS=cpu for the whole suite; the guard below
  makes that assumption explicit (the check tolerances are meant to hold
  on the GPU too, where the default precision is TF32 — the agreement
  metric is scale-aware — but this test's contract is the CPU path)."""
  import jax

  from bayesnf_tpu.cli import selftest

  assert jax.default_backend() == 'cpu', (
      'conftest.py must pin the suite to the CPU platform'
  )
  json_out = tmp_path / 'selftest.json'
  rc = selftest.main([
      '--rows', '64', '--width', '16', '--epochs', '2', '--ensemble', '2',
      '--json-out', str(json_out),
  ])
  out = capsys.readouterr().out
  summary = json.loads(out.strip().splitlines()[-1])
  assert rc == 0, out
  assert summary['ok'] and summary['failed'] == []
  assert summary['num_checks'] == 25  # round-4 widened legs
  detail = json.loads(json_out.read_text())
  assert detail['ok'] and len(detail['checks']) == 25
  assert detail['args']['rows'] == 64


class TestPrepareData:
  """Layout verification + archive unpacking of the data-ingestion CLI
  (the download leg needs network and is exercised only by its error
  path contract)."""

  def test_expected_files_follow_registry(self):
    from bayesnf_tpu.cli import prepare_data

    names = prepare_data.expected_files('chickenpox')
    assert 'chickenpox.8.train.csv' in names
    assert 'chickenpox.8.test.csv' in names
    assert len(names) == 2 * registry.dataset_config('chickenpox')['num_series']

  def test_verify_reports_missing_then_ok(self, tmp_path):
    from bayesnf_tpu.cli import prepare_data

    missing = prepare_data.verify_layout(str(tmp_path), ['chickenpox'])
    assert set(missing) == {'chickenpox'}
    for name in prepare_data.expected_files('chickenpox'):
      (tmp_path / name).write_text('stub')
    assert prepare_data.verify_layout(str(tmp_path), ['chickenpox']) == {}
    rc = prepare_data.main(
        ['--verify-only', '--dest', str(tmp_path), '--datasets', 'chickenpox']
    )
    assert rc == 0

  def test_unpack_strips_single_root_dir(self, tmp_path):
    import zipfile

    from bayesnf_tpu.cli import prepare_data

    archive = tmp_path / 'datasets.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
      zf.writestr('datasets/chickenpox.8.train.csv', 'a,b\n1,2\n')
      zf.writestr('datasets/chickenpox.8.test.csv', 'a,b\n3,4\n')
    dest = tmp_path / 'out'
    prepare_data.unpack(str(archive), str(dest))
    assert (dest / 'chickenpox.8.train.csv').read_text().startswith('a,b')
    # main() with --archive unpacks and verifies without network.
    rc = prepare_data.main([
        '--archive', str(archive), '--dest', str(dest),
        '--datasets', 'chickenpox',
    ])
    assert rc == 1  # only series 8 present: verification lists the rest

  def test_unpack_recovers_deeply_nested_csvs(self, tmp_path):
    # The Zenodo archive layout is unverified until the first networked
    # run (no network here): tolerate expected CSVs nested at ANY depth —
    # recognized by basename and placed flat at the dest root, which is
    # where the evaluate CLI reads them (reference scripts/README:12-41).
    import zipfile

    from bayesnf_tpu.cli import prepare_data

    archive = tmp_path / 'datasets.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
      zf.writestr('data/v2/chickenpox/chickenpox.8.train.csv', 'a,b\n1,2\n')
      zf.writestr('data/extra/readme.txt', 'notes')
    dest = tmp_path / 'out'
    prepare_data.unpack(str(archive), str(dest))
    assert (dest / 'chickenpox.8.train.csv').read_text().startswith('a,b')
    # Non-dataset files keep their (root-stripped) relative placement.
    assert (dest / 'extra' / 'readme.txt').exists()

  def test_list_mode_reports_found_vs_expected(self, tmp_path, capsys):
    from bayesnf_tpu.cli import prepare_data

    (tmp_path / 'chickenpox.8.train.csv').write_text('stub')
    rc = prepare_data.main(
        ['--list', '--dest', str(tmp_path), '--datasets', 'chickenpox']
    )
    out = capsys.readouterr().out
    assert rc == 1
    assert 'chickenpox: 1/' in out
    assert 'missing:' in out

  def test_deep_verify_catches_empty_and_wrong_header(self, tmp_path):
    from bayesnf_tpu.cli import prepare_data

    cfg = registry.dataset_config('chickenpox')
    header = ','.join(cfg['feature_cols'] + [cfg['target_col']])
    for name in prepare_data.expected_files('chickenpox'):
      (tmp_path / name).write_text(header + '\n1,2,3,4\n')
    assert prepare_data.verify_layout(
        str(tmp_path), ['chickenpox'], deep=True
    ) == {}
    # An empty file and a wrong-header file are both flagged.
    (tmp_path / 'chickenpox.0.train.csv').write_text('')
    (tmp_path / 'chickenpox.1.train.csv').write_text('x,y\n1,2\n')
    problems = prepare_data.verify_layout(
        str(tmp_path), ['chickenpox'], deep=True
    )['chickenpox']
    assert any('empty' in p for p in problems)
    assert any('header lacks' in p for p in problems)

  def test_deep_verify_matches_column_names_exactly(self, tmp_path):
    # Raw substring matching would pass a header whose text merely
    # CONTAINS the column names ('chickenpox' inside a prose line,
    # 'latitude' inside 'colatitude'); the check must parse CSV fields.
    from bayesnf_tpu.cli import prepare_data

    for name in prepare_data.expected_files('chickenpox'):
      (tmp_path / name).write_text(
          'notes: datetime colatitude longitude chickenpox\n1,2\n'
      )
    problems = prepare_data.verify_layout(
        str(tmp_path), ['chickenpox'], deep=True
    )['chickenpox']
    assert len(problems) == len(prepare_data.expected_files('chickenpox'))
    assert all('header lacks' in p for p in problems)
    # Quoted/spaced fields still count as exact matches.
    cfg = registry.dataset_config('chickenpox')
    header = ','.join(
        f'"{c}"' for c in cfg['feature_cols'] + [cfg['target_col']]
    )
    for name in prepare_data.expected_files('chickenpox'):
      (tmp_path / name).write_text(header + '\n1,2,3,4\n')
    assert prepare_data.verify_layout(
        str(tmp_path), ['chickenpox'], deep=True
    ) == {}

  def test_unpack_rejects_conflicting_duplicate_basenames(self, tmp_path):
    # Two archive entries carrying the SAME expected basename with
    # DIFFERENT content must fail loudly — entry order deciding which
    # copy wins would let a long fit train on the wrong data.
    import zipfile

    from bayesnf_tpu.cli import prepare_data

    archive = tmp_path / 'datasets.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
      zf.writestr('data/chickenpox.8.train.csv', 'a,b\n1,2\n')
      zf.writestr('data/old/chickenpox.8.train.csv', 'a,b\n9,9\n')
    with pytest.raises(SystemExit, match='two different copies'):
      prepare_data.unpack(str(archive), str(tmp_path / 'out'))
    # Identical duplicates are harmless: keep the first, no error.
    archive2 = tmp_path / 'datasets2.zip'
    with zipfile.ZipFile(archive2, 'w') as zf:
      zf.writestr('data/chickenpox.8.train.csv', 'a,b\n1,2\n')
      zf.writestr('data/copy/chickenpox.8.train.csv', 'a,b\n1,2\n')
    dest = tmp_path / 'out2'
    prepare_data.unpack(str(archive2), str(dest))
    assert (dest / 'chickenpox.8.train.csv').read_text() == 'a,b\n1,2\n'

  def test_file_md5_matches_hashlib(self, tmp_path):
    import hashlib

    from bayesnf_tpu.cli import prepare_data

    p = tmp_path / 'blob.bin'
    p.write_bytes(b'bayesnf' * 1000)
    assert prepare_data.file_md5(str(p)) == hashlib.md5(
        b'bayesnf' * 1000
    ).hexdigest()

  def test_unpack_rejects_zip_slip_entries(self, tmp_path):
    import zipfile

    from bayesnf_tpu.cli import prepare_data

    archive = tmp_path / 'evil.zip'
    with zipfile.ZipFile(archive, 'w') as zf:
      zf.writestr('ok.csv', 'a,b\n1,2\n')
      zf.writestr('../escape-lead.txt', 'x')
      zf.writestr('sub/../../escape-mid.txt', 'x')  # '..' mid-path
      zf.writestr('/abs.txt', 'x')
    dest = tmp_path / 'out'
    prepare_data.unpack(str(archive), str(dest))
    assert (dest / 'ok.csv').exists()
    assert not (tmp_path / 'escape-lead.txt').exists()
    assert not (tmp_path / 'escape-mid.txt').exists()
    written = {p.name for p in dest.rglob('*') if p.is_file()}
    assert written == {'ok.csv'}


def test_main_plumbs_streaming_flags(monkeypatch):
  # The CLI must forward the streaming knobs into the inference config
  # (fit: stream_chunk_steps/remix + batch/epoch overrides; predict:
  # stream_chunk_rows) without touching anything else.
  from bayesnf_tpu.cli import evaluate

  captured = {}

  def fake_run_experiment(**kwargs):
    captured.update(kwargs)

  monkeypatch.setattr(evaluate, 'run_experiment', fake_run_experiment)
  evaluate.main([
      '--dataset', 'chickenpox', '--objective', 'map',
      '--data_root', 'unused', '--output_dir', 'unused',
      '--start_id', '8', '--stop_id', '9',
      '--stream_chunk_steps', '4', '--stream_member_remix',
      '--stream_chunk_rows', '1024', '--stream_cache_bytes', '0',
      '--batch_size', '25', '--num_epochs', '30',
  ])
  inf = captured['inference_config']
  assert inf['stream_chunk_steps'] == 4
  assert inf['stream_member_remix'] is True
  assert inf['stream_chunk_rows'] == 1024
  assert inf['stream_cache_bytes'] == 0  # explicit 0 must survive
  assert inf['batch_size'] == 25
  assert inf['num_epochs'] == 30


def test_main_remix_flag_is_independent_of_chunk_steps_flag(monkeypatch):
  # --stream_member_remix must reach fit() even when stream_chunk_steps
  # comes from the registry config instead of the command line (fit's own
  # "streaming only" validation then decides; the flag must never be
  # silently dropped).
  from bayesnf_tpu.cli import evaluate

  captured = {}
  monkeypatch.setattr(
      evaluate, 'run_experiment', lambda **kw: captured.update(kw)
  )
  evaluate.main([
      '--dataset', 'chickenpox', '--objective', 'map',
      '--data_root', 'unused', '--output_dir', 'unused',
      '--start_id', '8', '--stop_id', '9',
      '--stream_member_remix',
  ])
  assert captured['inference_config']['stream_member_remix'] is True
  assert 'stream_chunk_steps' not in captured['inference_config']


def test_streamed_predict_empty_table_raises():
  from bayesnf_tpu.inference import predict_stream

  with pytest.raises(ValueError, match='empty'):
    predict_stream._resolve_rows(32, 16, 0)
