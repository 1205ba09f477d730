"""chip_smoke.py: its refusal off the GPU, its output contract, and its
comparison helpers. The phases themselves run here at tiny sizes on the
CPU devices (a rehearsal; the script proper refuses to run off the GPU)."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.stats

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402

TINY = dict(
    air_rows=240, air_sites=12, map_epochs=2, stream_epochs=1,
    stream_chunk_steps=4, stream_chunk_rows=128, mesh_members=8,
    mesh_epochs=2,
)


def test_refuses_cpu_device_before_any_work(capsys):
  assert chip_smoke.main([]) == 2
  out = capsys.readouterr()
  assert out.out == ''
  assert 'no GPU found' in out.err


def test_fails_without_the_rest_of_the_repo(tmp_path):
  """Alone in a directory the script exits non-zero and prints no result."""
  shutil.copy(os.path.join(REPO_ROOT, 'chip_smoke.py'), tmp_path)
  env = dict(os.environ, JAX_PLATFORMS='cpu')
  proc = subprocess.run(
      [sys.executable, 'chip_smoke.py'], cwd=tmp_path, env=env,
      capture_output=True, text=True, timeout=300,
  )
  assert proc.returncode != 0
  assert '"ok"' not in proc.stdout


@pytest.mark.parametrize('count', [1, 4])
def test_result_line_format(count):
  dev = types.SimpleNamespace(platform='gpu',
                              device_kind='NVIDIA H100 80GB HBM3')
  line = chip_smoke.result_line([dev] * count)
  assert json.loads(line) == {
      'ok': True,
      'device': {'platform': 'gpu', 'kind': 'NVIDIA H100 80GB HBM3',
                 'count': count},
  }
  assert '\n' not in line


def test_four_cards_runs_only_the_mesh_phase():
  assert chip_smoke.selected_phases(True) == ('mesh',)
  assert 'mesh' not in chip_smoke.selected_phases(False)
  assert set(chip_smoke.selected_phases(False)) == {
      'map', 'vi', 'counts', 'stream'
  }


def test_compile_cache_follows_env(monkeypatch, tmp_path):
  from bayesnf_tpu.utils import profiling

  monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
  assert profiling.compile_cache_dir(chip_smoke.DEFAULT_CACHE_DIR) == str(
      tmp_path)


def test_compile_cache_defaults_to_ignored_checkout_dir(monkeypatch):
  from bayesnf_tpu.utils import profiling

  monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
  path = profiling.compile_cache_dir(chip_smoke.DEFAULT_CACHE_DIR)
  assert path == os.path.join(REPO_ROOT, '.jax_cache')
  with open(os.path.join(REPO_ROOT, '.gitignore')) as f:
    assert '.jax_cache/' in f.read().split()


def test_error_measures():
  assert chip_smoke.max_rel_err([1.01, 2.0], [1.0, 2.0]) == pytest.approx(
      0.01)
  assert chip_smoke.norm_rel_err([3.0, 4.0], [3.0, 4.0]) == 0.0
  assert chip_smoke.norm_rel_err([3.0, 4.1], [3.0, 4.0]) == pytest.approx(
      0.02)
  # Near zero, atol = rtol * data scale keeps the bound meaningful.
  assert chip_smoke.scaled_err([1e-3], [0.0], 1e-2, 1.0) < 1.0
  assert chip_smoke.scaled_err([2.0], [1.0], 1e-2, 1.0) > 1.0


def test_checks_record_failures(capsys):
  checks = chip_smoke.Checks()
  assert checks.at_most('a', 0.5, 1.0)
  assert not checks.at_most('b', float('nan'), 1.0)
  assert not checks.at_least('c', 0.5, 0.99)
  assert checks.failed == ['b', 'c']
  out = capsys.readouterr().out
  assert 'PASS a' in out and 'FAIL b' in out and 'FAIL c' in out


def test_mixture_cdfs_match_scipy():
  x = np.array([-1.0, 0.5, 3.0])
  means = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
  scales = np.array([1.0, 2.0])
  want = 0.5 * (scipy.stats.norm.cdf(x, 0, 1) + scipy.stats.norm.cdf(x, 1, 2))
  np.testing.assert_allclose(
      chip_smoke.normal_mixture_cdf(x, means, scales), want
  )
  k = np.array([0.0, 3.0, -1.0])
  logits = np.full((1, 3), -0.4)
  p = 1.0 / (1.0 + np.exp(-0.4))
  want = np.where(k < 0, 0.0, scipy.stats.nbinom.cdf(k, 2.5, p))
  np.testing.assert_allclose(
      chip_smoke.count_mixture_cdf(k, [2.5], logits), want
  )
  pi = np.full((1, 3), 0.3)
  np.testing.assert_allclose(
      chip_smoke.count_mixture_cdf(k, [2.5], logits, pi),
      np.where(k < 0, 0.0, 0.3 + 0.7 * want),
  )


def test_count_quantile_share_flags_off_by_one():
  dist = scipy.stats.poisson(4.0)
  level = 0.9
  exact = np.full(10, dist.ppf(level))
  assert chip_smoke.count_quantile_share(exact, level, dist.cdf) == 1.0
  assert chip_smoke.count_quantile_share(exact + 1, level, dist.cdf) == 0.0
  assert chip_smoke.count_quantile_share(exact - 1, level, dist.cdf) == 0.0


def test_single_card_phases_rehearse_on_cpu():
  import jax

  checks = chip_smoke.Checks()
  df, _ = chip_smoke.phase_map(checks, TINY, 0, jax.devices()[0])
  chip_smoke.phase_stream(checks, TINY, 0, jax.devices()[0], df)
  assert checks.failed == []


def test_mesh_phase_rehearses_on_cpu_devices():
  import jax

  checks = chip_smoke.Checks()
  chip_smoke.phase_mesh(checks, TINY, 0, jax.devices()[:4])
  assert checks.failed == []
