"""bench.py's device contract: GPU only, peaks by device kind."""

import os
import sys

import pytest

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import bench  # noqa: E402


def test_refuses_cpu_without_small_flag(monkeypatch):
  monkeypatch.delenv('BENCH_SMALL', raising=False)
  with pytest.raises(SystemExit, match='no GPU found'):
    bench.main()


def test_unknown_device_kind_is_an_error():
  with pytest.raises(SystemExit, match='no peak table entry'):
    bench._peaks()


def test_mfu_is_against_the_peak_of_the_precision_run(monkeypatch):
  monkeypatch.setattr(bench, '_peaks', lambda: bench._PEAKS[
      'NVIDIA H100 80GB HBM3'])
  # 100 member-steps/s x 1e12 FLOPs = 100 TFLOP/s: ~20% of TF32's 495.
  out = bench._flops_metrics('map', 100.0, 1e12, 'tf32')
  assert out == {
      'map_achieved_tflops_per_chip': 100.0,
      'map_mfu_vs_peak_tf32': round(100.0 / 495.0, 3),
  }
  assert bench._GPU_MATMUL_PRECISION['f32'] == 'tf32'
