"""Headline benchmark: MAP-ensemble training throughput on one GPU.

Config mirrors the reference's London air-quality tutorial workload
(BASELINE.md): N=38096 hourly rows, 3 features, width 512, depth 2,
NORMAL likelihood, daily+weekly seasonal harmonics, full-batch Adam —
but with a 64-member ensemble trained *simultaneously on one card*.

Metric: member-steps/sec/chip (one member-step = one full-batch Adam update
of one ensemble member).

Needs a GPU: with none attached it exits non-zero, unless BENCH_SMALL=1
asks for the small CPU smoke run, whose record says "platform": "cpu" and
carries no device metrics.

Prints ONE JSON line: {"metric", "value", "unit", "platform", ...}.
"""

import json
import os
import sys
import traceback

import jax
import jax.numpy as jnp
import numpy as np

from bayesnf_tpu.utils import profiling

# Dense peaks of one card, keyed by `jax.Device.device_kind`: TFLOP/s per
# matmul operand precision and HBM bandwidth in TB/s. Source: NVIDIA's H100
# SXM data sheet (dense rates, no sparsity), at the full 700 W power limit.
_PEAKS = {
    'NVIDIA H100 80GB HBM3': {
        'bf16': 989.0, 'tf32': 495.0, 'fp32': 67.0, 'hbm_tb_s': 3.35,
    },
}
# Which peak a `precision` setting runs at on the GPU: JAX's default
# matmul precision lets XLA run f32 dots as TF32 on the tensor cores;
# 'highest' runs exact f32.
_GPU_MATMUL_PRECISION = {'f32': 'tf32', 'bf16': 'bf16', 'highest': 'fp32'}


def _peaks():
  kind = jax.devices()[0].device_kind
  if kind not in _PEAKS:
    raise SystemExit(
        f'bench.py: no peak table entry for device_kind {kind!r}; add its '
        'data-sheet peaks to _PEAKS.'
    )
  return _PEAKS[kind]


def _matmul_flops_per_row(config):
  """Forward matmul FLOPs per row per member: sum of 2*fan_in*fan_out.

  Counts only the dense layers (the quantity MFU is defined over); encode
  trig, activation blend, and likelihood terms are elementwise work
  excluded by convention. Model FLOPs, not hardware FLOPs.
  """
  from bayesnf_tpu.models import field as field_lib

  return sum(
      2 * int(np.prod(spec.shape))
      for spec in field_lib.param_specs(config)
      if spec.is_matrix
  )


def _flops_metrics(prefix, member_steps_per_sec, flops_per_member_step,
                   matmul_precision):
  """Achieved TFLOP/s and MFU against the peak of the precision run."""
  tflops = member_steps_per_sec * flops_per_member_step / 1e12
  return {
      f'{prefix}_achieved_tflops_per_chip': round(tflops, 2),
      f'{prefix}_mfu_vs_peak_{matmul_precision}': round(
          tflops / _peaks()[matmul_precision], 3
      ),
  }


def main():
  from bayesnf_tpu.inference import map as map_lib
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import mesh as mesh_lib

  small = bool(int(os.environ.get('BENCH_SMALL', '0')))
  platform = jax.devices()[0].platform
  if platform != 'gpu' and not small:
    raise SystemExit(
        f'bench.py: no GPU found (JAX platform {platform!r}); set '
        'BENCH_SMALL=1 for the small CPU smoke run.'
    )
  on_gpu = platform == 'gpu'
  profiling.enable_compile_cache(
      os.path.join(os.path.dirname(os.path.abspath(__file__)), '.jax_cache')
  )
  precision = os.environ.get('BENCH_PRECISION') or 'f32'
  # What the matmuls actually run at: on the GPU, 'f32' is JAX's default
  # precision, i.e. TF32 tensor-core dots; on the CPU it is exact f32.
  matmul_precision = (
      _GPU_MATMUL_PRECISION[precision] if on_gpu
      else {'bf16': 'bf16'}.get(precision, 'fp32')
  )
  n_rows = 2048 if small else 38096
  width = 128 if small else 512
  ensemble = 8 if small else 64
  timed_epochs = 20 if small else 200

  config = field_lib.FieldConfig.create(
      width=width,
      depth=2,
      input_scales=[float(n_rows - 1), 1.0, 1.0],
      fourier_degrees=[5, 5, 5],
      interactions=[],
      seasonality_periods=[24.0, 24.0 * 7],
      num_seasonal_harmonics=[4, 4],
  )

  rng = np.random.default_rng(0)
  t = np.arange(n_rows, dtype=np.float32)
  space = rng.normal(size=(n_rows, 2)).astype(np.float32)
  x = np.concatenate([t[:, None], space], axis=-1)
  y = (
      10 * np.sin(2 * np.pi * t / 24.0)
      + 3 * np.sin(2 * np.pi * t / (24.0 * 7))
      + space[:, 0]
      + rng.normal(size=n_rows).astype(np.float32)
  ).astype(np.float32)

  x = jnp.asarray(x)
  aug = field_lib.aug_features_device(config, x)
  y = jnp.asarray(y)
  mesh = mesh_lib.default_mesh()
  n_chips = len(jax.devices())

  def run(num_epochs, seed):
    params, losses = map_lib.ensemble_map(
        aug,
        y,
        config,
        likelihoods.LikelihoodDist.NORMAL,
        ensemble_size=ensemble,
        learning_rate=0.005,
        num_epochs=num_epochs,
        seed=jax.random.PRNGKey(seed),
        batch_size=None,
        prior_weight=1.0,
        mesh=mesh,
        precision=precision,
    )
    return params, np.asarray(losses)

  # Warmup/compile at the same static shape (epoch count is static: compile
  # once for the timed length).
  run(timed_epochs, seed=0)
  # Best-of-3 with per-run values: a single run cannot distinguish a real
  # few-percent regression from dispatch noise; the JSON carries the
  # spread so comparisons can.
  map_runs = []
  map_params = losses = None
  for rep in range(3):
    with profiling.StepTimer(
        member_steps=timed_epochs * ensemble, num_chips=n_chips
    ) as timer:
      map_params, losses = run(timed_epochs, seed=1 + rep)
    assert np.all(np.isfinite(losses)), 'non-finite bench loss'
    map_runs.append(timer.report.member_steps_per_sec_per_chip)
  value = max(map_runs)

  # Secondary metric: VI throughput on the same workload (ELBO steps with
  # VI_MC_DRAWS MC draws per step; one member-step = one surrogate Adam
  # update of one member). Reported inside the same JSON line; failures
  # are non-fatal. The draw count also scales the VI FLOPs accounting
  # below — one constant so the two cannot drift.
  VI_MC_DRAWS = 5
  vi_value = None
  try:
    from bayesnf_tpu.inference import vi as vi_lib

    vi_steps = 5 if small else 20
    def run_vi(num_steps, seed):
      _, vi_losses, _ = vi_lib.fit_vi(
          aug,
          y,
          jax.random.PRNGKey(seed),
          'NORMAL',
          config,
          ensemble_size=ensemble,
          learning_rate=0.005,
          num_epochs=num_steps,
          sample_size_divergence=VI_MC_DRAWS,
          sample_size_posterior=2,
          batch_size=None,
          mesh=mesh,
          precision=precision,
      )
      return np.asarray(vi_losses)

    run_vi(vi_steps, seed=0)
    with profiling.StepTimer(
        member_steps=vi_steps * ensemble, num_chips=n_chips
    ) as vi_timer:
      vi_losses = run_vi(vi_steps, seed=1)
    assert np.all(np.isfinite(vi_losses)), 'non-finite VI bench loss'
    vi_value = vi_timer.report.member_steps_per_sec_per_chip
  except Exception:  # pylint: disable=broad-except
    print('WARNING: VI bench failed:', file=sys.stderr)
    traceback.print_exc(limit=3, file=sys.stderr)

  # Tertiary metric: NB (count-likelihood) training throughput. Failures
  # are non-fatal.
  nb_value = None
  try:
    y_nb = jnp.asarray(
        rng.poisson(np.exp(np.asarray(y) / 8.0) + 1.0).astype(np.float32)
    )
    nb_epochs = 10 if small else 100
    def run_nb(num_epochs, seed):
      _, nb_losses = map_lib.ensemble_map(
          aug,
          y_nb,
          config,
          likelihoods.LikelihoodDist.NB,
          ensemble_size=ensemble,
          learning_rate=0.005,
          num_epochs=num_epochs,
          seed=jax.random.PRNGKey(seed),
          batch_size=None,
          prior_weight=1.0,
          mesh=mesh,
          precision=precision,
      )
      return np.asarray(nb_losses)

    run_nb(nb_epochs, seed=0)
    with profiling.StepTimer(
        member_steps=nb_epochs * ensemble, num_chips=n_chips
    ) as nb_timer:
      nb_losses = run_nb(nb_epochs, seed=1)
    assert np.all(np.isfinite(nb_losses)), 'non-finite NB bench loss'
    nb_value = nb_timer.report.member_steps_per_sec_per_chip
  except Exception:  # pylint: disable=broad-except
    print('WARNING: NB bench failed:', file=sys.stderr)
    traceback.print_exc(limit=3, file=sys.stderr)

  # Quaternary metric: host-streaming minibatch throughput — the
  # larger-than-device-memory input regime (dataset host-resident, batch
  # slices streamed to the device double-buffered). One member-step = one
  # minibatch Adam update of one member. Compares against the resident
  # rate above to expose transfer-bound regressions. Non-fatal.
  stream_value = None
  try:
    stream_epochs = 2 if small else 4
    stream_batch = n_rows // 8
    stream_steps_per_epoch = n_rows // stream_batch

    def run_stream(num_epochs, seed):
      _, st_losses = map_lib.ensemble_map(
          np.asarray(aug),
          np.asarray(y),
          config,
          likelihoods.LikelihoodDist.NORMAL,
          ensemble_size=ensemble,
          learning_rate=0.005,
          num_epochs=num_epochs,
          seed=jax.random.PRNGKey(seed),
          batch_size=stream_batch,
          prior_weight=1.0,
          mesh=mesh,
          precision=precision,
          stream_chunk_steps=4,
      )
      return np.asarray(st_losses)

    run_stream(stream_epochs, seed=0)
    stream_member_steps = stream_epochs * stream_steps_per_epoch * ensemble
    with profiling.StepTimer(
        member_steps=stream_member_steps, num_chips=n_chips
    ) as st_timer:
      st_losses = run_stream(stream_epochs, seed=1)
    assert np.all(np.isfinite(st_losses)), 'non-finite stream bench loss'
    stream_value = st_timer.report.member_steps_per_sec_per_chip
  except Exception:  # pylint: disable=broad-except
    print('WARNING: streaming bench failed:', file=sys.stderr)
    traceback.print_exc(limit=3, file=sys.stderr)

  # Prediction latency: means + 3 exact mixture quantiles over the full
  # workload through the trained MAP ensemble (the single jitted predict
  # program). Timed device-side: every output feeds a scalar reduction so
  # nothing is dead-code-eliminated, but only the scalar is fetched, so the
  # ~10 MB of per-member means never crosses the host link here (the
  # host-side number below includes it). Failures are non-fatal.
  predict_ms = None
  try:
    from bayesnf_tpu.inference import predict as predict_lib

    predict_fn = predict_lib._make_predict_fn(  # pylint: disable=protected-access
        config,
        likelihoods.LikelihoodDist.NORMAL,
        (0.5, 0.025, 0.975),
        1,
        False,
        4096,
        None,
    )

    @jax.jit
    def predict_reduced(params, xx):
      means, qs = predict_fn(params, xx)
      return means.sum() + sum(q.sum() for q in qs)

    checksum = float(predict_reduced(map_params, x))  # warm/compile
    assert np.isfinite(checksum), 'non-finite bench prediction'
    reps = 2 if small else 5
    predict_runs = []
    for _ in range(reps):
      with profiling.StepTimer(member_steps=1, num_chips=n_chips) as p_timer:
        float(predict_reduced(map_params, x))
      predict_runs.append(p_timer.report.seconds * 1000.0)
    # Best-of-N, with per-rep times in the record so a real regression is
    # distinguishable from run-to-run variance.
    predict_ms = min(predict_runs)
  except Exception:  # pylint: disable=broad-except
    print('WARNING: predict bench failed:', file=sys.stderr)
    traceback.print_exc(limit=3, file=sys.stderr)

  # Out-of-core streamed predict over the same full grid: rows stream from
  # host RAM in bounded chunks, means + 3 exact quantiles assemble into
  # host buffers. End-to-end host wall time (includes the host<->device
  # transfers that are the point of this regime). The fair comparison is
  # the in-memory program at the SAME contract — full host
  # materialization of means + quantiles — measured alongside as
  # `predict_host_ms`. Best-of-3 with per-run values. Non-fatal.
  stream_predict_ms = None
  predict_host_ms = None
  try:
    from bayesnf_tpu.inference import predict as predict_lib
    import time as _time

    p_pub = tuple(px[jnp.newaxis] for px in map_params)  # (1, E, ...)
    x_host = np.asarray(x)

    def run_predict_host(**extra):
      t0 = _time.perf_counter()
      means_s, qs_s = predict_lib.predict_bnf(
          x_host, 'NORMAL', p_pub, config,
          quantiles=(0.5, 0.025, 0.975), ensemble_dims=2, **extra,
      )
      means_s = np.asarray(means_s)
      qs_s = [np.asarray(q) for q in qs_s]
      assert np.isfinite(means_s).all()
      assert all(np.isfinite(q).all() for q in qs_s)
      return (_time.perf_counter() - t0) * 1000.0

    run_predict_host()  # warm/compile
    predict_host_runs = [run_predict_host() for _ in range(3)]
    predict_host_ms = min(predict_host_runs)

    run_predict_host(stream_chunk_rows=8192)  # warm/compile (two programs)
    stream_predict_runs = [
        run_predict_host(stream_chunk_rows=8192) for _ in range(3)
    ]
    stream_predict_ms = min(stream_predict_runs)
  except Exception:  # pylint: disable=broad-except
    print('WARNING: streamed predict bench failed:', file=sys.stderr)
    traceback.print_exc(limit=3, file=sys.stderr)

  # FLOPs/MFU accounting: one full-batch member-step runs forward +
  # backward over every row — backward costs ~2x the forward's matmuls
  # (grads w.r.t. inputs and weights), so model FLOPs per member-step =
  # 3 x rows x per-row forward matmul FLOPs. One VI member-step draws
  # `sample_size_divergence` MC samples, each a full forward+backward.
  # Device metrics only: a CPU smoke run reports none.
  fwd_row_flops = _matmul_flops_per_row(config)
  map_flops_per_member_step = 3 * n_rows * fwd_row_flops

  def flops_metrics(prefix, rate, flops_per_member_step):
    if not on_gpu:
      return {}
    return _flops_metrics(
        prefix, rate, flops_per_member_step, matmul_precision
    )

  device = jax.devices()[0]
  record = {
      'metric': 'map_member_steps_per_sec_per_chip',
      'value': round(value, 2),
      'unit': 'member-steps/s/chip',
      'platform': device.platform,
      'device_kind': device.device_kind,
      'device_count': jax.device_count(),
      'precision': precision,
      'matmul_precision': matmul_precision,
      'value_runs': [round(v, 2) for v in map_runs],
      'value_spread_pct': round(
          100.0 * (max(map_runs) - min(map_runs)) / max(map_runs), 1
      ),
      **flops_metrics('map', value, map_flops_per_member_step),
  }
  if vi_value is not None:
    record['vi_member_steps_per_sec_per_chip'] = round(vi_value, 2)
    record.update(
        flops_metrics('vi', vi_value, VI_MC_DRAWS * map_flops_per_member_step)
    )
  if nb_value is not None:
    record['nb_member_steps_per_sec_per_chip'] = round(nb_value, 2)
    record.update(flops_metrics('nb', nb_value, map_flops_per_member_step))
  if stream_value is not None:
    record['stream_member_steps_per_sec_per_chip'] = round(stream_value, 2)
  if predict_ms is not None:
    record['predict_ms_full_grid_3_quantiles'] = round(predict_ms, 1)
    record['predict_ms_runs'] = [round(v, 1) for v in predict_runs]
  if predict_host_ms is not None:
    record['predict_host_ms_full_grid_3_quantiles'] = round(
        predict_host_ms, 1
    )
    record['predict_host_ms_runs'] = [
        round(v, 1) for v in predict_host_runs
    ]
  if stream_predict_ms is not None:
    record['stream_predict_host_ms_full_grid_3_quantiles'] = round(
        stream_predict_ms, 1
    )
    record['stream_predict_ms_runs'] = [
        round(v, 1) for v in stream_predict_runs
    ]
    if predict_host_ms is not None:
      record['stream_predict_vs_in_memory_host'] = round(
          stream_predict_ms / predict_host_ms, 2
      )
  print(json.dumps(record))


if __name__ == '__main__':
  main()
