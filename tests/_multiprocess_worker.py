"""Worker for the multi-process rehearsal test (not a pytest module).

Launched as `python _multiprocess_worker.py <process_id> <num_processes>
<port> <data_devices_per_host> [<ckpt_dir>|none] [<devices_per_process>]
[full|light]` with JAX_PLATFORMS=cpu and `devices_per_process` (default
4) virtual CPU devices per process. Joins the distributed runtime, fits
over the multi-host mesh, and prints one JSON line with the results.
`light` mode runs MAP + streamed MAP + both predict paths only (the
4-process 2x2 grid leg exercises host-major
placement and cross-host gathers without repeating the VI/checkpoint
coverage the 2-process legs own).
"""

import json
import os
import sys

_DEVICES = sys.argv[6] if len(sys.argv) > 6 else '4'
os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (
    os.environ.get('XLA_FLAGS', '')
    + f' --xla_force_host_platform_device_count={_DEVICES}'
).strip()

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np
import jax.numpy as jnp


def main():
  process_id, num_processes, port, data_per_host = map(int, sys.argv[1:5])
  ckpt_dir = sys.argv[5] if len(sys.argv) > 5 and sys.argv[5] != 'none' else None
  light = len(sys.argv) > 7 and sys.argv[7] == 'light'
  jax.distributed.initialize(
      coordinator_address=f'localhost:{port}',
      num_processes=num_processes,
      process_id=process_id,
  )

  sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
  from bayesnf_tpu.inference import map as map_lib
  from bayesnf_tpu.inference import predict as predict_lib
  from bayesnf_tpu.inference import vi as vi_lib
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import distributed

  mesh = distributed.multihost_mesh(data_devices_per_host=data_per_host)
  assert distributed.is_multiprocess_mesh(mesh)

  # Warm-up collective, THEN the phase sentinel for the harness's
  # flake-retry logic. `jax.distributed.initialize` succeeding is not
  # enough: the flaky ~30 s GetKeyValue deadline lives in the Gloo
  # CONTEXT formation, which happens at the first cross-process device
  # collective — so force that rendezvous here with a real allgather
  # (NOT `sync_global_devices`, whose barrier rides the coordination
  # service rather than the Gloo collectives backend — a loaded suite
  # run proved it leaves the flake point after the sentinel).
  # Deliberately a JAX-level primitive, not product code
  # (make_global/host_value): the retried pre-sentinel window must not
  # cover product collective paths, or a nondeterministic product
  # regression there could be retried into a flaky pass — see
  # tests/test_multiprocess.py.
  from jax.experimental import multihost_utils

  gathered = multihost_utils.process_allgather(
      np.asarray([process_id], np.int32)
  )
  assert gathered.size == num_processes * jax.local_device_count() or (
      gathered.size == num_processes
  ), gathered.shape
  print('WORKER_INIT_OK', flush=True)

  config = field_lib.FieldConfig.create(
      width=16,
      depth=2,
      input_scales=[50.0, 1.0],
      fourier_degrees=[3, 2],
      interactions=[(0, 1)],
      seasonality_periods=[7.0],
      num_seasonal_harmonics=[2],
  )
  rng = np.random.default_rng(0)
  x = rng.normal(size=(96, 2)).astype(np.float32) * 5
  y = rng.normal(size=(96,)).astype(np.float32)
  seasonal = field_lib.seasonal_features_for(config, jnp.asarray(x))
  aug = jnp.concatenate([jnp.asarray(x), seasonal], axis=-1)

  params, losses = map_lib.ensemble_map(
      aug,
      jnp.asarray(y),
      config,
      likelihoods.LikelihoodDist.NORMAL,
      ensemble_size=6,  # not a multiple of the 8-wide mesh: exercises padding
      learning_rate=0.01,
      num_epochs=4,
      seed=jax.random.PRNGKey(0),
      batch_size=32,
      prior_weight=1.0,
      mesh=mesh,
  )

  # Row-parallel prediction over the same multi-process mesh: every
  # process must get the FULL (means, quantiles) host arrays back.
  pred_means, pred_qs = predict_lib.predict_bnf(
      x,
      'NORMAL',
      params,
      config,
      quantiles=(0.1, 0.9),
      ensemble_dims=1,
      chunk_size=32,
      mesh=mesh,
  )

  # The distribution-object path (likelihood_model's engine) over the same
  # multi-process mesh: every process must get the full forecast-parameter
  # host arrays back.
  fp = vi_losses = vi_draws = None
  if not light:
    fp = predict_lib.forecast_params_bnf(
        x,
        'NORMAL',
        params,
        config,
        ensemble_dims=1,
        chunk_size=32,
        mesh=mesh,
    )

    _, vi_losses, vi_draws = vi_lib.fit_vi(
        aug,
        jnp.asarray(y),
        jax.random.PRNGKey(1),
        'NORMAL',
        config,
        ensemble_size=4,
        learning_rate=0.01,
        num_epochs=3,
        sample_size_divergence=2,
        sample_size_posterior=2,
        batch_size=32,
        mesh=mesh,
    )

  # Host-streaming MAP over the multi-process mesh: every process
  # assembles the same host batches (stream entropy derives from the raw
  # fit key, stable across processes), contributes its data-axis shards
  # via make_global, and gets full host params/losses back.
  aug_host, y_host = np.asarray(aug), np.asarray(y)
  stream_params, stream_losses = map_lib.ensemble_map(
      aug_host, y_host, config, likelihoods.LikelihoodDist.NORMAL,
      ensemble_size=6, learning_rate=0.01, num_epochs=4,
      seed=jax.random.PRNGKey(0), batch_size=32, prior_weight=1.0,
      mesh=mesh, stream_chunk_steps=2,
  )
  out_stream = {
      'stream_map_losses': np.asarray(stream_losses).tolist(),
      'stream_map_param_sums': [
          float(np.sum(np.asarray(p))) for p in stream_params
      ],
  }

  if not light:
    # Host-streaming VI over the multi-process mesh (per-step resampled
    # batches shared across members and MC draws).
    _, stream_vi_losses, _ = vi_lib.fit_vi(
        aug_host, y_host, jax.random.PRNGKey(1), 'NORMAL', config,
        ensemble_size=4, learning_rate=0.01, num_epochs=3,
        sample_size_divergence=2, sample_size_posterior=2, batch_size=32,
        mesh=mesh, stream_chunk_steps=2,
    )
    out_stream['stream_vi_losses'] = np.asarray(stream_vi_losses).tolist()

  # Out-of-core streamed predict over the multi-process mesh: rows stream
  # in host chunks (globalized per chunk), results gather to full host
  # buffers on every process.
  sp_means, sp_qs = predict_lib.predict_bnf(
      x, 'NORMAL', params, config, quantiles=(0.1, 0.9), ensemble_dims=1,
      chunk_size=32, mesh=mesh, stream_chunk_rows=48,
  )
  out_stream['stream_predict_means'] = np.asarray(sp_means).ravel().tolist()
  out_stream['stream_predict_quantiles'] = [
      np.asarray(q).tolist() for q in sp_qs
  ]

  out = {
      'process_id': process_id,
      'mesh_shape': dict(mesh.shape),
      'map_losses': np.asarray(losses).tolist(),
      'map_param_sums': [float(np.sum(np.asarray(p))) for p in params],
      'map_param_shapes': [list(np.shape(p)) for p in params],
      'predict_mean_shape': list(np.shape(pred_means)),
      'predict_means': np.asarray(pred_means).ravel().tolist(),
      'predict_quantiles': [np.asarray(q).tolist() for q in pred_qs],
      **out_stream,
  }
  if not light:
    out.update({
        'vi_losses': np.asarray(vi_losses).tolist(),
        'vi_draw_sum': float(sum(np.sum(np.asarray(d)) for d in vi_draws)),
        'forecast_param_shapes': [list(np.shape(f)) for f in fp],
        'forecast_param_sums': [float(np.sum(np.asarray(f))) for f in fp],
    })

  if ckpt_dir is not None:
    # Checkpoint/resume across the process boundary: train 2 of 4 epochs
    # (one checkpointed chunk), then re-invoke with the full budget — the
    # second call must restore process-consistently and finish the run
    # with the exact losses of the uninterrupted fit above.
    common = dict(
        ensemble_size=6, learning_rate=0.01, num_epochs=4,
        seed=jax.random.PRNGKey(0), batch_size=32, prior_weight=1.0,
        mesh=mesh, checkpoint_dir=ckpt_dir,
        checkpoint_every=2,
    )
    interrupted = dict(common, num_epochs=2)
    map_lib.ensemble_map(
        aug, jnp.asarray(y), config, likelihoods.LikelihoodDist.NORMAL,
        **interrupted,
    )
    _, resumed_losses = map_lib.ensemble_map(
        aug, jnp.asarray(y), config, likelihoods.LikelihoodDist.NORMAL,
        **common,
    )
    out['ckpt_map_losses'] = np.asarray(resumed_losses).tolist()

    # Mid-stream checkpoint resume across the process boundary: the
    # host-streamed fit is interrupted after its first checkpointed chunk,
    # then resumed by a fresh invocation — every process must replay the
    # identical remaining batch sequence (stream state is derived, not
    # stored) and land on the uninterrupted streamed run's exact losses.
    stream_common = dict(
        ensemble_size=6, learning_rate=0.01, num_epochs=4,
        seed=jax.random.PRNGKey(0), batch_size=32, prior_weight=1.0,
        mesh=mesh, stream_chunk_steps=2,
        checkpoint_dir=os.path.join(ckpt_dir, 'stream'), checkpoint_every=2,
    )
    map_lib.ensemble_map(
        aug_host, y_host, config, likelihoods.LikelihoodDist.NORMAL,
        **dict(stream_common, num_epochs=2),
    )
    _, stream_resumed = map_lib.ensemble_map(
        aug_host, y_host, config, likelihoods.LikelihoodDist.NORMAL,
        **stream_common,
    )
    out['ckpt_stream_map_losses'] = np.asarray(stream_resumed).tolist()

  print('WORKER_RESULT ' + json.dumps(out), flush=True)


if __name__ == '__main__':
  main()
