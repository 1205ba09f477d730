"""Out-of-core regime evidence: streamed fit + predict at multi-million N.

The host-streaming subsystems exist for datasets larger than device
memory. This runner builds a synthetic memmap-backed dataset of `--rows`
rows (default 5M; the feature matrix never enters process RAM as a whole
— numpy memmaps on disk, the same host-resident shape a real
beyond-device-memory dataset would take), then records one artifact with:

- **Streamed MAP fit** (`stream_chunk_steps` host batching): wall,
  member-steps/s, and rows/s through the device.
- **Streamed predict** (two-pass global-bracket, device cache budget):
  wall, rows/s, and the device-memory ceiling actually observed.
- **Footprints**: peak device memory in use (`device.memory_stats()`)
  after each phase, and peak host RSS.
- **Bit-identity spot checks** at scale: the streamed fit's losses must
  be invariant to the stream slice size (the streaming contract — the
  streamed batch scheme intentionally differs from the on-device one,
  see the `stream` checkpoint-fingerprint key), and streamed predict
  outputs must equal the in-memory predict program's on sampled rows
  (the grid still fits device memory at the default scale — that is what
  makes the cross-check POSSIBLE; the streamed path never exploits it).

Usage:

    python -m bayesnf_tpu.cli.stream_scale_run --json-out stream_scale.json

`--rows`, `--ensemble`, `--cache-bytes` scale the run; `--skip-identity`
drops the in-memory cross-checks for grids that genuinely exceed device
memory.
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np


def _device_memory_stats():
  import jax

  stats = jax.devices()[0].memory_stats() or {}
  return {
      'bytes_in_use': int(stats.get('bytes_in_use', -1)),
      'peak_bytes_in_use': int(stats.get('peak_bytes_in_use', -1)),
  }


def _peak_rss_gb():
  return round(
      resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024 / 1024, 2
  )


def _build_memmap_dataset(root, config, n_rows, seed=0, block=1_000_000):
  """Synthetic aug-features + target memmaps, written block-wise.

  Block-wise generation keeps peak host RAM at O(block), so the script
  itself honors the regime it measures.
  """
  import jax.numpy as jnp

  from bayesnf_tpu.models import field as field_lib

  d_aug = config.num_inputs + 2 * len(config.seasonal_frequencies)
  aug_path = os.path.join(root, 'aug.f32')
  y_path = os.path.join(root, 'y.f32')
  aug_mm = np.memmap(aug_path, np.float32, 'w+', shape=(n_rows, d_aug))
  y_mm = np.memmap(y_path, np.float32, 'w+', shape=(n_rows,))
  rng = np.random.default_rng(seed)
  for lo in range(0, n_rows, block):
    hi = min(lo + block, n_rows)
    t = np.arange(lo, hi, dtype=np.float32)
    space = rng.normal(size=(hi - lo, 2)).astype(np.float32)
    x = np.concatenate([t[:, None], space], axis=-1)
    y = (
        10 * np.sin(2 * np.pi * t / 24.0)
        + 3 * np.sin(2 * np.pi * t / (24.0 * 7))
        + space[:, 0]
        + rng.normal(size=hi - lo).astype(np.float32)
    ).astype(np.float32)
    seasonal = np.asarray(
        field_lib.seasonal_features_for(config, jnp.asarray(x))
    )
    aug_mm[lo:hi] = np.concatenate([x, seasonal], axis=-1)
    y_mm[lo:hi] = y
  aug_mm.flush()
  y_mm.flush()
  del aug_mm, y_mm
  aug = np.memmap(aug_path, np.float32, 'r', shape=(n_rows, d_aug))
  y = np.memmap(y_path, np.float32, 'r', shape=(n_rows,))
  return aug, y


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--json-out', required=True)
  parser.add_argument('--rows', type=int, default=5_000_000)
  parser.add_argument('--ensemble', type=int, default=8)
  parser.add_argument('--epochs', type=int, default=2)
  parser.add_argument('--batch-size', type=int, default=262_144)
  parser.add_argument('--stream-chunk-steps', type=int, default=4)
  parser.add_argument('--stream-chunk-rows', type=int, default=65_536)
  parser.add_argument('--cache-bytes', type=int, default=1 << 30)
  parser.add_argument('--skip-identity', action='store_true',
                      help='skip in-memory cross-checks (grid beyond '
                           'device memory)')
  parser.add_argument('--workdir', default=None)
  args = parser.parse_args(argv)

  import jax
  import jax.numpy as jnp

  from bayesnf_tpu.inference import map as map_lib
  from bayesnf_tpu.inference import predict as predict_lib
  from bayesnf_tpu.models import field as field_lib
  from bayesnf_tpu.models import likelihoods
  from bayesnf_tpu.parallel import mesh as mesh_lib

  n = int(args.rows)
  config = field_lib.FieldConfig.create(
      width=512,
      depth=2,
      input_scales=[float(n - 1), 1.0, 1.0],
      fourier_degrees=[5, 5, 5],
      interactions=[],
      seasonality_periods=[24.0, 24.0 * 7],
      num_seasonal_harmonics=[4, 4],
  )

  workdir = args.workdir or tempfile.mkdtemp(prefix='bnf_stream_scale_')
  t0 = time.perf_counter()
  aug, y = _build_memmap_dataset(workdir, config, n)
  build_s = time.perf_counter() - t0
  host_bytes = aug.nbytes + y.nbytes

  mesh = mesh_lib.default_mesh()
  fit_kwargs = dict(
      ensemble_size=args.ensemble,
      learning_rate=0.005,
      num_epochs=args.epochs,
      batch_size=args.batch_size,
      prior_weight=1.0,
      mesh=mesh,
  )

  def run_fit(stream_chunk_steps):
    # Always host-streamed: the in-memory variant would materialize the
    # full memmap on device — the exact regime violation this script
    # exists to measure.
    params, losses = map_lib.ensemble_map(
        aug, y, config, likelihoods.LikelihoodDist.NORMAL,
        seed=jax.random.PRNGKey(0), stream_chunk_steps=stream_chunk_steps,
        **fit_kwargs,
    )
    return params, np.asarray(losses)

  # Streamed fit: compile pass at the SAME epoch count as the timed run
  # (the total step count fixes the ragged tail-slice program's shape —
  # a shorter warm-up would leave one compilation inside the timed wall).
  steps_per_epoch = n // args.batch_size
  run_fit(args.stream_chunk_steps)
  t0 = time.perf_counter()
  params, stream_losses = run_fit(args.stream_chunk_steps)
  fit_s = time.perf_counter() - t0
  assert np.all(np.isfinite(stream_losses))
  member_steps = args.epochs * steps_per_epoch * args.ensemble
  fit_memory = _device_memory_stats()

  artifact = {
      'command': (
          'python -m bayesnf_tpu.cli.stream_scale_run '
          f'--json-out {os.path.basename(args.json_out)}'
          + (f' --rows {n}' if n != 5_000_000 else '')
      ),
      'device_kind': jax.devices()[0].device_kind,
      'platform': jax.devices()[0].platform,
      'rows': n,
      'ensemble': args.ensemble,
      'host_dataset_gb': round(host_bytes / 2**30, 3),
      'dataset_build_s': round(build_s, 1),
      'streamed_fit': {
          'epochs': args.epochs,
          'batch_size': args.batch_size,
          'stream_chunk_steps': args.stream_chunk_steps,
          'wall_s': round(fit_s, 1),
          'member_steps_per_sec': round(member_steps / fit_s, 1),
          'rows_per_sec_through_device': round(
              args.epochs * steps_per_epoch * args.batch_size / fit_s
          ),
          'device_memory_after': fit_memory,
      },
      'peak_host_rss_gb_after_fit': _peak_rss_gb(),
  }

  # Streamed predict over the full grid (params in the public (1, E, ...)
  # layout), 3 exact quantiles.
  p_pub = tuple(p[jnp.newaxis] for p in params)
  x_mm = aug[:, : config.num_inputs]  # raw features view of the memmap

  def run_stream_predict():
    t0 = time.perf_counter()
    means, qs = predict_lib.predict_bnf(
        x_mm, 'NORMAL', p_pub, config, quantiles=(0.5, 0.025, 0.975),
        ensemble_dims=2,
        stream_chunk_rows=args.stream_chunk_rows,
        stream_cache_bytes=args.cache_bytes,
    )
    return means, qs, time.perf_counter() - t0

  run_stream_predict()  # compile
  means_s, qs_s, predict_s = run_stream_predict()
  assert np.isfinite(means_s).all()
  assert all(np.isfinite(q).all() for q in qs_s)
  predict_memory = _device_memory_stats()
  cache_chunks_fit = (args.cache_bytes // (
      args.ensemble * args.stream_chunk_rows * 4)) if args.cache_bytes else 0
  artifact['streamed_predict'] = {
      'stream_chunk_rows': args.stream_chunk_rows,
      'cache_budget_gb': round(args.cache_bytes / 2**30, 3),
      'chunks': -(-n // args.stream_chunk_rows),
      'chunks_device_cached': min(
          -(-n // args.stream_chunk_rows), cache_chunks_fit
      ),
      'wall_s': round(predict_s, 1),
      'rows_per_sec': round(n / predict_s),
      'quantiles': 3,
      'device_memory_after': predict_memory,
  }
  artifact['peak_host_rss_gb_after_predict'] = _peak_rss_gb()
  artifact['transport_note'] = (
      'streamed-fit rows/s is bounded by host->device transfer by design '
      '(every row crosses the host link each epoch). device_memory_after '
      'is -1 where the device does not expose memory_stats (the '
      'device-side ceiling is bounded by construction: cache_budget_gb + '
      'one in-flight chunk).'
  )

  if not args.skip_identity:
    # Bit-identity spot checks at scale. Fit: the streaming contract is
    # slice-size invariance (the host chunking is pure transfer
    # granularity — same batches, same losses, any chunk size).
    other_steps = max(1, args.stream_chunk_steps // 2)
    _, other_losses = run_fit(other_steps)
    artifact['fit_losses_bit_invariant_to_slice_size'] = bool(
        np.array_equal(stream_losses, np.asarray(other_losses))
    )

    means_m, qs_m = predict_lib.predict_bnf(
        jnp.asarray(np.asarray(x_mm)), 'NORMAL', p_pub, config,
        quantiles=(0.5, 0.025, 0.975), ensemble_dims=2,
    )
    rng = np.random.default_rng(0)
    idx = np.sort(rng.choice(n, size=4096, replace=False))
    means_m = np.asarray(means_m)
    sample_equal = bool(
        np.array_equal(means_s[..., idx], means_m[..., idx])
    ) and all(
        np.array_equal(np.asarray(qs)[idx], np.asarray(qm)[idx])
        for qs, qm in zip(qs_s, qs_m)
    )
    artifact['predict_bit_identical_on_4096_sampled_rows'] = sample_equal
    assert artifact['fit_losses_bit_invariant_to_slice_size']
    assert sample_equal

  with open(args.json_out, 'w') as f:
    json.dump(artifact, f, indent=2)
    f.write('\n')
  print(json.dumps(artifact, indent=2))
  return 0


if __name__ == '__main__':
  sys.exit(main())
