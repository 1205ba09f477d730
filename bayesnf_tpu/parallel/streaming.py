"""Host-resident streaming minibatch pipeline.

The on-device trainers keep the whole training set in device memory — the
right call whenever it fits (device-memory bandwidth beats the host link by
orders of magnitude, and the registry's largest config, sst at 221k rows, is a few
hundred MB). The streaming regime exists for the datasets that *don't*
fit: the dataset stays in host RAM (or a numpy memmap on disk), and each
SGD step's minibatch is assembled on host and shipped to the mesh in
slices of ``stream_chunk_steps`` steps. Device memory then holds O(slices in
flight x slice rows) instead of O(N): with the default throttle, roughly
``3 * stream_chunk_steps * batch_size`` rows.

The pipeline is plain double buffering with no extra machinery:
dispatching a jitted slice program returns immediately (JAX async
dispatch), so the host loop assembles and ``device_put``s slice k+1 while
the device runs slice k. A depth-2 throttle (block on slice k-2's losses,
a tiny (E, S) array) bounds how far the host can run ahead, which bounds
the number of slice buffers alive on the device.

RNG scheme — a documented deviation from the reference
(`/root/reference/src/bayesnf/inference.py:583-597`, one device-side
permutation per member per epoch): streaming draws ONE host-side global
permutation per epoch, shared by every ensemble member. Shipping
per-member batches would multiply host->device traffic by the ensemble
size for no statistical benefit (members already differ by init and, for
VI, by their MC draws). MAP partitions one permutation per epoch; VI's
per-step resampling draws each batch in O(batch) work (`step_sample`).
Both derive deterministically from (seed, epoch-or-step), so a checkpoint
resume replays the identical batch sequence without storing any stream
state.
"""

from __future__ import annotations

import jax
import numpy as np


def stream_entropy(seed: jax.Array) -> tuple[int, ...]:
  """Host entropy derived from a JAX PRNG key, for `np.random.SeedSequence`.

  Uses the raw key data (stable across processes and backends — no device
  math), so every process of a multi-process mesh assembles identical
  batches from the same fit seed.
  """
  data = np.asarray(jax.random.key_data(seed)).reshape(-1)
  return tuple(int(x) for x in data)


def _step_rng(entropy: tuple[int, ...], step: int) -> np.random.Generator:
  return np.random.default_rng(
      np.random.SeedSequence(entropy=list(entropy) + [int(step)])
  )


def epoch_permutation(
    entropy: tuple[int, ...], epoch: int, data_size: int
) -> np.ndarray:
  """The shared row permutation for one epoch (deterministic in inputs).

  int32 indices where they fit: at streaming scale the permutation is the
  only O(N) side allocation, and int64 would double it.
  """
  rng = _step_rng(entropy, epoch)
  if data_size <= np.iinfo(np.int32).max:
    return rng.permutation(np.arange(data_size, dtype=np.int32))
  return rng.permutation(data_size)


def step_sample(
    entropy: tuple[int, ...], step: int, data_size: int, batch_size: int
) -> np.ndarray:
  """A fresh without-replacement batch for one step, in O(batch) host work.

  The VI regime draws a new batch EVERY step; materializing an O(N)
  permutation per step would let host-side batch assembly dwarf device
  compute exactly where streaming matters (N >> B). `Generator.choice`
  with replace=False is O(batch) (Floyd-style sampling; measured 0.2 ms
  vs 20 s for a full permutation at N=2e8), deterministic in
  (entropy, step), and uniform over batches — the same distribution as a
  permutation prefix, which is all the reference's per-step resampling
  semantics require (reference inference.py:704-709)."""
  return _step_rng(entropy, step).choice(
      data_size, size=batch_size, replace=False
  )


class HostBatchStream:
  """Assembles per-step minibatches from a host-resident dataset.

  Args:
    aug_t: (F, N) features-major float32 training inputs. Kept as given —
      pass a numpy array (or memmap) so nothing touches device memory.
    target: (N,) float32 targets.
    batch_size: rows per SGD step. The ragged tail of each epoch is
      dropped, matching the on-device trainers (reference
      `inference.py:583-597` semantics).
    seed: the fit's PRNG key; only host-side entropy is derived from it.
    per_step_resample: False (default, MAP/MLE semantics) partitions each
      epoch's permutation into `N // B` batches; True (VI semantics,
      reference `inference.py:704-709`) draws a FRESH without-replacement
      batch every step in O(batch) host work (`step_sample`) — each step
      seeds its own derivation, so resume replay still holds.
  """

  def __init__(
      self,
      aug_t,
      target,
      batch_size: int,
      seed: jax.Array,
      per_step_resample: bool = False,
  ):
    self.aug_t = aug_t
    self.target = target
    self.batch_size = int(batch_size)
    self.data_size = int(target.shape[0])
    self.num_batches = self.data_size // self.batch_size
    if self.num_batches < 1:
      raise ValueError(
          f'batch_size {batch_size} exceeds the dataset ({self.data_size}'
          ' rows).'
      )
    self.per_step_resample = bool(per_step_resample)
    self._entropy = stream_entropy(seed)
    self._perm_epoch = -1
    self._perm = None

  def _batch_rows(self, step: int) -> np.ndarray:
    """Row indices of global SGD step `step` (0-based, spans epochs)."""
    if self.per_step_resample:
      return step_sample(self._entropy, step, self.data_size, self.batch_size)
    epoch, b = divmod(step, self.num_batches)
    if epoch != self._perm_epoch:
      self._perm = epoch_permutation(self._entropy, epoch, self.data_size)
      self._perm_epoch = epoch
    return self._perm[b * self.batch_size : (b + 1) * self.batch_size]

  def slice_at(self, step: int, num_steps: int):
    """(num_steps, F, batch) inputs and (num_steps, batch) targets."""
    aug = np.empty(
        (num_steps, self.aug_t.shape[0], self.batch_size), dtype=np.float32
    )
    y = np.empty((num_steps, self.batch_size), dtype=np.float32)
    for s in range(num_steps):
      rows = self._batch_rows(step + s)
      aug[s] = self.aug_t[:, rows]
      y[s] = self.target[rows]
    return aug, y

  def slices(self, start_step: int, num_steps: int, slice_steps: int):
    """Yield (step, aug_slice, y_slice) covering `num_steps` steps.

    Every slice has exactly `slice_steps` steps except possibly the last
    (the one ragged shape costs at most one extra compile).
    """
    step, end = start_step, start_step + num_steps
    while step < end:
      s = min(slice_steps, end - step)
      aug, y = self.slice_at(step, s)
      yield step, aug, y
      step += s


def member_remix_plan(raw_key, aug_s, y_s, e_local: int):
  """Per-member repartition plan for a streamed slice's resident row pool.

  The member-remix scheme (PARITY.md §2b): one slice of S host-assembled
  batches is transferred ONCE, and each ensemble member repartitions the
  resident S x B rows into its OWN S batches — per-member SGD-noise
  decorrelation (the reference permutes per member,
  `/root/reference/src/bayesnf/inference.py:593-597`) at zero extra
  host->device traffic. Shared by the MAP and VI stream trainers so their
  remix RNG semantics are identical by construction.

  Runs INSIDE shard_map: keys derive from (slice key, GLOBAL member id via
  the 'ens' axis index) so results are independent of the ens-axis
  sharding. Returns (pool_aug (F, S*B), pool_y (S*B), idx_s (S, E_local,
  B)) — the per-step gather stays (E_local, F, B), transient, never
  E x slice resident.
  """
  import jax.numpy as jnp

  from bayesnf_tpu.parallel import mesh as mesh_lib

  s, f_dim, b = aug_s.shape
  pool_aug = jnp.moveaxis(aug_s, 0, 1).reshape(f_dim, s * b)
  pool_y = y_s.reshape(s * b)
  member_ids = (
      jax.lax.axis_index(mesh_lib.ENSEMBLE_AXIS) * e_local
      + jnp.arange(e_local)
  )
  slice_key = jax.random.wrap_key_data(raw_key)
  perms = jax.vmap(
      lambda m: jax.random.permutation(
          jax.random.fold_in(slice_key, m), s * b
      )
  )(member_ids)  # (E_local, S*B)
  idx_s = jnp.moveaxis(perms.reshape(e_local, s, b), 1, 0)  # (S, E, B)
  return pool_aug, pool_y, idx_s


def remix_slice_key_fn(opt_seed: jax.Array):
  """The per-slice raw-key derivation of the member-remix scheme.

  One shared definition (MAP and VI trainers) of how a slice's remix key
  derives from the run seed and the slice's ABSOLUTE start step — the
  checkpoint-resume replay guarantee depends on both trainers using
  exactly this mapping.
  """
  remix_key = jax.random.fold_in(opt_seed, 0x5EED)

  def slice_extra_fn(slice_step):
    return np.asarray(
        jax.random.key_data(jax.random.fold_in(remix_key, slice_step))
    )

  return slice_extra_fn


def validate_remix_alignment(
    window: int, start_step: int, checkpoint_steps: int | None
) -> None:
  """Remix windows are keyed by absolute start step — checkpoint chunks
  AND the resume step must land on window boundaries, or a resumed run
  would recompose batches mid-window and silently diverge from the
  uninterrupted run it claims to replay."""
  window = int(window)
  if checkpoint_steps is not None and checkpoint_steps % window:
    raise ValueError(
        'stream_member_remix makes stream_chunk_steps the remix '
        'window: checkpoint chunks must cover whole windows so a '
        'resume replays identical batches (got checkpoint chunk of '
        f'{checkpoint_steps} steps, window {window}). Pick '
        'checkpoint_every/batch_size so the checkpoint chunk step count '
        'is a multiple of stream_chunk_steps.'
    )
  if start_step % window:
    raise ValueError(
        'stream_member_remix resume must start on a remix window '
        f'boundary (window {window} steps, resuming at step '
        f'{start_step}): extending a run whose completed step count is '
        'not a multiple of the window would recompose batches mid-window '
        'instead of replaying the fresh-run schedule. Pick num_epochs so '
        'the total step count is a multiple of stream_chunk_steps.'
    )


def run_stream_driver(
    stream: HostBatchStream,
    *,
    mesh,
    multiproc: bool,
    make_fn,
    state: tuple,
    start_step: int,
    num_steps: int,
    slice_steps: int,
    checkpoint_steps: int | None,
    on_chunk,
    slice_extra_fn=None,
):
  """The host-side streaming train loop, shared by the MAP and VI trainers.

  Drives `stream` through `num_steps` SGD steps in checkpoint-granularity
  chunks: each slice is device_put (sharded over the mesh's 'data' axis)
  and run through the trainer's slice program, double-buffered behind a
  depth-2 throttle (dispatch is async, so slice k+1's host assembly +
  transfer overlap slice k's compute; blocking on slice k-1's tiny losses
  bounds live device slice buffers).

  Args:
    stream: the host batch stream positioned over the training set.
    mesh: the fit mesh ('data' axis shards batch rows).
    multiproc: whether the mesh spans processes (globalized transfers).
    make_fn: (slice_steps) -> slice program. The program takes
      (*state, aug_dev, y_dev) and returns (*state, losses) with losses'
      trailing axis the slice's steps.
    state: the trainer's state tuple, threaded positionally.
    start_step: global step to resume from (chunk-aligned).
    num_steps: total steps of the full fit.
    slice_steps: steps per transferred slice.
    checkpoint_steps: chunk size in steps (None = one chunk to the end).
    on_chunk: (state, losses, steps_done) called after each chunk with the
      chunk's host-side loss history (trailing axis = chunk steps) —
      checkpointing and loss bookkeeping live in the trainer.
    slice_extra_fn: optional `(slice_start_step) -> host array` appended
      (replicated over the mesh) as a final argument to each slice-program
      call — the member-remix scheme passes its per-slice raw key this
      way. Deterministic in the step, so resume replay holds.

  Returns:
    The final state.
  """
  import jax  # local: keep module import-light for host-only tests

  from bayesnf_tpu.parallel import distributed as dist_lib
  from bayesnf_tpu.parallel import mesh as mesh_lib

  aug_spec = jax.sharding.NamedSharding(
      mesh, jax.sharding.PartitionSpec(None, None, mesh_lib.DATA_AXIS)
  )
  y_spec = jax.sharding.NamedSharding(
      mesh, jax.sharding.PartitionSpec(None, mesh_lib.DATA_AXIS)
  )
  rep_spec = jax.sharding.NamedSharding(
      mesh, jax.sharding.PartitionSpec()
  )
  n_state = len(state)
  step = start_step
  while step < num_steps:
    chunk = (
        num_steps - step
        if checkpoint_steps is None
        else min(checkpoint_steps, num_steps - step)
    )
    chunk_losses = []
    for slice_step, aug_np, y_np in stream.slices(step, chunk, slice_steps):
      if multiproc:
        aug_dev = dist_lib.make_global(aug_np, aug_spec)
        y_dev = dist_lib.make_global(y_np, y_spec)
      else:
        aug_dev = jax.device_put(aug_np, aug_spec)
        y_dev = jax.device_put(y_np, y_spec)
      extra = ()
      if slice_extra_fn is not None:
        extra_np = np.asarray(slice_extra_fn(slice_step))
        extra = (
            dist_lib.make_global(extra_np, rep_spec)
            if multiproc
            else jax.device_put(extra_np, rep_spec),
        )
      out = make_fn(int(aug_np.shape[0]))(*state, aug_dev, y_dev, *extra)
      state, losses_s = tuple(out[:n_state]), out[n_state]
      chunk_losses.append(losses_s)
      if len(chunk_losses) > 1:
        jax.block_until_ready(chunk_losses[-2])
    losses_c = np.concatenate(
        [dist_lib.host_value(l) for l in chunk_losses], axis=-1
    )
    step += chunk
    on_chunk(state, losses_c, step)
  return state
