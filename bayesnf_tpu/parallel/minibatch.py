"""Row layout + per-shard minibatch scheme for the 'data' mesh axis.

The reference trains minibatch SGD with a *global* per-epoch permutation
(`/root/reference/src/bayesnf/inference.py:583-597`) — fine on one device,
but on a row-sharded mesh a global permutation makes every batch a global
gather. Here the sharded regime uses a **per-shard local permutation**:
each shard reshuffles only the rows it stores and contributes
``batch_size / data_shards`` rows to every step's batch.

This is a documented RNG deviation from the single-shard scheme (which
stays reference-compatible): batches are still uniformly drawn without
replacement *within* each shard and every step's global batch has exactly
`batch_size` rows, but the cross-shard composition of a batch differs
from a global permutation. Every sharded-minibatch trainer (MAP and VI,
in-memory) uses the SAME functions below.

Row layout. Stored rows are laid out so each shard holds a *valid prefix*:
shard ``s`` stores ``local_rows`` rows of which the first ``n_s`` are real
(``n_s`` differ by at most 1 across shards — "balanced") and the rest are
zero padding. Balance is what guarantees every shard can supply
``(N // B) * (B / shards)`` rows per epoch: that count is an integer
``<= N / shards`` and hence ``<= floor(N / shards) = min_s n_s``. When
``N % shards == 0`` the layout is the identity (no padding).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np


def shard_counts(data_size: int, shards: int) -> tuple[int, list[int]]:
  """(local_rows, per-shard valid counts) of the balanced layout."""
  base, extra = divmod(data_size, shards)
  local_rows = base + (1 if extra else 0)
  return local_rows, [base + (1 if s < extra else 0) for s in range(shards)]


def pad_rows_balanced(aug_t: jax.Array, target: jax.Array,
                      data_size: int, shards: int):
  """Pad + interleave stored rows so each shard holds a valid prefix.

  Args:
    aug_t: (F, N) features-major training inputs.
    target: (N,) targets.
    data_size: N.
    shards: extent of the 'data' mesh axis.

  Returns:
    (aug_t, target) with ``shards * local_rows`` stored rows: shard s's
    segment is original rows [sum(n_<s), sum(n_<=s)) followed by
    ``local_rows - n_s`` zero rows. Identity when N % shards == 0.
  """
  local_rows, counts = shard_counts(data_size, shards)
  if local_rows * shards == data_size:
    return aug_t, target
  segs_a, segs_y, off = [], [], 0
  for n_s in counts:
    pad = local_rows - n_s
    segs_a.append(jnp.pad(aug_t[:, off:off + n_s], ((0, 0), (0, pad))))
    segs_y.append(jnp.pad(target[off:off + n_s], (0, pad)))
    off += n_s
  return jnp.concatenate(segs_a, axis=1), jnp.concatenate(segs_y)


@functools.lru_cache(maxsize=32)
def make_layout_fn(data_size: int, shards: int, mesh=None):
  """ONE jitted program for the trainers' stored-row device layout.

  (N, F) inputs + (N,) targets -> features-major float32 `aug_t` (rows on
  the minor dimension) and float32 targets, through the balanced
  padded layout when the data axis is uneven. Replaces an eager
  transpose + convert (+ per-shard pads/concats) — each a separate
  compiled program. With a (single-process) `mesh` the
  outputs come back row-sharded over 'data', matching the train
  programs' in_shardings, so the first chunk dispatches without an eager
  reshard; multi-process callers pass mesh=None and globalize explicitly.
  """

  def layout(aug, target):
    aug_t = jnp.asarray(aug, dtype=jnp.float32).T
    tgt = jnp.asarray(target, dtype=jnp.float32)
    if (-data_size) % shards:
      return pad_rows_balanced(aug_t, tgt, data_size, shards)
    return aug_t, tgt

  if mesh is None:
    return jax.jit(layout)
  from bayesnf_tpu.parallel import mesh as mesh_lib

  return jax.jit(
      layout,
      out_shardings=(
          mesh_lib.data_sharding_t(mesh), mesh_lib.data_sharding(mesh)
      ),
  )


def valid_row_weights(data_size: int, shards: int) -> jnp.ndarray:
  """(stored_rows,) float mask of real rows under the balanced layout.

  Used by the GSPMD full-batch path, where there is no shard index to
  branch on — the mask is a static global array (1.0 real, 0.0 pad).
  """
  local_rows, _ = shard_counts(data_size, shards)
  base, extra = divmod(data_size, shards)
  pos = jnp.arange(shards * local_rows)
  shard = pos // local_rows
  n_s = base + (shard < extra).astype(pos.dtype)
  return ((pos % local_rows) < n_s).astype(jnp.float32)


def local_valid_count(data_size: int, shards: int, shard_index) -> jax.Array:
  """This shard's valid-row count n_s (traced `shard_index` OK)."""
  base, extra = divmod(data_size, shards)
  return base + (shard_index < extra).astype(jnp.int32)


def stored_positions(data_size: int, shards: int) -> np.ndarray:
  """(N,) map from original row index to stored position.

  Lets code that permutes *original* rows (the reference-compatible
  global-permutation path) index the balanced stored layout.
  """
  local_rows, counts = shard_counts(data_size, shards)
  out = np.empty(data_size, np.int32)
  off = 0
  for s, n_s in enumerate(counts):
    out[off:off + n_s] = s * local_rows + np.arange(n_s, dtype=np.int32)
    off += n_s
  return out


def local_permutation(permute_key: jax.Array, shard_index, local_rows: int,
                      n_valid, count: int) -> jax.Array:
  """`count` distinct uniformly-random valid local row positions.

  Valid rows are the first `n_valid` (possibly traced) of this shard's
  `local_rows` stored rows. Scheme: draw one uniform per stored row, push
  pad rows to +inf, argsort — the prefix is a uniform random permutation
  of the valid rows (the +inf trick sidesteps `jax.random.permutation`'s
  static-size requirement under a traced `n_valid`). Deterministic in
  (permute_key, shard_index).
  """
  key = jax.random.fold_in(permute_key, shard_index)
  u = jax.random.uniform(key, (local_rows,))
  u = jnp.where(jnp.arange(local_rows) < n_valid, u, jnp.inf)
  return jnp.argsort(u)[:count]
