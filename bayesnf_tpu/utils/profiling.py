"""Profiling hooks: XLA trace capture and throughput counters.

The reference has no profiling at all (SURVEY.md §5 — only CLI wall-clock).
Here every fit can drop an xprof trace (`jax.profiler`) and report
member-steps/sec/chip, the framework's headline throughput metric.
"""

import contextlib
import dataclasses
import glob
import os
import re
import time

import jax


def compile_cache_dir(default_dir: str) -> str:
  """The persistent compile-cache directory a script should use.

  `JAX_COMPILATION_CACHE_DIR` where it is set (JAX reads it itself), and
  `default_dir` otherwise — a fixed path, since the path is part of the
  cache key and a directory that moves never hits.
  """
  return os.environ.get('JAX_COMPILATION_CACHE_DIR') or default_dir


def enable_compile_cache(default_dir: str) -> str:
  """Point JAX's persistent compilation cache at `compile_cache_dir`.

  For entry-point scripts (benchmark, smoke test, tutorials); the library
  itself never sets a cache. Returns the directory used.
  """
  path = compile_cache_dir(default_dir)
  jax.config.update('jax_compilation_cache_dir', path)
  return path


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
  """Capture a jax.profiler trace into `trace_dir` when it is set."""
  if not trace_dir:
    yield
    return
  with jax.profiler.trace(trace_dir):
    yield


@dataclasses.dataclass
class ThroughputReport:
  """Throughput of one training call."""

  member_steps: int
  seconds: float
  num_chips: int

  @property
  def member_steps_per_sec_per_chip(self) -> float:
    return self.member_steps / self.seconds / max(self.num_chips, 1)

  def __str__(self):
    return (
        f'{self.member_steps} member-steps in {self.seconds:.2f}s on '
        f'{self.num_chips} chip(s) = '
        f'{self.member_steps_per_sec_per_chip:.1f} member-steps/s/chip'
    )


class StepTimer:
  """Times a block and converts it to a ThroughputReport.

  Example:
    with StepTimer(member_steps=epochs * batches * ensemble) as t:
      losses = train(...)
      jax.block_until_ready(losses)
    print(t.report)
  """

  def __init__(self, member_steps: int, num_chips: int | None = None):
    self.member_steps = member_steps
    self.num_chips = num_chips or jax.device_count()
    self.report = None

  def __enter__(self):
    self._start = time.perf_counter()
    return self

  def __exit__(self, *exc):
    self.report = ThroughputReport(
        member_steps=self.member_steps,
        seconds=time.perf_counter() - self._start,
        num_chips=self.num_chips,
    )
    return False


# cuBLAS / CUTLASS kernel naming on Hopper: *gemm*, sm90_xmma_*, nvjet_*.
_GEMM_KERNEL = re.compile(r'gemm|xmma|nvjet|cutlass', re.IGNORECASE)
_COPY_KERNEL = re.compile(r'memcpy|memset', re.IGNORECASE)
# Device-plane lines that summarize kernels rather than list them.
_SUMMARY_LINES = ('XLA Modules', 'XLA Ops', 'Steps', 'Source code',
                  'Framework Name Scope', 'XLA TraceMe')


def kernel_time_split(events, top=12):
  """GEMM / other / copy / idle split of one device's kernel events.

  Args:
    events: iterable of (name, start_ns, duration_ns) kernel events.
    top: how many of the longest kernels (by summed time) to list.

  Busy time is the union of the kernel intervals; the window runs from
  the first kernel's start to the last kernel's end, and the idle share is
  1 - busy / window. Kernel categories add up kernel durations, so with
  concurrent streams they can exceed busy time.
  """
  events = sorted((float(s), float(d), n) for n, s, d in events)
  if not events:
    return {'kernels': 0}
  busy, cur_lo, cur_hi = 0.0, events[0][0], events[0][0] + events[0][1]
  totals = {}
  for start, dur, name in events:
    totals[name] = totals.get(name, 0.0) + dur
    if start > cur_hi:
      busy += cur_hi - cur_lo
      cur_lo, cur_hi = start, start + dur
    else:
      cur_hi = max(cur_hi, start + dur)
  busy += cur_hi - cur_lo
  window = max(s + d for s, d, _ in events) - events[0][0]
  gemm = sum(t for n, t in totals.items() if _GEMM_KERNEL.search(n))
  copy = sum(t for n, t in totals.items() if _COPY_KERNEL.search(n))
  other = sum(totals.values()) - gemm - copy
  ms = lambda ns: round(ns / 1e6, 4)  # noqa: E731
  return {
      'kernels': len(events),
      'window_ms': ms(window),
      'busy_ms': ms(busy),
      'idle_share': round(1.0 - busy / window, 4) if window else 0.0,
      'gemm_ms': ms(gemm),
      'other_ms': ms(other),
      'copy_ms': ms(copy),
      'gemm_share_of_kernel_time': round(gemm / sum(totals.values()), 4),
      'top_kernels_ms': [
          (n[:90], ms(t))
          for n, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]
      ],
  }


def device_time_split(trace_dir):
  """`kernel_time_split` of each GPU plane of a `jax.profiler` trace.

  Reads the newest `.xplane.pb` under `trace_dir` and takes kernel events
  from each '/device:GPU:N' plane's stream lines. Returns
  {plane name: split}; a trace without a GPU plane returns {}.
  """
  from jax.profiler import ProfileData

  paths = sorted(
      glob.glob(os.path.join(trace_dir, 'plugins', 'profile', '*',
                             '*.xplane.pb')),
      key=os.path.getmtime,
  )
  if not paths:
    raise FileNotFoundError(f'no .xplane.pb trace under {trace_dir}')
  out = {}
  for plane in ProfileData.from_file(paths[-1]).planes:
    if not plane.name.startswith('/device:GPU'):
      continue
    events = [
        (ev.name, ev.start_ns, ev.duration_ns)
        for line in plane.lines
        if line.name not in _SUMMARY_LINES
        for ev in line.events
    ]
    split = kernel_time_split(events)
    split['lines'] = sorted({line.name for line in plane.lines})
    out[plane.name] = split
  return out
