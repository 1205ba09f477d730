"""Precision-controlled matmuls with fusion-fenced backwards.

Three tiers (all f32-accumulating via `preferred_element_type`):

- `matmul_f32`: plain dots at JAX's default matmul precision. On an H100
  that default may run f32 dots on the tensor cores as TF32 (10 explicit
  mantissa bits per operand), so this tier is close to, not equal to,
  exact f32.
- `matmul_bf16`: EXPLICIT bf16 operand casts, forward and backward (the
  custom VJP casts the cotangent too, so all three dots are uniformly
  bf16 on any backend, and residuals are stored in bf16 — halving
  activation memory traffic).
- `matmul_highest`: `Precision.HIGHEST` on all three dots — exact f32
  arithmetic, the reference tier.

All tiers fence their backward dots with `optimization_barrier`, so that
XLA emits the weight-gradient contraction (dW = h^T dz, a huge-N
outer-product reduction) as a standalone matmul instead of fusing it into
its elementwise producer chain as a multiply+reduce.
"""

import jax
import jax.numpy as jnp


@jax.custom_vjp
def matmul_bf16(a, b):
  """a @ b with bf16 operands and f32 accumulation, fwd and bwd."""
  return jnp.dot(
      a.astype(jnp.bfloat16),
      b.astype(jnp.bfloat16),
      preferred_element_type=jnp.float32,
  )


def _fwd(a, b):
  a16 = a.astype(jnp.bfloat16)
  b16 = b.astype(jnp.bfloat16)
  out = jnp.dot(a16, b16, preferred_element_type=jnp.float32)
  return out, (a16, b16)


def _bwd(res, g):
  a16, b16 = res
  g16 = g.astype(jnp.bfloat16)
  # Fence from producer fusion so both dots stay matmuls (see matmul_f32).
  a16, b16, g16 = jax.lax.optimization_barrier((a16, b16, g16))
  da = jnp.dot(g16, b16.T, preferred_element_type=jnp.float32)
  db = jnp.dot(a16.T, g16, preferred_element_type=jnp.float32)
  return da.astype(jnp.float32), db.astype(jnp.float32)


matmul_bf16.defvjp(_fwd, _bwd)


@jax.custom_vjp
def matmul_f32(a, b):
  """a @ b (f32) whose backward dots are fenced from producer fusion.

  An `optimization_barrier` on the backward operands forces their
  materialization, so XLA emits the weight-gradient contraction as a real
  matmul rather than fusing it into its elementwise producer chain as a
  multiply+reduce. Whether the fence pays on the H100 is not measured yet.
  """
  return jnp.dot(a, b, preferred_element_type=jnp.float32)


def _f32_fwd(a, b):
  return jnp.dot(a, b, preferred_element_type=jnp.float32), (a, b)


def _f32_bwd(res, g):
  a, b = res
  a, b, g = jax.lax.optimization_barrier((a, b, g))
  da = jnp.dot(g, b.T, preferred_element_type=jnp.float32)
  db = jnp.dot(a.T, g, preferred_element_type=jnp.float32)
  return da, db


matmul_f32.defvjp(_f32_fwd, _f32_bwd)


@jax.custom_vjp
def matmul_highest(a, b):
  """a @ b with Precision.HIGHEST (exact f32 arithmetic).

  Same fusion fence on the backward dots as `matmul_f32`.
  """
  return jnp.dot(
      a, b, precision=jax.lax.Precision.HIGHEST,
      preferred_element_type=jnp.float32,
  )


def _hi_fwd(a, b):
  out = jnp.dot(
      a, b, precision=jax.lax.Precision.HIGHEST,
      preferred_element_type=jnp.float32,
  )
  return out, (a, b)


def _hi_bwd(res, g):
  a, b = res
  a, b, g = jax.lax.optimization_barrier((a, b, g))
  da = jnp.dot(
      g, b.T, precision=jax.lax.Precision.HIGHEST,
      preferred_element_type=jnp.float32,
  )
  db = jnp.dot(
      a.T, g, precision=jax.lax.Precision.HIGHEST,
      preferred_element_type=jnp.float32,
  )
  return da, db


matmul_highest.defvjp(_hi_fwd, _hi_bwd)
