"""Fused elementwise pipelines with sm.fuse.

The BASELINE configs[1] workload — a broadcast + pow + exp chain — as ONE
program.  Chained sm ops dispatched one by one each cost a full pass over
device memory (like the reference's one-OpenMP-pass-per-op engine,
include/math/calculate.h); ``sm.fuse`` composes their tile functions into
one function that XLA compiles as one fusion.

Run: python examples/fused_pipeline.py  (any backend)
"""

import jax
import jax.numpy as jnp

import simplemath_tpu as sm
from simplemath_tpu.ops import dispatch

n = 512
key_a, key_e = jax.random.split(jax.random.PRNGKey(0))
a = sm.Array(jax.random.uniform(key_a, (n, n), jnp.float32, 0.5, 2.0))
e_row = sm.Array(jax.random.uniform(key_e, (1, n), jnp.float32, -2.0, 2.0))

# One fused program: the (1, n) exponent row is read with stride 0 — it is
# never materialized at (n, n).
pipeline = sm.fuse(lambda x, e: sm.exp(sm.pow(x, e)))

dispatch.reset()
y = pipeline(a, e_row)
print("programs:", {k: v for k, v in dispatch.counts().items()
                    if k.startswith("elementwise")})   # {'elementwise:fused': 1}

# The same chain WITHOUT sm.fuse: the deferred-eager queue (ops/lazy.py)
# records the two eager calls and flushes them as one program at
# materialization.
dispatch.reset()
y_chain = sm.exp(sm.pow(a, e_row))
print("eager-chain programs before materialization:",
      {k: v for k, v in dispatch.counts().items()
       if k.startswith("elementwise")})                # {} — nothing ran yet
val = y_chain.jax()                                     # flush: ONE program
print("eager-chain programs after materialization:",
      {k: v for k, v in dispatch.counts().items()
       if k.startswith("elementwise")})                # {'elementwise:fused': 1}

print("max |fused - chain| =", float(jnp.max(jnp.abs(y.jax() - val))))

# Iterated recurrences: on a GPU one Triton kernel keeps the carry in
# registers for all 50 iterations (elsewhere an XLA fori_loop).
ema = sm.fuse(lambda acc, x: acc * 0.9 + sm.square(x), iterations=50)
dispatch.reset()
z = ema(sm.zeros(n, n), a)
print("50-iteration recurrence route:", dispatch.counts())  # fuse_loop:*
print("ema[0,0] =", float(z[0, 0].jax()))
