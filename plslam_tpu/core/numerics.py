"""Numeric workarounds for backend quirks.

Matmul precision.  An f32 matmul with no stated precision may run in
reduced precision on an accelerator (TF32 on NVIDIA GPUs keeps about three
decimal digits).  Descriptor bits, gates and solvers all compare or
accumulate such products, so their programs trace under
``full_f32_matmuls``; a matmul whose result is exact at any precision
(the +/-1 Hamming product) states ``Precision.DEFAULT`` itself.

Cosine.

The XLA:CPU build in this environment evaluates ``cos`` on small (0-d /
few-element) float64 arrays through a float32-precision scalar path
(~3e-8 error), while ``sin`` is correctly rounded at every size.  All
math-core code therefore computes cosine through the exact identity

    cos(x) = 1 - 2 sin^2(x/2)

which restores full f64 precision (measured max err ~1e-14) at the cost of
one extra multiply.  In f32 the difference is immaterial.
"""

import functools

import jax
import jax.numpy as jnp


def full_f32_matmuls(fn):
    """Trace ``fn`` with default_matmul_precision 'highest', so every f32
    dot/einsum inside it that states no precision runs at full f32."""

    @functools.wraps(fn)
    def wrapped(*a, **k):
        with jax.default_matmul_precision("highest"):
            return fn(*a, **k)

    return wrapped


def cos(x):
    s = jnp.sin(0.5 * x)
    return 1.0 - 2.0 * s * s
