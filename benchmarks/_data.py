"""Shared benchmark corpora.

Quantizers and ANN indexes exploit structure; pure Gaussian noise is the
degenerate worst case for both (every neighbor list is spread uniformly
over cells).  The reference's own recall claims are on structured data
(README.md:504-508), so recall-bearing benchmarks use a clustered corpus:
1024 centers at 2x scale + unit noise, queries near centers.

The draws are made with ``jax.random`` on the default device, chunk by
chunk, and returned as host arrays: a 1M x 768 corpus takes seconds
instead of the better part of a minute of single-threaded NumPy.
"""

import numpy as np

N_CENTERS = 1024


def clustered_corpus(n: int, d: int, seed: int = 0, normalize: bool = True,
                     chunk: int = 262_144):
    """(n, d) float32 rows around ``N_CENTERS`` centers, and the centers."""
    import jax
    import jax.numpy as jnp

    kc, kr = jax.random.split(jax.random.PRNGKey(seed))
    centers = 2.0 * jax.random.normal(kc, (N_CENTERS, d), jnp.float32)

    @jax.jit
    def draw(key):
        ka, kn = jax.random.split(key)
        assign = jax.random.randint(ka, (chunk,), 0, N_CENTERS)
        x = centers[assign] + jax.random.normal(kn, (chunk, d), jnp.float32)
        if normalize:
            x = x / jnp.linalg.norm(x, axis=1, keepdims=True)
        return x

    out = np.empty((n, d), np.float32)
    for i, s in enumerate(range(0, n, chunk)):
        e = min(s + chunk, n)
        out[s:e] = np.asarray(draw(jax.random.fold_in(kr, i)))[:e - s]
    return out, np.asarray(centers)


def clustered_queries(centers: np.ndarray, b: int, seed: int = 1,
                      noise: float = 0.5):
    """(b, d) float32 queries near randomly chosen centers."""
    rng = np.random.default_rng(seed)
    q = centers[rng.integers(0, centers.shape[0], b)] + \
        noise * rng.standard_normal((b, centers.shape[1])).astype(np.float32)
    return np.ascontiguousarray(q, dtype=np.float32)
