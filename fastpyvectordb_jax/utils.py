"""Small shared utilities with no better home.

(Not an alias namespace: the former ``ops``/``models``/``parallel``
re-export shims were removed — import from the canonical packages
``fastpyvectordb_jax.kernels``, ``.ann``, ``.quant``, ``.dist``,
``.persist`` and ``.core.outofcore`` directly.)
"""


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n <= 1 -> 1).  The single shared
    implementation behind store capacity buckets, IVF chunk sizing, and
    quantized-scan chunking."""
    p = 1
    while p < n:
        p <<= 1
    return p
