"""Which formulation a search uses when the caller leaves it to ``auto``.

Every scan in this package is plain XLA.  Where two equivalent formulations
exist (a tile-by-tile dequantize-and-matmul ``chunked`` scan, or one
integer matmul against the raw codes with the dequantization folded into
the query), the choice depends on the platform and is made here, and only
here.  The platforms are the ones XLA builds this package for: ``cpu`` and
``gpu``.  Any other platform raises, so a new one is a decision, not a
silent default.
"""

from __future__ import annotations

import jax

# Scan modes each codec offers (quant/scalar.py, quant/int4.py).
SCAN_MODES = {
    "int8": ("int8mm", "chunked"),
    "int4": ("int4mm", "chunked"),
}

# The default scan mode of each codec, per platform.  On an H100 80GB HBM3
# (700 W), chip_smoke.py's kernels phase over 1M x 768 codes, cosine, at
# B=1024, timed the folded integer matmul 5x faster than the chunked float
# scan (int8: 8.18 vs 44.4 ms; int4: 8.52 vs 44.2 ms); the CPU keeps the
# chunked scan.  Selection is always exact (``lax.top_k``): on the GPU
# ``lax.approx_max_k`` lowers to the same TopK call (15.51 vs 15.56 ms on a
# (1024, 2^20) block, recall 1.0), so an approximate default buys nothing.
_CHOICES = {
    "cpu": {"int8": "chunked", "int4": "chunked"},
    "gpu": {"int8": "int8mm", "int4": "int4mm"},
}


def platform() -> str:
    """The platform JAX computes on: ``"cpu"`` or ``"gpu"``."""
    p = jax.default_backend()
    if p not in _CHOICES:
        raise RuntimeError(
            f"unsupported JAX platform {p!r}: this package is built for "
            f"{sorted(_CHOICES)}")
    return p


def scan_mode(codec: str, mode: str = "auto", on: str | None = None) -> str:
    """Resolve a codec's scan ``mode``; ``auto`` picks the platform's
    default (``on`` overrides the detected platform).  An unknown mode
    raises ``ValueError``."""
    if codec not in SCAN_MODES:
        raise ValueError(f"unknown codec {codec!r}")
    if mode == "auto":
        return _CHOICES[on or platform()][codec]
    if mode not in SCAN_MODES[codec]:
        raise ValueError(
            f"unknown {codec} scan mode {mode!r}; expected 'auto' or one of "
            f"{SCAN_MODES[codec]}")
    return mode

