"""Published peak rates of the devices this repository is measured on.

A roofline share is the least time the device could take for an
operation, ``max(flops / peak_flops, bytes / peak_bytes_per_s)``, divided
by the measured time.  Peaks are keyed by JAX's ``device_kind``; a device
that is not in the table is an error, never a default, so that no number
is ever divided by another card's peak.

Dense rates without sparsity.  They assume the card's full power limit
(700 W for the H100 SXM); a card capped below it cannot hold its top clock
under a matrix-heavy load, so report its ``power.limit`` beside any share.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "source": "NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5 "
                  "column (dense, no sparsity)",
        "flops": {                 # operations per second
            "bfloat16": 989e12,
            "float16": 989e12,
            "float8": 1979e12,
            "int8": 1979e12,
            "tf32": 495e12,
            "float32": 67e12,      # outside the tensor cores
        },
        "hbm_bytes_per_s": 3.35e12,
        "hbm_bytes": 80e9,
        "nvlink_bytes_per_s_each_way": 450e9,
    },
}


def peaks(device_kind: str) -> dict:
    """The peak table of ``device_kind``; raises ``KeyError`` if unknown."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"benchmarks/peaks.py with its source") from None


def roofline(device_kind: str, seconds: float, *, flops: float = 0.0,
             flops_dtype: str = "bfloat16", bytes_moved: float = 0.0
             ) -> dict:
    """Roofline share of an operation that took ``seconds``: which bound
    (compute or memory) limits it, the least time that bound allows, and
    the share of it the measurement reached."""
    p = peaks(device_kind)
    t_flops = flops / p["flops"][flops_dtype] if flops else 0.0
    t_bytes = bytes_moved / p["hbm_bytes_per_s"]
    bound = "compute" if t_flops >= t_bytes else "memory"
    t_min = max(t_flops, t_bytes)
    return {"bound": bound, "t_min_s": t_min,
            "roofline_share": t_min / seconds if seconds > 0 else 0.0,
            "flops": flops, "flops_dtype": flops_dtype,
            "bytes": bytes_moved}
