"""chip_smoke.py's phases at a tiny size on the CPU: the same control
flow, checks and reference as the card run, with the row count, batch and
IVF probing shrunk (the 4096-row clustered corpus needs nprobe near nlist
for the IVF recall bar).  Times printed here are CPU times and are not
read as device numbers."""

import contextlib
import dataclasses
import io
import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = dataclasses.replace(
    cs.FULL, n=4096, d=128, batch=64, n_check=16, insert_chunk=1024,
    nlist=16, nprobe=14, n_writes=20, reps=1, kernel_batches=(64, 8),
    pq_m=16, pq_k=256)
TINY_FOUR = dataclasses.replace(TINY, n=8192, nlist=32)


def _rows(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def one_card(tmp_path_factory):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dev = cs.run_one_card(TINY, require_gpu=False, gpu_tests=False,
                              data_dir=tmp_path_factory.mktemp("smoke"))
    return dev, _rows(buf.getvalue())


@pytest.mark.parametrize("phase,count", [
    ("device", 1), ("data", 1), ("load", 2), ("exact", 2), ("filtered", 4),
    ("int8", 1), ("ivf", 1), ("writes", 1), ("memory", 1)])
def test_phase_runs_and_checks(one_card, phase, count):
    _, rows = one_card
    got = [r for r in rows if r["phase"] == phase]
    assert len(got) == count
    for r in got:
        if "recall_at_10" in r:
            assert r["recall_at_10"] >= r["tol"]["recall"]
            assert r["max_dist_err"] <= r["tol"]["dist_err"]


def test_kernels_phase_covers_every_removed_kernel(one_card):
    _, rows = one_card
    names = {r["kernel"] for r in rows if r["phase"] == "kernels"}
    for b in TINY.kernel_batches:
        for k in ("int8mm", "int8_chunked", "int4mm", "int4_chunked",
                  "hamming", "grouped_bf16", "grouped_int8",
                  f"grouped_pq_k{TINY.pq_k}"):
            assert f"{k}_b{b}" in names
    assert {f"top_k_b{TINY.batch}", f"approx_max_k_b{TINY.batch}",
            "selection_verdict"} <= names
    # a CPU run never writes a device metric
    assert all(r.get("roofline_share", "not measured") == "not measured"
               for r in rows if r["phase"] == "kernels")


def test_one_card_result_names_the_device(one_card):
    dev, _ = one_card
    assert dev["platform"] == "cpu" and dev["count"] >= 1


def test_compare_fails_outside_tolerance():
    import numpy as np
    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    ref = cs.Reference(x)
    d, r = ref.topk(q, cs.K)
    ids = np.vectorize(lambda i: f"v{i}", otypes=[object])(r)
    ok = cs.compare(ref, q, ids, d, cs.TOL["float32"])
    assert ok["recall_at_10"] == 1.0
    with pytest.raises(cs.PhaseFailed):
        cs.compare(ref, q, ids, d + 1e-3, cs.TOL["float32"])
    wrong = np.vectorize(lambda i: f"v{(i + 1) % 200}", otypes=[object])(r)
    with pytest.raises(cs.PhaseFailed):
        cs.compare(ref, q, wrong, d, cs.TOL["float32"])


def test_four_device_path_on_virtual_cpu_devices():
    """The --four path on four of the suite's virtual CPU devices: sharded
    exact equals the single-device result, int8/IVF meet the reference,
    the Lloyd step matches, and every shard sits on its own device."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dev = cs.run_four_cards(TINY_FOUR, require_gpu=False, n_devices=4)
    rows = _rows(buf.getvalue())
    phases = [r["phase"] for r in rows]
    for p in ("sharded_exact", "sharded_int8", "sharded_ivf",
              "sharded_kmeans"):
        assert p in phases
    assert dev["count"] == 4
    ex = next(r for r in rows if r["phase"] == "sharded_exact")
    assert ex["differing_hits"] == 0.0
