"""Write-ahead-log durability + container CRC tests."""

import numpy as np
import pytest

from fastpyvectordb_jax import Collection, CollectionConfig
from fastpyvectordb_jax.persist.format import load_container, save_container
from fastpyvectordb_jax.persist.wal import (OP_DELETE, OP_INSERT,
                                            WriteAheadLog)


def wal_col(path, **kw):
    return Collection(CollectionConfig(name="w", dimensions=8,
                                       durability="wal", **kw),
                      base_path=path)


def test_mutations_survive_without_save(tmp_path):
    p = tmp_path / "c1"
    col = wal_col(p)
    v = np.eye(8, dtype=np.float32)
    col.insert_batch(v[:4], ["a", "b", "c", "d"],
                     [{"i": i} for i in range(4)])
    col.delete("b")
    col.update_metadata("c", {"j": 9})
    col._wal.close()  # simulate crash: NO save()

    col2 = wal_col(p)
    assert col2.count() == 3
    assert col2.get("b") is None
    assert col2.get("c")["metadata"] == {"i": 2, "j": 9}
    hits = col2.search(v[0], k=1)
    assert hits[0].id == "a"


def test_save_truncates_log(tmp_path):
    p = tmp_path / "c2"
    col = wal_col(p)
    col.insert_batch(np.random.rand(16, 8).astype(np.float32),
                     [f"v{i}" for i in range(16)])
    assert col._wal.size_bytes() > 0
    col.save()
    assert col._wal.size_bytes() == 0
    col2 = wal_col(p)
    assert col2.count() == 16


def test_replay_is_idempotent_after_partial_save(tmp_path):
    # crash between snapshot rename and log truncation: log still holds
    # records the snapshot already covers -> replay must converge, not raise
    p = tmp_path / "c3"
    col = wal_col(p)
    v = np.random.rand(6, 8).astype(np.float32)
    col.insert_batch(v, [f"v{i}" for i in range(6)])
    # snapshot WITHOUT truncating the log (simulated torn save)
    wal = col._wal
    col._wal = None
    col.save()
    col._wal = wal
    col._wal.close()

    col2 = wal_col(p)
    assert col2.count() == 6
    assert sorted(col2.all_ids()) == sorted(f"v{i}" for i in range(6))


def test_torn_tail_record_is_discarded(tmp_path):
    p = tmp_path / "c4"
    col = wal_col(p)
    v = np.random.rand(4, 8).astype(np.float32)
    col.insert_batch(v[:2], ["a", "b"])
    col.insert_batch(v[2:], ["c", "d"])
    col._wal.close()
    # tear the last record mid-payload
    log = p / "wal.log"
    raw = log.read_bytes()
    log.write_bytes(raw[:-7])

    col2 = wal_col(p)
    assert sorted(col2.all_ids()) == ["a", "b"]  # prefix-consistent
    # the torn suffix was clipped; further appends extend a clean log
    col2.insert(v[2], id="c2")
    col2._wal.close()
    col3 = wal_col(p)
    assert sorted(col3.all_ids()) == ["a", "b", "c2"]


def test_wal_raw_framing_roundtrip(tmp_path):
    w = WriteAheadLog(tmp_path / "x.log")
    vecs = np.arange(12, dtype=np.float32).reshape(2, 6)
    w.log_insert(["p", "q"], [None, {"z": 1}], vecs)
    w.log_delete(["p"])
    recs = list(w.replay())
    assert [r[0] for r in recs] == [OP_INSERT, OP_DELETE]
    np.testing.assert_array_equal(recs[0][2], vecs)
    assert recs[0][1]["metadatas"] == [None, {"z": 1}]
    assert recs[1][1]["ids"] == ["p"]
    w.close()


def test_container_crc_verify(tmp_path):
    p = tmp_path / "c.fpvt"
    save_container(p, {"arr": np.arange(64, dtype=np.float32),
                       "doc": {"a": 1}})
    c = load_container(p)
    assert c.verify()
    # flip one payload byte -> verify must name the corruption
    raw = bytearray(p.read_bytes())
    off = c._data_start + c.sections["arr"]["offset"] + 5
    raw[off] ^= 0xFF
    p.write_bytes(bytes(raw))
    c2 = load_container(p)
    with pytest.raises(ValueError, match="CRC32"):
        c2.verify()


def test_snapshot_mode_unaffected(tmp_path):
    col = Collection(CollectionConfig(name="s", dimensions=8),
                     base_path=tmp_path / "s")
    col.insert(np.ones(8, np.float32), id="x")
    assert col._wal is None
    assert not (tmp_path / "s" / "wal.log").exists()


def test_enable_wal_on_existing_snapshot_collection(tmp_path):
    # a collection saved with durability="snapshot" must honor a later
    # constructor request for WAL (runtime preference beats the snapshot)
    p = tmp_path / "c5"
    col = Collection(CollectionConfig(name="w", dimensions=8), base_path=p)
    col.insert(np.ones(8, np.float32), id="a")
    col.save()
    col2 = wal_col(p)
    assert col2._wal is not None
    col2.insert(np.zeros(8, np.float32), id="b")
    col2._wal.close()  # crash without save
    col3 = wal_col(p)
    assert sorted(col3.all_ids()) == ["a", "b"]


def test_zero_row_insert_does_not_poison_log(tmp_path):
    p = tmp_path / "c6"
    col = wal_col(p)
    col.insert_batch(np.zeros((0, 8), np.float32))  # accepted, no-op
    col.insert(np.ones(8, np.float32), id="x")
    col._wal.close()
    col2 = wal_col(p)  # must not raise on replay
    assert col2.all_ids() == ["x"]


def test_numpy_metadata_survives_replay_numerically(tmp_path):
    from fastpyvectordb_jax import Filter
    p = tmp_path / "c7"
    col = wal_col(p)
    col.insert(np.ones(8, np.float32), id="n",
               metadata={"score": np.float64(2.5), "count": np.int64(7)})
    col._wal.close()
    col2 = wal_col(p)
    hits = col2.search(np.ones(8, np.float32), k=1,
                       filter=Filter.gt("score", 2.0))
    assert hits and hits[0].id == "n"  # numeric comparison still works


def test_wal_zero_filled_torn_tail(tmp_path):
    """A crash that extends the log with zeros (delayed allocation) must
    clip the tail, not crash replay: rlen=0/crc=0 passes the CRC check
    because crc32(b'') == 0."""
    import numpy as np
    from fastpyvectordb_jax.persist.wal import OP_INSERT, WriteAheadLog
    p = tmp_path / "t.wal"
    wal = WriteAheadLog(p)
    wal.log_insert(["a"], [{}], np.ones((1, 4), np.float32))
    wal.close()
    size = p.stat().st_size
    with open(p, "ab") as f:
        f.write(b"\x00" * 64)  # zero-filled torn tail
    wal2 = WriteAheadLog(p)
    recs = list(wal2.replay())
    assert len(recs) == 1 and recs[0][0] == OP_INSERT
    assert p.stat().st_size == size  # tail clipped back to the intact record
    wal2.close()


def test_vectordb_restart_replays_wal_and_keeps_durability(tmp_path):
    """VectorDB reload must reconstruct WAL durability from the config
    sidecar: logged-but-unsnapshotted writes survive a restart, and the
    reloaded collection keeps logging."""
    import numpy as np
    from fastpyvectordb_jax import VectorDB
    db = VectorDB(str(tmp_path))
    col = db.create_collection("w", 8, durability="wal")
    col.insert(np.ones(8, np.float32), "a")
    # no save(): the row lives only in the WAL
    db2 = VectorDB(str(tmp_path))
    assert "w" in db2.list_collections()
    col2 = db2.get_collection("w")
    assert col2.count() == 1 and col2.get("a") is not None
    assert col2.config.durability == "wal" and col2._wal is not None
    col2.insert(np.zeros(8, np.float32), "b")  # must be logged too
    db3 = VectorDB(str(tmp_path))
    assert db3.get_collection("w").count() == 2
