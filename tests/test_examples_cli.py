"""The retrieval-quality and RAG CLI examples must run end-to-end offline
(the examples are the behavioral spec; SURVEY §2.13)."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "examples"))


def test_retrieval_quality_noninteractive(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["retrieval_quality.py"])
    import runpy
    runpy.run_path(str(REPO / "examples" / "retrieval_quality.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "RETRIEVAL TESTS" in out
    assert "retrieval accuracy:" in out
    # the hashing embedder clears at least 4/6 on this corpus
    import re
    m = re.search(r"retrieval accuracy: (\d+)/(\d+)", out)
    assert m and int(m.group(1)) >= 4
    assert "FILTERED RETRIEVAL" in out
    assert "category=Cooking" in out


def test_rag_cli_sample_ask_persist(tmp_path, capsys, monkeypatch):
    # the LLM path must not fire in tests even if a key is in the env
    monkeypatch.delenv("ANTHROPIC_API_KEY", raising=False)
    import rag_cli
    db = str(tmp_path / "ragdb")
    rag_cli.main(["sample", "--db", db])
    out1 = capsys.readouterr().out
    assert "ingested" in out1
    # fresh invocation reloads the persisted index from disk
    rag_cli.main(["ask", "what are the tensor cores for?", "--db", db])
    out2 = capsys.readouterr().out
    assert "retrieved:" in out2
    assert "gpu.md#0" in out2
    assert "extractive answer" in out2


def test_rag_cli_reingest_replaces(tmp_path, capsys):
    import rag_cli
    db = str(tmp_path / "ragdb2")
    rag_cli.main(["sample", "--db", db])
    before = capsys.readouterr().out
    rag_cli.main(["sample", "--db", db])  # same docs again: no duplicates
    capsys.readouterr()
    store = rag_cli.RagStore(db)
    n = store.col.count()
    import re
    m = re.search(r"ingested (\d+) chunks", before)
    assert n == int(m.group(1))


def test_rag_chunker_overlap():
    from rag_cli import chunk_text
    text = " ".join(f"word{i}" for i in range(200))
    chunks = chunk_text(text, size=120, overlap=30)
    assert len(chunks) > 2
    # consecutive chunks share their boundary words (the overlap tail)
    for a, b in zip(chunks, chunks[1:]):
        assert a.split()[-1] in b.split()[:8]
    # nothing lost: every word appears somewhere
    joined = set(" ".join(chunks).split())
    assert all(f"word{i}" in joined for i in range(200))


def test_production_ops_example(capsys, monkeypatch):
    """The ops walkthrough (WAL / CRC / IVF-PQ / tune_rerank / router)
    must run end-to-end offline."""
    monkeypatch.setattr(sys, "argv", ["production_ops.py"])
    import runpy
    runpy.run_path(str(REPO / "examples" / "production_ops.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "recovered 99 rows" in out
    assert "corrupted file detected" in out
    assert "All production-ops demos passed." in out


def test_prime_tool_small(tmp_path, capsys):
    from fastpyvectordb_jax.prime import main as prime_main
    prime_main(["--dims", "16", "--rows", "512", "--max-batch", "16",
                "--modes", "exact", "--k", "5",
                "--cache", str(tmp_path / "cache")])
    out = capsys.readouterr().out
    assert '"done": true' in out and '"batch_bucket": 16' in out

def test_demo_tour_selected(capsys, monkeypatch):
    """The guided tour's fast sections (catalog filters, graph traversal,
    hybrid fusion, persistence) run end-to-end offline with their inline
    sanity assertions."""
    monkeypatch.setattr(sys, "argv", ["demo.py", "1", "2", "3", "6"])
    import runpy
    runpy.run_path(str(REPO / "examples" / "demo.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "Filtered search: footwear under $100" in out
    assert "shortest path alice -> diana" in out
    assert "ALL 4 DEMOS COMPLETE" in out


def test_hybrid_demo_comparison(capsys, monkeypatch):
    """The hybrid comparison demo proves each retrieval mode wins its
    predicted query class (its sanity() asserts that mechanically)."""
    monkeypatch.setattr(sys, "argv", ["hybrid_demo.py"])
    import runpy
    runpy.run_path(str(REPO / "examples" / "hybrid_demo.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "sanity checks passed" in out
    assert "KEY INSIGHTS" in out


def test_rag_app_demo(capsys, monkeypatch):
    """The full RAG application (synthetic corpus, multi-method search,
    graph expansion, in-app benchmark) runs end-to-end offline."""
    monkeypatch.setattr(sys, "argv", ["rag_app.py", "--docs", "200"])
    import runpy
    runpy.run_path(str(REPO / "examples" / "rag_app.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "Graph-expanded retrieval" in out
    assert "expanded" in out
    assert "mean_ms" in out
    assert "DEMO COMPLETE" in out
