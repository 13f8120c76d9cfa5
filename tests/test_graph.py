"""GraphDB tests: CRUD + index maintenance + traversal + Cypher +
persistence (parity: reference test_comprehensive.py suites 2)."""

import pytest

from fastpyvectordb_jax.graphdb import GraphDB


@pytest.fixture()
def g():
    g = GraphDB()
    alice = g.create_node(["Person"], {"name": "Alice", "age": 34}, id="alice")
    bob = g.create_node(["Person"], {"name": "Bob", "age": 28}, id="bob")
    carol = g.create_node(["Person", "Admin"], {"name": "Carol", "age": 45},
                          id="carol")
    acme = g.create_node(["Company"], {"name": "Acme"}, id="acme")
    g.create_edge("alice", "bob", "KNOWS", {"since": 2019})
    g.create_edge("bob", "carol", "KNOWS")
    g.create_edge("alice", "acme", "WORKS_AT", {"role": "eng"})
    g.create_edge("carol", "acme", "WORKS_AT")
    return g


class TestCRUD:
    def test_create_and_get(self, g):
        n = g.get_node("alice")
        assert n.properties["name"] == "Alice" and "Person" in n.labels
        assert g.stats()["nodes"] == 4 and g.stats()["edges"] == 4

    def test_duplicate_node_rejected(self, g):
        with pytest.raises(ValueError):
            g.create_node(id="alice")

    def test_edge_requires_nodes(self, g):
        with pytest.raises(ValueError):
            g.create_edge("alice", "ghost", "KNOWS")

    def test_update_node_reindexes(self, g):
        g.update_node("bob", {"age": 29})
        assert [n.id for n in g.find_nodes(properties={"age": 29})] == ["bob"]
        assert g.find_nodes(properties={"age": 28}) == []

    def test_label_add_remove(self, g):
        g.update_node("bob", add_labels=["Admin"])
        assert {n.id for n in g.find_nodes(label="Admin")} == {"bob", "carol"}
        g.update_node("bob", remove_labels=["Admin"])
        assert {n.id for n in g.find_nodes(label="Admin")} == {"carol"}

    def test_delete_node_cascades(self, g):
        g.create_hyperedge(["alice", "bob", "carol"], "TEAM")
        assert g.delete_node("bob")
        assert g.get_edge_count() == 2 if hasattr(g, "get_edge_count") else True
        assert g.stats()["edges"] == 2  # bob's two KNOWS edges removed
        h = g.hyperedges_of_nodes(["alice"])
        assert len(h) == 1 and "bob" not in h[0].nodes

    def test_delete_node_with_small_hyperedge(self, g):
        g.create_hyperedge(["alice", "bob"], "PAIR")
        g.delete_node("bob")
        assert g.hyperedges_of_nodes(["alice"]) == []


class TestQueries:
    def test_find_by_label(self, g):
        assert {n.id for n in g.find_nodes(label="Person")} == \
            {"alice", "bob", "carol"}

    def test_find_by_label_and_property(self, g):
        out = g.find_nodes(label="Person", properties={"name": "Carol"})
        assert [n.id for n in out] == ["carol"]

    def test_find_no_criteria_returns_all(self, g):
        assert len(g.find_nodes()) == 4

    def test_range_query(self, g):
        out = g.find_nodes_in_range("age", min_value=30, max_value=50)
        assert {n.id for n in out} == {"alice", "carol"}
        out = g.find_nodes_in_range("age", min_value=30, label="Admin")
        assert {n.id for n in out} == {"carol"}

    def test_edges_of_type(self, g):
        assert len(g.edges_of_type("WORKS_AT")) == 2

    def test_hyperedge_any_all(self, g):
        g.create_hyperedge(["alice", "bob"], "T1")
        g.create_hyperedge(["bob", "carol"], "T2")
        assert len(g.hyperedges_of_nodes(["alice", "carol"], "any")) == 2
        assert len(g.hyperedges_of_nodes(["alice", "bob"], "all")) == 1


class TestTraversal:
    def test_neighbors_direction(self, g):
        assert {n.id for n in g.neighbors("alice", "out")} == {"bob", "acme"}
        assert {n.id for n in g.neighbors("bob", "in")} == {"alice"}
        assert {n.id for n in g.neighbors("bob", "both")} == {"alice", "carol"}

    def test_neighbors_edge_type(self, g):
        assert {n.id for n in g.neighbors("alice", "out", "WORKS_AT")} == \
            {"acme"}

    def test_traverse_paths(self, g):
        paths = g.traverse("alice", max_depth=2, edge_type="KNOWS")
        assert ["alice", "bob"] in paths
        assert ["alice", "bob", "carol"] in paths

    def test_shortest_path(self, g):
        assert g.shortest_path("alice", "carol", edge_type="KNOWS") == \
            ["alice", "bob", "carol"]
        assert g.shortest_path("alice", "alice") == ["alice"]
        g2 = GraphDB()
        g2.create_node(id="x")
        g2.create_node(id="y")
        assert g2.shortest_path("x", "y") is None


class TestCypher:
    def test_match_label(self, g):
        rows = g.query("MATCH (n:Person) RETURN n.name")
        assert sorted(r["n.name"] for r in rows) == ["Alice", "Bob", "Carol"]

    def test_match_props_inline(self, g):
        rows = g.query("MATCH (n:Person {name: 'Alice'}) RETURN n")
        assert len(rows) == 1 and rows[0]["n"]["id"] == "alice"

    def test_where_ops(self, g):
        rows = g.query("MATCH (n:Person) WHERE n.age > 30 RETURN n.name")
        assert sorted(r["n.name"] for r in rows) == ["Alice", "Carol"]
        rows = g.query(
            "MATCH (n:Person) WHERE n.age >= 28 AND n.age <> 45 RETURN n.name")
        assert sorted(r["n.name"] for r in rows) == ["Alice", "Bob"]

    def test_one_hop(self, g):
        rows = g.query("MATCH (a:Person)-[:WORKS_AT]->(c:Company) "
                       "RETURN a.name, c.name")
        assert sorted((r["a.name"], r["c.name"]) for r in rows) == \
            [("Alice", "Acme"), ("Carol", "Acme")]

    def test_incoming_hop(self, g):
        rows = g.query("MATCH (c:Company)<-[:WORKS_AT]-(a:Person) "
                       "RETURN a.name")
        assert sorted(r["a.name"] for r in rows) == ["Alice", "Carol"]

    def test_variable_length(self, g):
        rows = g.query("MATCH (a:Person {name: 'Alice'})-[:KNOWS*1..2]->(b) "
                       "RETURN b.name")
        assert sorted(r["b.name"] for r in rows) == ["Bob", "Carol"]

    def test_limit(self, g):
        rows = g.query("MATCH (n:Person) RETURN n.name LIMIT 2")
        assert len(rows) == 2

    def test_parse_error(self, g):
        from fastpyvectordb_jax.graphdb import CypherError
        with pytest.raises(CypherError):
            g.query("SELECT * FROM nodes")


def test_persistence_roundtrip(tmp_path):
    g = GraphDB(str(tmp_path))
    g.create_node(["A"], {"x": 1}, id="n1")
    g.create_node(["B"], {"x": 2}, id="n2")
    g.create_edge("n1", "n2", "REL", {"w": 0.5})
    g.create_hyperedge(["n1", "n2"], "H")
    g.save()

    g2 = GraphDB(str(tmp_path))
    assert g2.stats() == g.stats()
    assert g2.get_node("n1").properties == {"x": 1}
    assert [n.id for n in g2.find_nodes(label="B")] == ["n2"]
    assert [n.id for n in g2.neighbors("n1", "out")] == ["n2"]
    assert len(g2.hyperedges_of_nodes(["n1"])) == 1


def test_builders():
    g = GraphDB()
    n = g.node().id("x").label("L1", "L2").property("a", 1).create()
    m = g.node().properties(b=2).create()
    e = g.edge().from_node(n.id).to_node(m.id).type("R").property(
        "w", 1.0).create()
    h = g.hyperedge().nodes(n.id, m.id).type("H").create()
    assert n.labels == {"L1", "L2"} and e.properties["w"] == 1.0
    assert len(h.nodes) == 2
    with pytest.raises(ValueError):
        g.edge().from_node(n.id).create()


class TestNativeTraversal:
    def test_khop_native_matches_python(self, g):
        from fastpyvectordb_jax import native
        if not native.graph_available():
            pytest.skip("no C++ toolchain")
        py = sorted(g.khop_nodes(["alice"], 2, use_native=False))
        nat = sorted(g.khop_nodes(["alice"], 2, use_native=True))
        assert py == nat
        assert ("alice", 0) in nat and any(h == 2 for _, h in nat)
        # direction + edge-type filters
        py = sorted(g.khop_nodes(["alice"], 2, direction="out",
                                 edge_type="KNOWS", use_native=False))
        nat = sorted(g.khop_nodes(["alice"], 2, direction="out",
                                  edge_type="KNOWS", use_native=True))
        assert py == nat == [("alice", 0), ("bob", 1), ("carol", 2)]

    def test_native_shortest_path_on_large_graph(self):
        from fastpyvectordb_jax import native
        import fastpyvectordb_jax.graphdb.graph as gmod
        if not native.graph_available():
            pytest.skip("no C++ toolchain")
        g = GraphDB()
        # chain of 500 nodes -> force the native path via threshold patch
        for i in range(500):
            g.create_node(id=f"n{i}")
        for i in range(499):
            g.create_edge(f"n{i}", f"n{i+1}", "NEXT")
        old = gmod.NATIVE_TRAVERSAL_THRESHOLD
        gmod.NATIVE_TRAVERSAL_THRESHOLD = 1
        try:
            path = g.shortest_path("n0", "n499")
            assert path[0] == "n0" and path[-1] == "n499"
            assert len(path) == 500
            # mutation invalidates the CSR snapshot
            g.create_edge("n0", "n499", "SHORTCUT")
            assert g.shortest_path("n0", "n499") == ["n0", "n499"]
        finally:
            gmod.NATIVE_TRAVERSAL_THRESHOLD = old


def test_cypher_quoted_commas_and_and():
    from fastpyvectordb_jax.graphdb import GraphDB
    g = GraphDB()
    g.create_node(["Song"], {"title": "Rock AND Roll", "tag": "x, y"},
                  id="s1")
    g.create_node(["Song"], {"title": "Quiet", "tag": "z"}, id="s2")
    rows = g.query('MATCH (n:Song {tag: "x, y"}) RETURN n.title')
    assert [r["n.title"] for r in rows] == ["Rock AND Roll"]
    rows = g.query(
        "MATCH (n:Song) WHERE n.title = 'Rock AND Roll' RETURN n.title")
    assert [r["n.title"] for r in rows] == ["Rock AND Roll"]


def test_cypher_zero_hop_var_length():
    from fastpyvectordb_jax.graphdb import GraphDB
    g = GraphDB()
    g.create_node(["X"], {}, id="a")
    g.create_node(["X"], {}, id="b")
    g.create_edge("a", "b", "T")
    rows = g.query("MATCH (n:X)-[:T*0..2]->(m) RETURN m")
    ids = {r["m"]["id"] for r in rows}
    assert "a" in ids and "b" in ids  # zero-hop binds the anchor itself


def test_cypher_limit_early():
    from fastpyvectordb_jax.graphdb import GraphDB
    g = GraphDB()
    for i in range(50):
        g.create_node(["U"], {"i": i}, id=f"u{i}")
    rows = g.query("MATCH (n:U) RETURN n LIMIT 3")
    assert len(rows) == 3


def test_property_index_numeric_string_distinct():
    from fastpyvectordb_jax.graphdb import GraphDB
    g = GraphDB()
    g.create_node(["P"], {"age": 30}, id="num")
    g.create_node(["P"], {"age": "30"}, id="strv")
    hits = {n.id for n in g.find_nodes_in_range("age", 25, 35)}
    assert hits == {"num"}, hits  # the string '30' is not in a numeric range
    assert {n.id for n in g.find_nodes("P", {"age": 30})} == {"num"}
    assert {n.id for n in g.find_nodes("P", {"age": "30"})} == {"strv"}
    g.delete_node("num")
    assert g.find_nodes_in_range("age", 25, 35) == []
