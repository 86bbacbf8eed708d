"""The port's query engine (seaweedfs_tpu_torch/query/) and the volume
server's Query verb against seaweedfs_tpu's, on the CPU.

tests/test_smallgaps.py's query cases ported: the filter ops on strings,
numbers, booleans, nested and missing fields, the projections, and the
gjson path table go through both packages' `query_json` / `get_path`
on the same lines, and the answers are equal and meet the reference
test's expectations. The Query verb runs over gRPC against a master and
a volume server of each package: the same JSON-lines needles (drawn with
numpy) are uploaded to each, and the streamed stripes are equal for
every filter (=, !=, <, <=, >, >=, %, !% on strings and numbers,
existence, none) and projection. Query reads a needle's stored bytes:
a text body over 128 bytes is gzipped on write, so such a needle yields
no records in either package. The tolerance is equality.
"""

import importlib
import json
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.util.availability import free_port

SIDES = ("ref", "port")
PKG = {"ref": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


def mod(side, name):
    return importlib.import_module(f"{PKG[side]}.{name}")


def _both(fn):
    got = {side: fn(side) for side in SIDES}
    assert got["port"] == got["ref"]
    return got["port"]


LINE = '{"name": "alice", "age": 30, "vip": true, "addr": {"city": "sf"}}'
OPS = [
    (("name", "=", "alice"), True),
    (("name", "!=", "alice"), False),
    (("name", "%", "al*"), True),
    (("name", "!%", "al*"), False),
    (("age", ">", "29"), True),
    (("age", "<=", "29"), False),
    (("vip", "=", "true"), True),
    (("addr.city", "=", "sf"), True),
    (("missing", "=", "x"), False),
    (("addr.city", "", ""), True),  # existence
]


@pytest.mark.parametrize("query, expect", OPS, ids=["".join(q) for q, _ in OPS])
def test_ops(query, expect):
    got = _both(lambda s: mod(s, "query").query_json(LINE, [], mod(s, "query").Query(*query)))
    assert got[0] is expect


def test_projections():
    line = '{"a": 1, "b": {"c": [10, 20]}}'
    got = _both(lambda s: mod(s, "query").query_json(line, ["a", "b.c.1", "nope"],
                                                     mod(s, "query").Query("a", "=", "1")))
    assert got == (True, [1, 20, None])


DOC = {
    "name": {"first": "Tom", "last": "Anderson"},
    "age": 37,
    "children": ["Sara", "Alex", "Jack"],
    "friends": [
        {"first": "Dale", "last": "Murphy", "age": 44},
        {"first": "Roger", "last": "Craig", "age": 68},
        {"first": "Jane", "last": "Murphy"},
    ],
    "fav.movie": "Deer Hunter",
}
PATHS = [
    ("name.last", "Anderson"),
    ("age", 37),
    ("children", ["Sara", "Alex", "Jack"]),
    ("children.#", 3),
    ("children.1", "Alex"),
    ("child*.2", "Jack"),
    ("c?ildren.0", "Sara"),
    ("friends.#.first", ["Dale", "Roger", "Jane"]),
    ("friends.#.age", [44, 68]),  # missing elements skipped
    ("friends.1.last", "Craig"),
    ("friends.#", 3),
    ("name.*", "Tom"),  # wildcard: first matching key wins
    ("x*", None),
    ("children.-1", None),  # gjson has no negative indexing
    ("children.9", None),
    ("friends.#.nope", []),
    ("age.#", None),  # `#` only applies to arrays
]


def test_gjson_path_table():
    """gjson.Get path semantics (query_json.go:18 -> tidwall/gjson); None
    stands for each package's own missing marker."""
    def run(side):
        jq = mod(side, "query.json_query")
        out = []
        for path, _ in PATHS:
            got = jq.get_path(DOC, path)
            out.append(None if got is jq._MISSING else got)
        return out
    assert _both(run) == [want for _, want in PATHS]


# --- the Query verb -----------------------------------------------------------------


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out, started = {}, []
    try:
        for side in SIDES:
            master = mod(side, "server.master_server").MasterServer(
                port=free_port(), volume_size_limit_mb=64)
            master.start()
            started.append(master)
            kw = dict(ec_codec="cpu") if side == "ref" else dict(ec_codec="cuda", device="cpu")
            vs = mod(side, "server.volume_server").VolumeServer(
                [str(tmp_path_factory.mktemp(f"q{side}"))], port=free_port(),
                master=f"127.0.0.1:{master.port}", heartbeat_interval=0.1,
                max_volume_counts=[100], scrub_interval=0, **kw)
            vs.start()
            started.append(vs)
            deadline = time.time() + 45
            while time.time() < deadline and len(master.topology.data_nodes()) < 1:
                time.sleep(0.05)
            out[side] = (master, vs)
        yield out
    finally:
        for d in reversed(started):
            d.stop()


def _rows(seed, n):
    """JSON lines drawn with numpy: strings, ints, floats, a nested field
    (about 50 bytes a line)."""
    rng = np.random.default_rng(seed)
    names = ["ann", "bob", "cat", "dan", "eve", "al", "alice"]
    rows = []
    for i in range(n):
        row = {"name": names[int(rng.integers(0, len(names)))], "n": int(rng.integers(0, 20)),
               "f": float(np.round(rng.uniform(-5, 5), 3)), "id": i}
        if rng.integers(0, 3):
            row["tag"] = {"k": str(int(rng.integers(0, 4)))}
        rows.append(json.dumps(row, separators=(",", ":")))
    return "\n".join(rows).encode()


FILTERS = [("n", ">", "9"), ("n", "=", "5"), ("n", "<=", "3"), ("f", "<", "0"),
           ("f", ">=", "1.5"), ("name", "=", "alice"), ("name", "!=", "bob"),
           ("name", "%", "a*"), ("name", "!%", "?a?"), ("name", ">", "cat"),
           ("tag.k", "=", "2"), ("tag", "", ""), ("", "", "")]


@pytest.mark.parametrize("flt", FILTERS, ids=["".join(f) or "none" for f in FILTERS])
def test_select_from_json_lines(clusters, flt):
    """Query over gRPC on the same uploaded needles (twelve files of two
    JSON lines, stored as they are; one of 40 lines, stored gzipped; a
    file id that is not there and one that does not parse): the stripes
    equal the reference's, and they are the plain reading of the stored
    lines (a projection of the rows the filter passes)."""
    bodies = [_rows(20 + i, 2) for i in range(12)] + [_rows(11, 40)]
    assert max(map(len, bodies[:-1])) <= 128 < len(bodies[-1])
    field, operand, value = flt

    def run(side):
        op = mod(side, "client.operation")
        rpc, pb = mod(side, "pb.rpc"), mod(side, "pb.volume_pb2")
        master, vs = clusters[side]
        fids = []
        for body in bodies:
            ar = op.assign(f"127.0.0.1:{master.port}")
            assert not op.upload(f"{ar.url}/{ar.fid}", body, jwt=ar.auth).error
            fids.append(ar.fid)
        vid = fids[0].split(",")[0]
        with rpc.dial(f"127.0.0.1:{vs.grpc_port}") as ch:
            stripes = list(rpc.volume_stub(ch).Query(pb.QueryRequest(
                selections=["name", "n", "tag.k"],
                from_file_ids=fids[:1] + [f"{vid},ffff00000000", "nope"] + fids[1:],
                filter=pb.QueryRequest.Filter(field=field, operand=operand, value=value)),
                timeout=60))
        return [s.records for s in stripes]
    got = _both(run)
    want = []
    for body in bodies[:-1]:
        recs = []
        for line in body.decode().splitlines():
            passed, values = mod("ref", "query").query_json(
                line, ["name", "n", "tag.k"], mod("ref", "query").Query(*flt))
            if passed:
                recs.append(json.dumps(values))
        if recs:
            want.append(("\n".join(recs) + "\n").encode())
    assert got == want and got
