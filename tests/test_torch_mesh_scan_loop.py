"""The mesh scan loop (`nshedb_step.serve_mesh_scan`, `MeshScan`) and its
launcher (`launch/ranks.RankGroup`) on four gloo ranks of this host, a
("data", "model") 2 x 2 mesh, at `configs.nshedb.smoke()` on 8 blocks.

This process is rank 0, as the benchmark's is; ranks 1-3 are spawned by
the launcher, each holding only its shard (`torch_mesh_ranks.scan_shard`).
Rank 0's aggregate of three queries with different constants must equal,
bit for bit, the JAX package's `query_step` of the column less Delta * v
(Delta = floor(Q / t), taken from the first component mod each prime,
worked out here in numpy; under a 1 x 1 mesh, as tests/test_torch_scan_mesh.py
runs it), and the port's one-device `query_step` of the same.  A mesh
rank refuses to size its chunk from a card another rank shares.  A rank
that raises, or dies, in a query must fail the call well within the
group's timeout and leave no rank alive.
"""
import math
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import nshedb as jcfg  # noqa: E402
from repro.launch import nshedb_step as J  # noqa: E402
from repro_torch.configs.nshedb import smoke  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch import nshedb_step as S  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402

from torch_mesh_ranks import scan_inputs  # noqa: E402

CFG = smoke()
BLOCKS, SEED = 8, 5
VS = (0, 7, 200)
TIMEOUT_S = 60.0


def _start(mode, timeout_s=TIMEOUT_S):
    return S.serve_mesh_scan(CFG, 2, 2, "torch_mesh_ranks:scan_shard", (BLOCKS, SEED),
                             ks_mode=mode, device="cpu", timeout_s=timeout_s)


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _expected(v: int, mode: str) -> tuple:
    """(the JAX package's, the port's one-device) aggregate of the column
    less Delta * v."""
    tabs = S.make_constants(CFG, device="cpu")
    q = tabs["q"].numpy()
    full = scan_inputs(q, CFG.k, CFG.n, BLOCKS, SEED)
    delta = np.array([math.prod(int(p) for p in q) // CFG.t % int(p) for p in q], dtype=np.int64)
    col = full["cts_col"].copy()
    col[:, 0] = (col[:, 0] - (delta * v % q)[:, None]) % q[:, None]
    jc = J.make_constants(jcfg.smoke())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with jax.set_mesh(mesh):
        jout = np.asarray(J.query_step(
            _j(col), _j(full["cts_val"]), *(_j(full[key]) for key in S.SCAN_KEYS),
            jnp.asarray(jc["q"]), jnp.asarray(jc["mu"]), jnp.asarray(jc["perm"]),
            eq_levels=CFG.eq_levels, rot_steps=CFG.rot_steps, ks_mode=mode)).astype(np.int64)
    t = {key: torch.from_numpy(a) for key, a in full.items()}
    tout = S.query_step(torch.from_numpy(col), t["cts_val"], *(t[key] for key in S.SCAN_KEYS),
                        tabs["tabs"], tabs["perm"], eq_levels=CFG.eq_levels,
                        rot_steps=CFG.rot_steps, ks_mode=mode).numpy()
    return jout, tout


@pytest.mark.parametrize("mode", S.KS_MODES)
def test_rank0_aggregate_equals_one_device(mode):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    group = _start(mode)
    try:
        scan = group.worker
        assert scan.col.shape == (BLOCKS // 2, 2, CFG.k // 2, CFG.n)
        assert scan.chunk == BLOCKS // 2
        assert group.run("torch_mesh_ranks:shares_card", ["a", "b", "c", "a"]) == [
            True, False, False, True]
        assert group.run("torch_mesh_ranks:shares_card", ["a", "b", "c", "d"]) == [False] * 4
        got = []
        for i, v in enumerate(VS):
            tracing.enable(i == 0)
            results = group.call("query", v)
            assert results[1:] == [None, None, None]
            got.append(results[0].numpy())
        tracing.enable(False)
        spans, _ = tracing.take()
        group.call("release")
    finally:
        tracing.enable(False)
        group.close()
        torch.set_num_threads(threads)
    assert not any(p.is_alive() for p in group.procs)
    for v, agg in zip(VS, got):
        assert agg.shape == (2, CFG.k, CFG.n)
        jax_agg, port_agg = _expected(v, mode)
        assert np.array_equal(agg, jax_agg), v
        assert np.array_equal(agg, port_agg), v
    # the first query recorded: its root span carries its collectives'
    # bytes, and each exchange is a span of its own
    root, = [s for s in spans if s.parent_id == 0]
    assert root.attrs["plan"] == "scan_mesh"
    colls = [s for s in spans if s.name.startswith("coll.")]
    kinds = {"all_gather": {"coll.all-gather", "coll.all-reduce"},
             "reduce_scatter": {"coll.all-gather", "coll.all-reduce", "coll.reduce-scatter"}}
    assert {s.name for s in colls} == kinds[mode]
    for kind in collectives.COLLECTIVE_KINDS:
        assert root.attrs[kind] == sum(s.attrs["bytes"] for s in colls
                                       if s.name == "coll." + kind)
    assert all(s.attrs["ranks"] == 2 and s.attrs["axis"] in ("data", "model") for s in colls)
    ks = CFG.eq_levels + 1 + CFG.rot_steps
    final = 2 * CFG.k * CFG.n * 8                 # the (2, k, n) answer gathered
    if mode == "all_gather":                     # each key switch's (B, k, n) int32 digits
        assert root.attrs["all-gather"] == ks * (BLOCKS // 2) * CFG.k * CFG.n * 4 + final


@pytest.mark.parametrize("kind", ["raises", "dies"])
def test_a_failing_rank_fails_the_call_and_leaves_no_rank(kind):
    group = _start("all_gather")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank"):
        group.run("torch_mesh_ranks:scan_fault", 1, kind, 7)
    assert time.monotonic() - t0 < TIMEOUT_S / 2
    assert group.closed and not any(p.is_alive() for p in group.procs)
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="closed"):
        group.call("query", 7)


def test_a_rank_on_a_shared_card_refuses_to_size_its_chunk(monkeypatch):
    """`rank_chunk` asks the process group whether another rank holds the
    same card, and refuses it; the CPU sizes no chunk from free memory."""
    assert not S._shares("GPU-0")            # no process group: no other rank
    card = types.SimpleNamespace(is_cuda=True, device="cuda:0", shape=(4, 2, 2, 256))
    monkeypatch.setattr(S, "_shares", lambda card: True)
    monkeypatch.setattr(S.torch.cuda, "get_device_properties",
                        lambda device: types.SimpleNamespace(uuid="GPU-0"))
    with pytest.raises(ValueError, match="shares this card"):
        S.rank_chunk(card, CFG.k)
    assert S.rank_chunk(torch.zeros(4, 2, 2, 8, dtype=torch.int64), CFG.k) == 4
