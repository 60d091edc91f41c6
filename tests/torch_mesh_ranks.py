"""Rank processes for the port's mesh tests: `Ranks` starts `world`
processes that join one `gloo` process group (a `file://` rendezvous in
a directory of the caller's, so concurrent test workers never collide),
run named cases and hand their results back.  Every rank runs the same
program: a batch the query engine stacks on a mesh is held sharded over
its "data" axis (each rank holds its own lanes) and, where k divides,
its "model" axis (each rank holds its own limbs of them), the backend's
key switch keys by output-limb slice; the scan step (`case_scan_step`)
holds only each rank's shard.

Imports numpy and torch at the top and the port inside the ranks (no
JAX), so the card's tests (tests/test_torch_gpu_kernels.py) use it too;
the CPU tests (tests/test_torch_mesh.py, tests/test_torch_scan_mesh.py)
hold the results against the JAX package in the parent process.  Every rank runs with one intra-op
thread; every rendezvous, collective and join has a timeout, and a rank
that fails or hangs fails the whole call.
"""
import datetime
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import torch

TIMEOUT_S = 120          # rendezvous and collectives, per rank
MICRO = dict(n=128, t=257, k=12)


def _port_mods():
    from repro_torch.engine import (backend, executor, plan, planner, queries, schema,
                                    sharded, storage, tpch)
    return dict(backend=backend, executor=executor, plan=plan, planner=planner,
                queries=queries, schema=schema, sharded=sharded, storage=storage,
                tpch=tpch)


def _mesh_desc(mesh):
    if mesh is None:
        return None
    return {"device_type": mesh.device_type, "axes": tuple(mesh.mesh_dim_names),
            "shape": tuple(mesh.shape)}


def _bfv_micro_db(device):
    from repro_torch.core.params import make_params
    from torch_cases import bfv_shard_db
    mods = _port_mods()
    bk = mods["backend"].BFVBackend(make_params(**MICRO), seed=11, device=device)
    return mods, bfv_shard_db(mods, bk)


def _bfv_micro_runs(device, cells):
    """g1 / j1 / f1 of `torch_cases.bfv_shard_plans` through the executor
    at each (shards, limb_shards) cell, with the mesh "auto" attaches;
    each run's `stacked` lists the (global lanes, held lanes, held limbs)
    of every batch it stacked, and `key_limbs` the (digits, output limbs)
    of every key the backend held after it."""
    from torch_cases import bfv_shard_plans, sharded_run
    mods, (db, _, _) = _bfv_micro_db(device)
    stack, stacked = db.bk.stack_blocks, set()

    def recording(blocks):
        batch = stack(blocks)
        stacked.add((batch.nphys, int(batch.data.shape[0]), int(batch.data.shape[-2])))
        return batch

    db.bk.stack_blocks = recording
    out = {}
    for cell in cells:
        for pname, plan in bfv_shard_plans(mods["plan"]).items():
            stacked.clear()
            out[(pname, cell)] = dict(sharded_run(mods, db, plan, cell), stacked=sorted(stacked),
                                      key_limbs=_key_limbs(db.bk.keys))
    return out


def _key_limbs(keys) -> list:
    """(digits, output limbs) of `rlk` and of every Galois key."""
    return sorted({tuple(key.b.shape[:2]) for key in (keys.rlk, *keys.gks.values())})


def case_fold(device):
    """`sharded_fold` of a (4, 2, 3, 16) batch on the 2-rank scan mesh,
    with 3 live lanes and with 4."""
    from repro_torch.engine.sharded import sharded_fold
    from repro_torch.launch.mesh import make_scan_mesh
    data = np.random.default_rng(0).integers(0, 1 << 30, (4, 2, 3, 16), dtype=np.int64)
    mesh = make_scan_mesh(2, device=device)
    t = torch.from_numpy(data).to(device)
    return {"data": data, "live3": sharded_fold(t, 3, mesh).cpu().numpy(),
            "live4": sharded_fold(t, 4, mesh).cpu().numpy()}


def case_bfv_fold(device):
    """Three BFV micro blocks folded without a context and under
    `make_shard_context(2)` (a real 2-rank scan mesh: 3 lanes pad to 4)."""
    mods, (db, _, _) = _bfv_micro_db(device)
    bk, S = db.bk, mods["sharded"]
    vecs = [np.arange(bk.slots) % 7 + i for i in range(3)]
    base = bk.decrypt(bk.fold_blocks(bk.stack_blocks([bk.encrypt(v) for v in vecs])))
    ctx = S.make_shard_context(2, device=bk.device)
    with S.activate(bk, ctx):
        batch = bk.stack_blocks([bk.encrypt(v) for v in vecs])
        got = bk.decrypt(bk.fold_blocks(batch))
    return {"vecs": vecs, "base": base, "got": got, "t": bk.t, "mesh": _mesh_desc(ctx.mesh),
            "nphys": batch.nphys, "nblocks": batch.nblocks, "held": int(batch.data.shape[0])}


BATCH_BLOCKS = 3           # a column of 3 blocks: 4 lanes on a "data" axis of 2
BATCH_OPS = ("add", "sub", "mul_scalar", "mul", "rotate", "sum_slots", "mul_plain")
# what `batch_ops_run` and `refresh_run` hand back to compare (beside "stats")
BATCH_KEYS = tuple(k for op in BATCH_OPS for k in (op, op + "_noise")) + ("fold", "decrypt")
REFRESH_KEYS = tuple(k + sfx for k in ("lanes", "whole") for sfx in ("", "_noise", "_decrypt")
                     ) + ("next",)


def _residues(ct) -> np.ndarray:
    """A ciphertext's residues as numpy, from either package."""
    return ct.data.cpu().numpy() if isinstance(ct.data, torch.Tensor) else np.asarray(ct.data)


def batch_ops_run(bk, ctx=None, activate=None) -> dict:
    """The query engine's batched calls on a `BATCH_BLOCKS`-block batch of
    `bk` (either package's BFVBackend), under shard context `ctx`
    (entered with `activate`, the port's `sharded.activate`) or none:
    add, sub of a single ciphertext, mul_scalar, mul, rotate, sum_slots
    and a per-lane mul_plain, each result's live lanes' residues through
    `unstack_blocks` and its noise; the fold of the product, the decrypt
    of the slot sum, the OpStats; the global and held lane counts."""
    import contextlib
    import dataclasses
    cts = [bk.encrypt(np.arange(bk.slots) % 7 + i) for i in range(BATCH_BLOCKS)]
    single = bk.encrypt(np.arange(bk.slots) % 5)
    basis = np.zeros((BATCH_BLOCKS, bk.slots), dtype=np.int64)
    basis[np.arange(BATCH_BLOCKS), [1, 4, 9]] = 1
    bk.stats.reset()
    out = {}
    with activate(bk, ctx) if ctx is not None else contextlib.nullcontext():
        x, y = bk.stack_blocks(cts), bk.stack_blocks(cts[::-1])
        out["nphys"], out["held"] = x.nphys, [int(b.data.shape[0]) for b in (x, y)]
        out["limbs"] = [int(b.data.shape[-2]) for b in (x, y)]
        res = {"add": bk.add(x, y), "sub": bk.sub(x, single), "mul_scalar": bk.mul_scalar(x, 3),
               "mul": bk.mul(x, y), "rotate": bk.rotate(x, 3), "sum_slots": bk.sum_slots(x),
               "mul_plain": bk.mul_plain(x, basis)}
        for name in BATCH_OPS:
            out[name] = np.stack([_residues(c) for c in bk.unstack_blocks(res[name])])
            out[name + "_noise"] = np.asarray(res[name].noise)
        out["fold"] = _residues(bk.fold_blocks(res["mul"]))
        out["decrypt"] = bk.decrypt(res["sum_slots"])
    out["stats"] = dataclasses.asdict(bk.stats)
    return out


def refresh_run(bk, ctx=None, activate=None) -> dict:
    """`refresh_inplace` of a `BATCH_BLOCKS`-block batch of `bk` (times 3,
    so that its noise is no longer fresh) on the global lanes [0, 2], and
    of every lane of a second one, under shard context `ctx` or none:
    each batch's live residues, noise and decrypts after, the lanes and
    limbs each holds, and the residues of the next encryption (equal only
    if the seeded generator drew the same as on one device)."""
    import contextlib
    import dataclasses
    cts = [bk.encrypt(np.arange(bk.slots) % 7 + i) for i in range(BATCH_BLOCKS)]
    bk.stats.reset()
    out = {}
    with activate(bk, ctx) if ctx is not None else contextlib.nullcontext():
        for name, blocks, lanes in (("lanes", cts, [0, 2]), ("whole", cts[::-1], None)):
            batch = bk.mul_scalar(bk.stack_blocks(blocks), 3)
            bk.refresh_inplace(batch, lanes)
            out[name] = np.stack([_residues(c) for c in bk.unstack_blocks(batch)])
            out[name + "_noise"] = np.asarray(batch.noise)
            out[name + "_decrypt"] = bk.decrypt(batch)
            out[name + "_held"] = int(batch.data.shape[0])
            out[name + "_limbs"] = int(batch.data.shape[-2])
    out["next"] = _residues(bk.encrypt(np.arange(bk.slots) % 3))
    out["stats"] = dataclasses.asdict(bk.stats)
    return out


# the ("data", "model") grid the batch cases run on, by world: ("data",)
# 2 on two ranks (limbs whole), 2 x 2 on four (6 of 12 limbs a rank)
BATCH_GRID = {2: (2, 1), 4: (2, 2)}
# the grid each world's held-limb cases run on (6 of 12 limbs a rank)
LIMB_GRID = {2: (1, 2), 4: (2, 2)}


def _batch_backend(device, grid):
    """A BFV micro backend (seed 11, as the JAX reference's) and the shard
    context of `grid` (shards, limb_shards) the batch cases run under,
    with the mesh "auto" attaches: ("data",) for (2, 1), ("data",
    "model") for the others."""
    from repro_torch.core.params import make_params
    mods = _port_mods()
    bk = mods["backend"].BFVBackend(make_params(**MICRO), seed=11, device=device)
    ctx = mods["sharded"].make_shard_context(grid[0], limb_shards=grid[1], limbs=MICRO["k"],
                                             ring_n=MICRO["n"], device=bk.device)
    return mods, bk, ctx


def _refused(bk, ctx, activate) -> dict:
    """What a sharded batch refuses: a whole batch of as many lanes, a
    batch holding other lanes (5 blocks: 6 lanes), and unstack_cts /
    fold_add without a gather first; each ValueError's message."""
    cts = [bk.encrypt(np.arange(bk.slots) % 7 + i) for i in range(5)]
    out = {}
    with activate(bk, ctx):
        x = bk.stack_blocks(cts[:BATCH_BLOCKS])
        calls = {"whole_pair": lambda: bk.ctx.add(x, bk.ctx.stack_cts(cts[:4])),
                 "other_lanes": lambda: bk.ctx.mul(bk.stack_blocks(cts), x, bk.keys.rlk),
                 "unstack_cts": lambda: bk.ctx.unstack_cts(x),
                 "fold_add": lambda: bk.ctx.fold_add(x)}
        out.update(_raised(calls))
    return out


def _raised(calls: dict) -> dict:
    """{name: the ValueError's message, or None when the call returned}."""
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def case_batch_ops(device):
    """`batch_ops_run` on this group's shard context (batches held
    sharded), the mesh, and `_refused`."""
    import torch.distributed as dist
    mods, bk, ctx = _batch_backend(device, BATCH_GRID[dist.get_world_size()])
    out = batch_ops_run(bk, ctx, mods["sharded"].activate)
    out["mesh"] = _mesh_desc(ctx.mesh)
    out["refused"] = _refused(bk, ctx, mods["sharded"].activate)
    return out


def case_refresh_lanes(device):
    """`refresh_run` on this group's shard context."""
    import torch.distributed as dist
    mods, bk, ctx = _batch_backend(device, BATCH_GRID[dist.get_world_size()])
    return refresh_run(bk, ctx, mods["sharded"].activate)


def case_batch_ops_1x2(device):
    """`batch_ops_run` on a (1, 2) ("data", "model") mesh of two ranks:
    every lane, 6 of 12 limbs a rank."""
    mods, bk, ctx = _batch_backend(device, (1, 2))
    return dict(batch_ops_run(bk, ctx, mods["sharded"].activate), mesh=_mesh_desc(ctx.mesh))


def case_refresh_lanes_1x2(device):
    """`refresh_run` on a (1, 2) mesh of two ranks."""
    mods, bk, ctx = _batch_backend(device, (1, 2))
    return refresh_run(bk, ctx, mods["sharded"].activate)


def case_limbs_held(device):
    """On this group's `LIMB_GRID` mesh: the backend's keys after its
    first key switch there (each (k, k/M, n), against the whole keys'
    output-limb slices and `sharded.place_keys` of them), and what a batch held over "model" and a placed
    key refuse: the one-device key switch, multiply and rotation with a
    placed key, a placed key with another rank's limbs (as a reshard
    onto a new "model" axis would give it), a batch holding other limbs
    (the same lanes gathered whole), unstack_cts / fold_add / decrypt of
    every lane before its limbs are gathered; and the lanes unstacked
    after a gather."""
    import dataclasses
    import torch.distributed as dist
    mods, bk, ctx = _batch_backend(device, LIMB_GRID[dist.get_world_size()])
    whole = bk.keys
    cts = [bk.encrypt(np.arange(bk.slots) % 7 + i) for i in range(BATCH_BLOCKS)]
    with mods["sharded"].activate(bk, ctx):
        x = bk.stack_blocks(cts)
        bk.mul(x, x)
    keys = bk.keys
    pairs = [(keys.rlk, whole.rlk)] + [(keys.gks[g], whole.gks[g]) for g in whole.gks]
    lo, hi = keys.rlk.limbs
    other = (hi % MICRO["k"], hi % MICRO["k"] + hi - lo)
    g = next(iter(keys.gks))
    single = cts[0]
    lanes_whole = bk.ctx.gather_lanes(x)      # every lane, this rank's limbs
    out = {"limbs": tuple(x.limbs[:3]),
           "key_shapes": sorted({tuple(p.b.shape) for p, _ in pairs}),
           "key_limbs": sorted({p.limbs for p, _ in pairs}),
           "keys_equal_slices": all(torch.equal(p.b, w.b[:, lo:hi])
                                    and torch.equal(p.a, w.a[:, lo:hi]) for p, w in pairs),
           "whole_keys_kept": all(w.b.shape[1] == MICRO["k"] for _, w in pairs)}
    again = mods["sharded"].place_keys(whole, ctx.mesh)
    out["place_keys_equal"] = all(
        torch.equal(p.b, q.b) and torch.equal(p.a, q.a) and p.limbs == q.limbs
        for p, q in zip((keys.rlk, *keys.gks.values()), (again.rlk, *again.gks.values())))
    out["refused"] = _raised({
        "kswitch_inner": lambda: bk.ctx._kswitch_inner(single.data[1], keys.rlk.b, keys.rlk.a),
        "one_device_mul": lambda: bk.ctx.mul(single, single, keys.rlk),
        "one_device_rotate": lambda: bk.ctx.apply_galois(single, g, keys.gks[g]),
        "other_slice": lambda: bk.ctx.mul(x, x, dataclasses.replace(keys.rlk, limbs=other)),
        "other_slice_single": lambda: bk.ctx.kswitch_gathered(
            single.data[1], dataclasses.replace(keys.rlk, limbs=other), ctx.mesh),
        "other_limbs": lambda: bk.ctx.add(x, bk.ctx.gather_limbs(x)),
        "unstack_cts": lambda: bk.ctx.unstack_cts(lanes_whole),
        "fold_add": lambda: bk.ctx.fold_add(lanes_whole),
        "decrypt": lambda: bk.ctx.decrypt(lanes_whole, keys.sk)})
    out["unstacked"] = len(bk.ctx.unstack_cts(bk.ctx.gather(x)))
    return out


def case_mock_q1(device):
    """TPC-H Q1 on the Mock backend (n = 64, t = 65537, k = 30: tiny
    LINEITEM is 3 blocks) unsharded and at shards=2 on the real mesh."""
    from repro_torch.core.noise import NoiseProfile
    from torch_cases import sharded_run
    mods = _port_mods()
    bk = mods["backend"].MockBackend(NoiseProfile(n=64, t=65537, k=30), device=device)
    db = mods["tpch"].load(bk, mods["tpch"].Scale.tiny())
    plan = mods["queries"].QUERIES["Q1"][0]
    base = sharded_run(mods, db, plan(), None)
    return {"base": base, "shard": sharded_run(mods, db, plan(), (2, 1))}


def case_bfv_1x2(device):
    return _bfv_micro_runs(device, [(1, 2)])


def case_bfv_2x2(device):
    return _bfv_micro_runs(device, [(2, 2)])


def case_auto(device):
    """What `make_shard_context("auto")` attaches under this process group
    for a few (shards, limb_shards, limbs) cells, and which mesh factory
    calls raise ValueError."""
    from repro_torch.engine.sharded import make_shard_context
    from repro_torch.launch import mesh as M
    cells = [(2, 1, 12), (1, 2, 12), (2, 2, 12), (1, 4, 30), (1, 2, 30), (4, 1, 12)]
    out = {"contexts": {c: _mesh_desc(make_shard_context(
        c[0], limb_shards=c[1], limbs=c[2], ring_n=128, device=device).mesh) for c in cells}}
    raised = {}
    for name, fn in (("query_2x2", lambda: M.make_query_mesh(2, 2, device=device)),
                     ("production", lambda: M.make_production_mesh(device=device)),
                     ("scan_3", lambda: M.make_scan_mesh(3, device=device))):
        try:
            fn()
            raised[name] = None
        except ValueError as e:
            raised[name] = str(e)
    out["raised"] = raised
    out["host"] = _mesh_desc(M.make_host_mesh(device=device))
    return out


def case_kswitch(device):
    """`BFVContext.kswitch_gathered` of a 4-lane batch every rank holds
    and of a single polynomial on this group's (data, model) mesh, with
    the whole key and with this rank's output-limb slice of it
    (`sharded.place_key`); the key switch of the batch held as this
    rank's limbs (its digits gathered, its outputs held); and
    `sharded_fold` of the batch, whole and held as this rank's limbs,
    against the one-device key switch and sum."""
    import torch.distributed as dist
    from repro_torch.core.bfv import BFVContext, LimbShard
    from repro_torch.core.params import make_params
    from repro_torch.engine.sharded import place_key, sharded_fold
    from repro_torch.launch.mesh import make_query_mesh
    world = dist.get_world_size()
    ctx = BFVContext(make_params(**MICRO), seed=5, device=device)
    keys = ctx.keygen(galois_steps=())
    rng = np.random.default_rng(7)
    q = np.asarray(ctx.params.Q.q)[:, None]
    polys = torch.from_numpy(rng.integers(0, q, (4, ctx.params.k, ctx.params.n))).to(device)
    mesh = make_query_mesh(world // 2 if world > 2 else 1, 2, device=device)
    placed = place_key(keys.rlk, mesh)
    lo, hi = placed.limbs
    limbs = LimbShard(lo, hi, ctx.params.k, mesh)
    def equal(got, exp):
        return all(torch.equal(g, e) for g, e in zip(got, exp))

    out = {}
    for name, poly in (("batch", polys), ("single", polys[0])):
        exp = ctx._kswitch_inner(poly, keys.rlk.b, keys.rlk.a)
        out[name] = equal(ctx.kswitch_gathered(poly, keys.rlk, mesh), exp)
        out[name + "_placed"] = equal(ctx.kswitch_gathered(poly, placed, mesh), exp)
    exp = ctx._kswitch_inner(polys, keys.rlk.b, keys.rlk.a)
    out["held"] = equal(ctx._kswitch_held(polys[..., lo:hi, :], placed, limbs),
                        [e[..., lo:hi, :] for e in exp])
    data = torch.stack([polys, polys.flip(0)], dim=1)          # (4, 2, k, n)
    out["fold"] = torch.equal(sharded_fold(data, 3, mesh), data[:3].sum(0))
    out["fold_limbs"] = torch.equal(sharded_fold(data[:, :, lo:hi].contiguous(), 3, mesh,
                                                 limbs=limbs), data[:3].sum(0))
    return out


def case_compressed_psum(device):
    """`train.compression.compressed_psum` of this rank's gradient (its
    own seed and scale) over the ("data",) axis of every rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.compression import compressed_psum
    rank = dist.get_rank()
    g = (np.random.default_rng(rank).standard_normal((64, 8)) * (rank + 1)).astype(np.float32)
    out = compressed_psum(torch.from_numpy(g).to(device), make_host_mesh(device=device), "data")
    return {"g": g, "out": out.cpu().numpy()}


SCAN_BLOCKS = 4
SCAN_SEED = 3


def scan_inputs(q, k: int, n: int, nblocks: int = SCAN_BLOCKS, seed: int = SCAN_SEED) -> dict:
    """The scan step's whole inputs (`nshedb_step.input_specs`' keys but
    q, mu and perm) as int64 residues mod each limb's prime `q`, drawn
    in the order tests/test_torch_nshedb_step.py draws them."""
    rng = np.random.default_rng(seed)
    q = np.asarray(q, dtype=np.int64)[:, None]
    draw = lambda *lead: rng.integers(0, q, lead + (k, n)).astype(np.int64)
    out = {"cts_col": draw(nblocks, 2), "cts_val": draw(nblocks, 2)}
    out.update(zip(("rlk_b", "rlk_a", "gk_b", "gk_a"), (draw(k) for _ in range(4))))
    return out


def scan_shard(scan, nblocks: int, seed: int) -> dict:
    """A `MeshScan` rank's shard of `scan_inputs` (the `shard` of
    `nshedb_step.serve_mesh_scan` in tests/test_torch_mesh_scan_loop.py)."""
    from repro_torch.launch import nshedb_step as S
    full = scan_inputs(scan.tabs.q.cpu().numpy(), scan.cfg.k, scan.cfg.n, nblocks, seed)
    return S.shard_inputs({key: torch.from_numpy(a).to(scan.device) for key, a in full.items()},
                          scan.mesh, scan.mode)


def shares_card(scan, cards):
    """`nshedb_step._shares` on every rank of the group at once, each
    rank naming card `cards[rank]`."""
    from repro_torch.launch import nshedb_step as S
    return S._shares(cards[scan.rank])


def scan_fault(scan, rank: int, kind: str, v: int):
    """A query in which rank `rank` raises (kind "raises") or dies
    ("dies") before its first collective while the others run it."""
    if scan.rank == rank:
        if kind == "dies":
            os._exit(3)
        raise ValueError(f"rank {rank} refuses the query")
    return scan.query(v)


def scan_meshes(world: int, device):
    """{name: mesh} the scan-step cases run on: ("data",) and (1, 2)
    ("data", "model") on 2 ranks; (2, 2) and a (2, 1, 2) ("pod", "data",
    "model") mesh on 4."""
    from repro_torch.launch import mesh as M
    if world == 2:
        return {"data2": M.make_scan_mesh(2, device=device),
                "1x2": M.make_query_mesh(1, 2, device=device)}
    return {"2x2": M.make_query_mesh(2, 2, device=device),
            "pod2x1x2": M.make_step_mesh(2, 1, 2, device=device)}


def case_scan_step(device):
    """`query_step_sharded` at `smoke()` on `SCAN_BLOCKS` blocks in both
    key-switch modes on each of `scan_meshes`, each rank holding only
    its shard (chunk: all of its blocks, and 1): the aggregate gathered
    along "model", the collective record of the step alone, and
    `keyswitch_sharded` of block 0's second component (this rank's
    limbs of it), gathered."""
    import torch.distributed as dist
    from repro_torch.configs.nshedb import smoke
    from repro_torch.core import collectives as C
    from repro_torch.launch import nshedb_step as S
    cfg = smoke()
    consts = S.make_constants(cfg, device=device)
    full = {key: torch.from_numpy(a).to(device)
            for key, a in scan_inputs(consts["q"].cpu().numpy(), cfg.k, cfg.n).items()}
    out = {}
    for name, mesh in scan_meshes(dist.get_world_size(), device).items():
        for mode in S.KS_MODES:
            local = S.shard_inputs(full, mesh, mode)
            keys = [local[key] for key in ("rlk_b", "rlk_a", "gk_b", "gk_a")]
            nb = local["cts_col"].shape[0]
            for chunk in sorted({nb, 1}):
                C.reset_collective_record()
                agg = S.query_step_sharded(
                    local["cts_col"], local["cts_val"], *keys, consts["tabs"], consts["perm"],
                    mesh, eq_levels=cfg.eq_levels, rot_steps=cfg.rot_steps, ks_mode=mode,
                    chunk=chunk)
                record = C.collective_record()
                out[name, mode, chunk] = {
                    "agg": C.gather_axis(agg, mesh, "model", dim=1).cpu().numpy(),
                    "record": record, "blocks_per_rank": nb,
                    "mesh": (tuple(mesh.shape), tuple(mesh.mesh_dim_names))}
            limbs = "model" if "model" in mesh.mesh_dim_names else None
            poly = S.local_shard(full["cts_col"][0, 1], (limbs, None), mesh)
            ks = S.keyswitch_sharded(poly, keys[0], keys[1], consts["tabs"], mesh, mode)
            out[name, mode, "keyswitch"] = [C.gather_axis(x, mesh, "model", dim=0).cpu().numpy()
                                            for x in ks]
    return out


def compressed_psum_expected(gs) -> np.ndarray:
    """The numpy formula of `compressed_psum` over the ranks' gradients
    `gs`: one scale from the largest |g| of any rank, each g rounded half
    to even to int8 bins, the int32 sum of the bins times the scale, all
    in float32."""
    scale = np.maximum(np.float32(max(np.abs(g).max() for g in gs)) / np.float32(127.0),
                       np.float32(1e-12))
    bins = [np.clip(np.round(g / scale), -127, 127).astype(np.int32) for g in gs]
    return (np.sum(bins, axis=0).astype(np.float32) * scale).astype(np.float32)


CASES = {fn.__name__[5:]: fn for fn in (case_fold, case_bfv_fold, case_mock_q1,
                                         case_bfv_1x2, case_bfv_2x2, case_auto,
                                         case_kswitch, case_compressed_psum,
                                         case_scan_step, case_batch_ops,
                                         case_refresh_lanes, case_batch_ops_1x2,
                                         case_refresh_lanes_1x2, case_limbs_held)}


def _rank_main(rank, world, work_dir, names, device):
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{work_dir}/rendezvous",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        results = {name: CASES[name](device) for name in names}
        with open(os.path.join(work_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
    except BaseException:
        with open(os.path.join(work_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Ranks:
    """`world` gloo ranks running the cases `names` on `device`, started
    at construction; `results()` waits for them."""

    def __init__(self, world: int, names, work_dir, device="cpu", timeout_s=2 * TIMEOUT_S):
        self.world, self.names = world, list(names)
        self.work_dir = os.fspath(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        spawn = multiprocessing.get_context("spawn")
        self.procs = [spawn.Process(target=_rank_main, daemon=True,
                                    args=(r, world, self.work_dir, self.names, str(device)))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout_s

    def close(self) -> None:
        """Kill every rank still running."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)

    def results(self) -> dict:
        """{case: [result of rank 0, rank 1, ...]}.  Raises RuntimeError,
        with each failed rank's traceback, when a rank fails or outlives
        the timeout."""
        for p in self.procs:
            p.join(max(self.deadline - time.monotonic(), 0))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        self.close()
        errors = []
        for r, p in enumerate(self.procs):
            err = os.path.join(self.work_dir, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif r in hung or p.exitcode != 0:
                errors.append(f"rank {r}: {'hung' if r in hung else f'exit code {p.exitcode}'}")
        if errors:
            raise RuntimeError("mesh ranks failed:\n" + "\n".join(errors))
        out = []
        for r in range(self.world):
            with open(os.path.join(self.work_dir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return {name: [res[name] for res in out] for name in self.names}
