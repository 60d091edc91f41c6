"""Rank processes for the port's mesh tests: `Ranks` starts `world`
processes that join one `gloo` process group (a `file://` rendezvous in
a directory of the caller's, so concurrent test workers never collide),
run named cases and hand their results back.  The query engine's cases
run on replicated state; the scan step's (`case_scan_step`) holds only
each rank's shard.

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
    at each (shards, limb_shards) cell, with the mesh "auto" attaches."""
    from torch_cases import bfv_shard_plans, sharded_run
    mods, (db, _, _) = _bfv_micro_db(device)
    out = {}
    for cell in cells:
        for pname, plan in bfv_shard_plans(mods["plan"]).items():
            out[(pname, cell)] = sharded_run(mods, db, plan, cell)
    return out


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
            "nphys": batch.nphys, "nblocks": batch.nblocks}


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
    """`BFVContext.kswitch_gathered` of a 3-lane batch and a single
    polynomial on this group's (data, model) mesh, and `sharded_fold` of
    the batch, against the one-device key switch and sum."""
    import torch.distributed as dist
    from repro_torch.core.bfv import BFVContext
    from repro_torch.core.params import make_params
    from repro_torch.engine.sharded import sharded_fold
    from repro_torch.launch.mesh import make_query_mesh
    world = dist.get_world_size()
    ctx = BFVContext(make_params(**MICRO), seed=5, device=device)
    keys = ctx.keygen(galois_steps=())
    rng = np.random.default_rng(7)
    q = np.asarray(ctx.params.Q.q)[:, None]
    polys = torch.from_numpy(rng.integers(0, q, (4, ctx.params.k, ctx.params.n))).to(device)
    mesh = make_query_mesh(world // 2 if world > 2 else 1, 2, device=device)
    out = {}
    for name, poly in (("batch", polys), ("single", polys[0])):
        got = ctx.kswitch_gathered(poly, keys.rlk, mesh)
        exp = ctx._kswitch_inner(poly, keys.rlk.b, keys.rlk.a)
        out[name] = all(torch.equal(g, e) for g, e in zip(got, exp))
    data = torch.stack([polys, polys.flip(0)], dim=1)          # (4, 2, k, n)
    out["fold"] = torch.equal(sharded_fold(data, 3, mesh), data[:3].sum(0))
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
                                         case_scan_step)}


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
