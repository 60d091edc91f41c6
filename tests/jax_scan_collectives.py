"""The JAX package's collectives for its scan step on a 2 x 2 ("data",
"model") mesh beside the port's dry-run count of the same cell.

Not a test: a measurement, run as its own process (the JAX device count
is fixed at first use):

    PYTHONPATH=src python tests/jax_scan_collectives.py

It compiles `repro.launch.nshedb_step.query_step` at `smoke()` on 4
blocks, placed by its `shardings`, on four virtual CPU devices, in both
key-switch modes, and reads `repro.launch.dryrun.collective_bytes` of
the optimized HLO (result bytes by kind, per device).  Beside each, the
port's `launch/dryrun.measure_step` on the same mesh, blocks and config
(chunk: all of a rank's blocks).  Prints one JSON object.
"""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import json  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

NBLOCKS = 4
MESH = ((2, 2), ("data", "model"))


def jax_collectives(mode: str) -> dict:
    """Result bytes by collective kind in the compiled HLO, and each
    collective op's count and result shapes."""
    from repro.configs.nshedb import smoke
    from repro.launch import dryrun as jdryrun        # its 512-device flag comes too late
    from repro.launch import nshedb_step as Q

    cfg = smoke()
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(MESH[0]), MESH[1])
    specs = Q.input_specs(cfg, NBLOCKS)
    shard = Q.shardings(mesh, cfg, NBLOCKS)
    names = list(specs)

    def step(*a):
        return Q.query_step(**dict(zip(names, a)), eq_levels=cfg.eq_levels,
                            rot_steps=cfg.rot_steps, ks_mode=mode)

    with mesh:                                        # as repro.launch.dryrun.run_cell
        hlo = jax.jit(step, in_shardings=tuple(shard[n] for n in names)).lower(
            *(specs[n] for n in names)).compile().as_text()
    ops = {}
    for line in hlo.splitlines():         # the line pattern of jdryrun.collective_bytes
        m = re.match(r"(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|\S+)\s+(\S+)\(", line.strip())
        kind = m and m.group(2).rstrip("(").split(".")[0].removesuffix("-start")
        if kind in jdryrun._COLLECTIVES:
            op = ops.setdefault(kind, {"count": 0, "result_shapes": {}})
            op["count"] += 1
            op["result_shapes"][m.group(1)] = op["result_shapes"].get(m.group(1), 0) + 1
    return {"collective_bytes": jdryrun.collective_bytes(hlo), "ops": ops}


def port_collectives(mode: str) -> dict:
    from repro_torch.configs.nshedb import smoke
    from repro_torch.launch import dryrun

    got = dryrun.measure_step(smoke(), *MESH, NBLOCKS, ks_mode=mode)
    return {"collective_bytes": got["collective_bytes"], "chunk": got["chunk"]}


def main() -> dict:
    assert len(jax.devices()) == 4, jax.devices()
    out = {"cell": {"config": "smoke", "nblocks": NBLOCKS, "mesh": [list(MESH[0]), list(MESH[1])]},
           "modes": {mode: {"jax": jax_collectives(mode), "port": port_collectives(mode)}
                     for mode in ("all_gather", "reduce_scatter")}}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
