"""The least work of one rank's part of the scan step on a ("data",
"model") mesh of D x M ranks in the "all_gather" key-switch mode
(launch/nshedb_step.query_step_sharded), counted from the algorithm as
costs/scan_step.py counts the one-device step.

A rank holds nblocks / D blocks of k / M limbs and its keys' k / M
output limbs of all k digits.  Per block it squares, multiplies and
rotates on its limbs, and each of its key switches all-gathers the
polynomial's k digits over "model" and takes, for each of its k / M
output limbs, the products with all k digits.  Then its blocks are
summed, the sum is summed over "data" and the answer gathered to rank 0
over "model".

Bytes: the rank's blocks and its keys' slices read once, its (2, k / M,
n) aggregate written once, every residue at 4 bytes.  Integer
operations and multiply-accumulates: costs/scan_step.py's counts over
the rank's k / M limbs, each output residue's products over all k
digits.  Link bytes: what the rank must receive of each exchange
(costs/collectives.py), every residue at 4 bytes.

The least time is the largest of the resources' times, as if they all
overlapped.
"""


def work(cfg: dict) -> dict:
    """Bytes, int32 operations, multiply-accumulates and link bytes of
    one rank's step."""
    n, k = cfg["n"], cfg["k"]
    data, model = cfg["mesh"]["data"], cfg["mesh"]["model"]
    nb, res = cfg["nblocks"] // data, k // model * n   # blocks; residues of a polynomial
    eq, rot = cfg["eq_levels"], cfg["rot_steps"]
    switches = nb * (eq + 1 + rot)
    nbytes = 4 * (2 * nb * 2 * res + 4 * k * res + 2 * res)
    pointwise = nb * res * (eq * (3 * 6 + 3 * 3) + (4 * 6 + 3 * 3) + rot * 3 * 3)
    pointwise += (nb - 1) * 2 * res * 3             # the sum over the rank's blocks
    reductions = switches * 2 * res * 6
    macs = switches * 2 * res * k
    return {"bytes": nbytes, "int32_ops": pointwise + reductions, "macs": macs,
            "exchanges": [("all-gather", 4 * k * n, model, switches),
                          ("all-reduce", 4 * 2 * res, data, 1),
                          ("all-gather", 4 * 2 * k * n, model, 1)]}


def rank_bound_s(cfg: dict, peaks: dict, collectives) -> float:
    """The least seconds of one rank's step: the digit products on the
    int32 lanes or on the tensor cores, whichever gives less, and the
    exchanges at `collectives`' link rate."""
    if cfg.get("ks_mode", "all_gather") != "all_gather":
        raise ValueError(f"no bound for ks_mode {cfg['ks_mode']!r}")
    w = work(cfg)
    mem_s = w["bytes"] / peaks["hbm_bytes_per_s"]
    lanes_s = w["int32_ops"] / peaks["int32_ops_per_s"]
    link_s = sum(times * collectives.bound_s(kind, result, ranks)
                 for kind, result, ranks, times in w["exchanges"])
    on_lanes = max(mem_s, link_s, lanes_s + 2 * w["macs"] / peaks["int32_ops_per_s"])
    on_tensor = max(mem_s, link_s, lanes_s, 32 * w["macs"] / peaks["int8_tensor_ops_per_s"])
    return min(on_lanes, on_tensor)
