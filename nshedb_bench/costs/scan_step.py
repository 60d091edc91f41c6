"""The whole scan step's least work, counted from the algorithm
(launch/nshedb_step.query_step at a configuration), not from launches.

Per block: `eq_levels` squarings, one multiply and `rot_steps` rotations,
each followed by a key switch of one polynomial by two keys; then a sum
over blocks.

Bytes: the column and value blocks read once, the four (k, k, n) keys read
once for the whole step, the (2, k, n) aggregate written once, every
residue at 4 bytes.  Nothing else needs to leave the chip.

Integer operations on the int32 lanes: a modular product 6, a modular add
3 (costs/mul_mod.py, add_mod.py); a squaring 3 products and 3 adds on
each of its k x n residues, a multiply 4 and 3, a rotation's adds 3 (the
permutation moves no arithmetic); a key switch's output residue one
reduction (6) per key.  A key switch's k digit products an output residue
are multiply-accumulates with lazy reduction, counted on the faster of
two units: the int32 lanes at 2 operations each (a wide multiply-add), or
the int8 tensor cores with each 31-bit residue split into 4 bytes, 16
byte products of 2 operations each.

The least time is the largest of the three resources' times, as if they
all overlapped.
"""


def work(cfg: dict) -> dict:
    """Bytes, int32 operations and multiply-accumulates of one step."""
    n, k, nb = cfg["n"], cfg["k"], cfg["nblocks"]
    eq, rot = cfg["eq_levels"], cfg["rot_steps"]
    res = k * n                                     # residues of one polynomial
    switches = nb * (eq + 1 + rot)
    nbytes = 4 * (2 * nb * 2 * res + 4 * k * res + 2 * res)
    pointwise = nb * res * (eq * (3 * 6 + 3 * 3) + (4 * 6 + 3 * 3) + rot * 3 * 3)
    pointwise += (nb - 1) * 2 * res * 3             # the sum over blocks
    reductions = switches * 2 * res * 6
    macs = switches * 2 * res * k
    return {"bytes": nbytes, "int32_ops": pointwise + reductions, "macs": macs}


def step_bound_s(cfg: dict, peaks: dict) -> float:
    """The least seconds of one step: the digit products on the int32
    lanes or on the tensor cores, whichever gives less."""
    w = work(cfg)
    mem_s = w["bytes"] / peaks["hbm_bytes_per_s"]
    lanes_s = w["int32_ops"] / peaks["int32_ops_per_s"]
    on_lanes = max(mem_s, lanes_s + 2 * w["macs"] / peaks["int32_ops_per_s"])
    on_tensor = max(mem_s, lanes_s, 32 * w["macs"] / peaks["int8_tensor_ops_per_s"])
    return min(on_lanes, on_tensor)
