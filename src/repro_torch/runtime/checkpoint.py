"""Fault-tolerant checkpointing.

Design (per DESIGN.md §6):
  * step-granular checkpoints: params + optimizer + data-pipeline cursor
  * atomic manifest: every leaf is written under a tmp directory, then a
    single os.rename publishes the step — a crash mid-write can never
    leave a readable-but-corrupt checkpoint
  * async double-buffered writer: the caller hands off host copies
    (taken on its own thread) and keeps working while the previous
    snapshot flushes
  * elastic restore: leaves are stored unsharded with their logical
    names; restore puts them on whatever device the caller names
  * keep-last-k garbage collection

Trees are nested dicts, lists and tuples whose leaves are tensors,
numpy arrays or scalars; None is an empty subtree.  Leaves are named and
ordered as the JAX package names them (dict keys sorted, list / tuple
items by index, path parts joined with "/"), so the on-disk format —
`step_XXXXXXXX/manifest.json` and one `{group}__{path}.npy` per leaf —
is the same and either package restores the other's snapshots.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from .faults import CheckpointCorruptFault


def _items(tree, prefix=()):
    """(path, leaf) pairs in the JAX package's order: dict keys sorted,
    sequences by index; None contributes no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _items(tree[key], prefix + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, prefix + (str(i),))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    return {"/".join(path): leaf for path, leaf in _items(tree)}


def _rebuild(tree, leaves, prefix=()):
    """`tree`'s structure with each leaf replaced by leaves[path name]."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(sub, leaves, prefix + (str(key),))
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(sub, leaves, prefix + (str(i),))
               for i, sub in enumerate(tree)]
        return out if isinstance(tree, list) else type(tree)(out)
    return leaves["/".join(prefix)]


# numpy has no bfloat16: a bfloat16 leaf's host copy is its raw bits as
# 2-byte void records, written as the JAX package's `np.save` of an
# ml_dtypes array writes it (header descr '<V2') and named "bfloat16" in
# the manifest.
_BF16_BITS = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf, taken now."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(_BF16_BITS)
        return host.numpy()
    return np.array(leaf)


def _save(path: str, arr: np.ndarray) -> str:
    """Write one leaf; returns the dtype name the manifest records."""
    if arr.dtype != _BF16_BITS:
        np.save(path, arr)
        return str(arr.dtype)
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())
    return "bfloat16"


def _leaf_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf as a CPU tensor, bfloat16 when the manifest says so."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _host_tree(tree):
    return _rebuild(tree, {name: _host(leaf) for name, leaf in _flatten(tree).items()})


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, params, opt=None, extra: dict | None = None):
        """Snapshot to host then write (async by default).  The host
        copies are taken here, on the caller's thread, so the caller may
        change its tensors as soon as this returns."""
        host = {
            "params": _host_tree(params),
            "opt": _host_tree(opt) if opt is not None else None,
        }
        meta = {"step": step, "extra": extra or {}}
        self.wait()                               # double buffer: one in flight
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, meta: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": meta["step"], "extra": meta["extra"], "leaves": {}}
        for group in ("params", "opt"):
            tree = host[group]
            if tree is None:
                continue
            for name, arr in _flatten(tree).items():
                fn = f"{group}__{name.replace('/', '__')}.npy"
                dtype = _save(os.path.join(tmp, fn), arr)
                manifest["leaves"][f"{group}/{name}"] = {
                    "file": fn, "shape": list(arr.shape), "dtype": dtype,
                    # exact on-disk size: lets verify_step detect a leaf
                    # truncated *after* the atomic publish (at-rest rot)
                    "bytes": os.path.getsize(os.path.join(tmp, fn))}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> bool:
        """Cheap integrity check of a published snapshot: manifest reads
        back and every leaf file exists at its recorded byte size.
        Catches truncation/deletion *after* the atomic publish, which
        the write-path atomicity can not protect against."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        for info in manifest.get("leaves", {}).values():
            path = os.path.join(d, info["file"])
            if not os.path.exists(path):
                return False
            if "bytes" in info and os.path.getsize(path) != info["bytes"]:
                return False
        return True

    def restore(self, step: int, params_like, opt_like=None, device="cuda"):
        """Rebuild trees from a checkpoint.  params_like/opt_like give
        structure; every leaf comes back as a tensor on `device` — any
        device, whatever wrote the snapshot.  An unreadable manifest or
        leaf raises a typed CheckpointCorruptFault (runtime/faults.py)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptFault(
                f"step {step}: manifest unreadable: {e}",
                stage="restore", detail={"step": step}) from e

        def rebuild(group, like):
            if like is None:
                return None
            leaves = {}
            for name in _flatten(like):
                info = manifest["leaves"][f"{group}/{name}"]
                try:
                    arr = np.load(os.path.join(d, info["file"]))
                except (OSError, ValueError, EOFError) as e:
                    raise CheckpointCorruptFault(
                        f"step {step}: leaf {group}/{name} unreadable: {e}",
                        stage="restore",
                        detail={"step": step, "leaf": f"{group}/{name}"}) from e
                leaves[name] = _leaf_tensor(arr, info.get("dtype")).to(device)
            return _rebuild(like, leaves)

        return rebuild("params", params_like), rebuild("opt", opt_like), manifest["extra"]

    def restore_latest_valid(self, params_like, opt_like=None, device="cuda"):
        """Restore the newest *intact* snapshot, walking backward past
        corrupt ones (truncated leaves, unreadable manifests — the
        at-rest failures verify_step detects).  Returns
        (step, params, opt, extra); raises CheckpointCorruptFault when
        no intact snapshot remains."""
        skipped = []
        for step in reversed(self.all_steps()):
            if not self.verify_step(step):
                skipped.append(step)
                continue
            try:
                params, opt, extra = self.restore(
                    step, params_like, opt_like, device)
            except CheckpointCorruptFault:
                skipped.append(step)
                continue
            return step, params, opt, extra
        raise CheckpointCorruptFault(
            f"no intact checkpoint under {self.dir} "
            f"(skipped corrupt steps {skipped})",
            stage="restore", detail={"skipped": skipped})
