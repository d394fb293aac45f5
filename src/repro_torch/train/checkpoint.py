"""Verified-integrity, topology-independent checkpoints (port of
``repro/train/checkpoint.py``, on-disk format 2 exactly).

A step is the directory ``<ckpt_dir>/step_<step>`` holding

* ``arrays.npz``: the state's tensors as numpy arrays ``a0 ... aN`` in
  ``train/state.tree_leaves_with_path`` order (the reference's flatten
  order), written by ``np.savez``;
* ``meta.json``: ``n_arrays``, ``treedef``, ``step``, ``format`` (2),
  ``manifest`` (per array: ``sha256`` of its C-contiguous bytes, ``shape``,
  numpy ``dtype`` name), ``npz_sha256`` (of the whole file, which catches
  flips in zip bytes that ``np.load`` tolerates), ``extra`` (the caller's
  JSON: the data cursor) and ``meta_sha256`` over the canonical (sorted
  keys) JSON of the rest.

So a checkpoint written by either package passes the other's
``verify_checkpoint``, and a reference checkpoint of an unstacked tree
restores into the port's state bit for bit.

* **Atomic**: a save writes ``tmp.<step>.<nonce>`` and publishes it with
  ``os.replace``; nothing published is deleted first.  Re-saving a
  published step moves the old copy aside for the instant of the swap.
  The next save (and every read) first republishes a complete payload
  that a crash left in staging, then the save sweeps what staging
  remains.  One writer per directory.
* **Verified**: ``verify_checkpoint`` re-derives every digest and lists
  the problems; ``restore_checkpoint`` verifies first, quarantines a
  corrupt or incomplete step (``corrupt.<step>.<nonce>``, kept, never
  swept, never selected again) and walks back to the newest step that
  verifies.
* **Keep-N**: older published steps are removed; quarantined dirs are
  exempt.
* **Topology-independent**: the arrays are host numpy and nothing of the
  device or of a mesh is stored.  A restore copies them into the tensors
  of the caller's tree, on that tree's device, so a run saved on four
  feature shards resumes on two.
* **Train state only**: every tensor must have a numpy dtype (the train
  state is float32 and int32); ``save_checkpoint`` raises on a bf16 leaf,
  naming it, rather than invent an encoding.

* **Pods**: given a ``parallel.ctx.PodMesh`` of n > 1 ranks, rank 0 alone
  writes, in the reference's layout: ``opt.ef`` as ``(n, ...)`` arrays,
  the ranks' ``(1, ...)`` rows gathered; every rank meets at a barrier
  after the save.  ``latest_valid_step`` is decided on rank 0 (which
  alone verifies, quarantines and republishes) and broadcast; a restore
  copies each rank its own row of ``opt.ef``.  A restore into a pod of
  another size fails the signature check, as in the reference.

A save, verify or restore given a ``timings`` list appends its wall
times to it (save: device-to-host, write, the hashing left after the
write, publish; the per-array digests run beside the write).  Reads map
the members of the uncompressed ``arrays.npz`` (what ``np.savez``
writes, in both packages) in place: no copy of the payload beside the
page cache.  Any other layout is unreadable.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import logging
import mmap
import os
import re
import shutil
import struct
import time
import uuid
import zipfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train.state import (numpy_dtype_name, tree_leaves_with_path,
                                     tree_signature)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "latest_valid_step", "list_checkpoints", "verify_checkpoint",
           "quarantine_checkpoint", "CheckpointCorruptError"]

log = logging.getLogger("repro_torch.checkpoint")

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^tmp\.(\d+)\.[0-9a-f]+(\.displaced)?$")

MANIFEST_VERSION = 2
_HASH_THREADS = min(8, os.cpu_count() or 1)


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested checkpoint failed verification (digest,
    shape or dtype mismatch, truncated payload, or missing metadata)."""


def _recover_staging(ckpt_dir: str) -> None:
    """Republish complete staging dirs that a crash mid-publish left
    behind, the fresh payload before a displaced one, so that the keep-N
    sweep never deletes the only copy of a step.  A failed rename (a
    read-only mount) leaves whatever is published."""
    by_step: dict = {}
    for name in os.listdir(ckpt_dir):
        m = _TMP_RE.match(name)
        if not m:
            continue
        path = os.path.join(ckpt_dir, name)
        if (os.path.exists(os.path.join(path, "meta.json"))
                and os.path.exists(os.path.join(path, "arrays.npz"))):
            by_step.setdefault(int(m.group(1)), []).append(
                (bool(m.group(2)), path))
    for step, candidates in by_step.items():
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(final):
            continue
        try:
            os.replace(sorted(candidates)[0][1], final)
        except OSError:
            pass


def _array_digest(arr: np.ndarray) -> str:
    """sha256 of the C-contiguous bytes of ``arr`` (read in place)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(flat).hexdigest()


def _file_digest(path: str) -> str:
    """sha256 of a file's bytes, read in 1 MiB chunks."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _mapped_members(path: str) -> dict:
    """The members of an uncompressed ``np.savez`` file, by name, as arrays
    over a copy-on-write map of the file: no copy and no per-member CRC
    pass (the whole-file digest vouches for every byte).  Raises
    ``ValueError`` when a member is compressed or not a plain ``.npy``
    array."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        infos = zf.infolist()
        if not infos:
            return out
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        for info in infos:
            if (info.compress_type != zipfile.ZIP_STORED
                    or not info.filename.endswith(".npy")):
                raise ValueError(f"member {info.filename} is not a stored "
                                 f".npy array")
            f.seek(info.header_offset + 26)    # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"member {info.filename}: .npy version "
                                 f"{version}")
            if dtype.hasobject:
                raise ValueError(f"member {info.filename} holds objects")
            arr = np.frombuffer(mm, dtype=dtype, count=int(np.prod(shape)),
                                offset=f.tell())
            out[info.filename[:-4]] = arr.reshape(
                shape, order="F" if fortran else "C")
    return out


def _meta_digest(meta: dict) -> str:
    """sha256 of the canonical JSON of ``meta`` without its own digest."""
    core = {k: v for k, v in meta.items() if k != "meta_sha256"}
    return hashlib.sha256(
        json.dumps(core, sort_keys=True).encode()).hexdigest()


def _host_arrays(state: Any) -> List[np.ndarray]:
    """The state's tensors as host numpy arrays, in flatten order.  On the
    CPU an array shares the live tensor's memory: the caller hashes and
    writes it before the next step."""
    out = []
    for path, t in tree_leaves_with_path(state):
        if numpy_dtype_name(t.dtype) is None:
            raise ValueError(
                f"checkpoint leaf {'.'.join(map(str, path))} is {t.dtype}, "
                f"which numpy has no dtype for (the train state is float32 "
                f"and int32)")
        out.append(t.detach().contiguous().cpu().numpy())
    return out


def _is_member(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def _ef_indices(tree: Any) -> List[int]:
    """Flatten-order indices of the leaves under ``opt.ef``."""
    return [i for i, (path, _) in enumerate(tree_leaves_with_path(tree))
            if path[:2] == ("opt", "ef")]


def _gathered_ef(state: Any, mesh) -> Optional[dict]:
    """The pod's ``opt.ef`` on rank 0, each leaf ``(n, ...)`` on the host
    from the ranks' ``(1, ...)`` rows, in one gather (None on the other
    ranks)."""
    ef = state["opt"]["ef"]
    rows = mesh.gather_to_root(torch.cat([t.detach().reshape(-1).cpu()
                                          for t in ef.values()]))
    if mesh.rank != 0:
        return None
    full, lo = {}, 0
    for k, t in ef.items():
        n = t.numel()
        full[k] = torch.cat([r[lo: lo + n].view(t.shape) for r in rows], 0)
        lo += n
    return full


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    extra: Optional[dict] = None, keep: int = 3,
                    timings: Optional[list] = None, mesh: Any = None) -> str:
    """Save the tensors of ``state`` and the JSON ``extra`` as ``step``;
    returns the published path.  Keeps the newest ``keep`` steps.  With a
    pod ``mesh`` every rank calls it and rank 0 writes (module
    docstring)."""
    if _is_member(mesh):
        final = os.path.join(ckpt_dir, f"step_{step}")
        full = (_gathered_ef(state, mesh) if "ef" in state["opt"]
                else None)
        if mesh.rank == 0:
            view = state if full is None else {
                **state, "opt": {**state["opt"], "ef": full}}
            save_checkpoint(ckpt_dir, step, view, extra=extra, keep=keep,
                            timings=timings)
        mesh.barrier()
        return final
    t0 = time.perf_counter()
    os.makedirs(ckpt_dir, exist_ok=True)
    _recover_staging(ckpt_dir)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.{uuid.uuid4().hex[:8]}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp)

    sig = tree_signature(state)
    arrays = {f"a{i}": a for i, a in enumerate(_host_arrays(state))}
    t1 = time.perf_counter()
    npz = os.path.join(tmp, "arrays.npz")
    with concurrent.futures.ThreadPoolExecutor(_HASH_THREADS) as pool:
        # the per-array digests run beside the write; the file's after it
        digests = {k: pool.submit(_array_digest, a)
                   for k, a in arrays.items()}
        np.savez(npz, **arrays)
        t2 = time.perf_counter()
        npz_sha = _file_digest(npz)
        digests = {k: d.result() for k, d in digests.items()}
    t3 = time.perf_counter()
    manifest = {name: {"sha256": digests[name], "shape": list(a.shape),
                       "dtype": str(a.dtype)}
                for name, a in arrays.items()}
    meta = {"n_arrays": len(arrays),
            "treedef": sig["treedef"],
            "step": step,
            "format": MANIFEST_VERSION,
            "manifest": manifest,
            "npz_sha256": npz_sha,
            "extra": extra or {}}
    meta["meta_sha256"] = _meta_digest(meta)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)

    if os.path.exists(final):
        displaced = tmp + ".displaced"
        os.replace(final, displaced)
        os.replace(tmp, final)
        shutil.rmtree(displaced, ignore_errors=True)
    else:
        os.replace(tmp, final)

    # keep-N, then the staging a crashed save left (ours was renamed
    # away); quarantined corrupt.* dirs match neither and stay
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
    for name in os.listdir(ckpt_dir):
        if name.startswith("tmp."):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    t4 = time.perf_counter()
    if timings is not None:
        timings.append({"op": "save", "step": step, "s": t4 - t0,
                        "d2h_s": t1 - t0, "write_s": t2 - t1,
                        "hash_s": t3 - t2, "publish_s": t4 - t3,
                        "bytes": os.path.getsize(
                            os.path.join(final, "arrays.npz"))})
    return final


def list_checkpoints(ckpt_dir: str) -> List[int]:
    """Published steps, ascending, whose two payload files are present
    (quarantined and staging dirs never appear)."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if (m and os.path.exists(os.path.join(ckpt_dir, name, "meta.json"))
                and os.path.exists(
                    os.path.join(ckpt_dir, name, "arrays.npz"))):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest published step, unverified (after republishing what a
    crash left in staging)."""
    if os.path.isdir(ckpt_dir):
        _recover_staging(ckpt_dir)
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _verify(ckpt_dir: str, step: int,
            keep: Optional[dict] = None) -> List[str]:
    """``verify_checkpoint``'s problems; ``keep``, when given, receives
    the arrays read, by member name, so that a restore reads the file
    once and copies exactly what it verified."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.isdir(d):
        return [f"step_{step}: directory missing"]
    meta_path = os.path.join(d, "meta.json")
    npz_path = os.path.join(d, "arrays.npz")
    if not os.path.exists(meta_path):
        return [f"step_{step}: meta.json missing"]
    if not os.path.exists(npz_path):
        return [f"step_{step}: arrays.npz missing"]
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (ValueError, OSError) as e:
        # ValueError covers a flipped byte that breaks UTF-8 before JSON
        return [f"step_{step}: meta.json unreadable ({e})"]
    manifest = meta.get("manifest")
    if not isinstance(manifest, dict):
        return [f"step_{step}: no integrity manifest in meta.json "
                f"(format={meta.get('format')})"]
    if meta.get("meta_sha256") != _meta_digest(meta):
        return [f"step_{step}: meta.json self-digest mismatch"]
    problems: List[str] = []
    with concurrent.futures.ThreadPoolExecutor(_HASH_THREADS) as pool:
        # the whole-file digest decides first, as in the reference; the
        # arrays are read and hashed meanwhile
        whole = pool.submit(_file_digest, npz_path)
        try:
            npz = _mapped_members(npz_path)
        except Exception as e:  # truncated or garbled zip container
            npz, unreadable = None, e
        digests = {}
        if npz is not None:
            names = set(npz)
            expect = set(manifest)
            for name in sorted(expect & names):
                arr = npz[name]
                digests[name] = (list(arr.shape), str(arr.dtype),
                                 pool.submit(_array_digest, arr))
                if keep is not None:
                    keep[name] = arr
        if meta.get("npz_sha256") != whole.result():
            return [f"step_{step}: arrays.npz whole-file sha256 mismatch"]
        if npz is None:
            return [f"step_{step}: arrays.npz unreadable ({unreadable})"]
        if names != expect:
            problems.append(
                f"step_{step}: array set mismatch "
                f"(missing={sorted(expect - names)}, "
                f"unexpected={sorted(names - expect)})")
        if meta.get("n_arrays") != len(manifest):
            problems.append(f"step_{step}: n_arrays={meta.get('n_arrays')} "
                            f"!= manifest size {len(manifest)}")
        for name, (shape, dtype, digest) in digests.items():
            ent = manifest[name]
            if shape != list(ent["shape"]):
                problems.append(f"step_{step}: {name} shape {shape}"
                                f" != manifest {ent['shape']}")
            elif dtype != ent["dtype"]:
                problems.append(f"step_{step}: {name} dtype {dtype} "
                                f"!= manifest {ent['dtype']}")
            elif digest.result() != ent["sha256"]:
                problems.append(f"step_{step}: {name} sha256 mismatch")
    return problems


def verify_checkpoint(ckpt_dir: str, step: int,
                      timings: Optional[list] = None) -> List[str]:
    """Problems of one published step, as readable strings; empty when it
    verifies.  Checks: both files present, ``meta.json`` parses, carries
    the manifest and matches its own digest, the whole-file digest of
    ``arrays.npz``, the file loads, its members are the manifest's, and
    each array's shape, dtype and sha256 match its entry.  So a changed
    byte anywhere in either file fails."""
    return _timed_verify(ckpt_dir, step, timings)


def _timed_verify(ckpt_dir: str, step: int, timings: Optional[list],
                  keep: Optional[dict] = None) -> List[str]:
    t0 = time.perf_counter()
    problems = _verify(ckpt_dir, step, keep)
    if timings is not None:
        timings.append({"op": "verify", "step": step,
                        "s": time.perf_counter() - t0, "ok": not problems})
    return problems


def quarantine_checkpoint(ckpt_dir: str, step: int, reason: str,
                          event_log: Any = None) -> Optional[str]:
    """Move ``step_<step>`` aside as ``corrupt.<step>.<nonce>`` (never
    selected or swept again, kept for forensics) and emit a
    ``quarantine`` event.  Returns the new path, or None when the step
    dir is gone."""
    src = os.path.join(ckpt_dir, f"step_{step}")
    if not os.path.isdir(src):
        return None
    dst = os.path.join(ckpt_dir, f"corrupt.{step}.{uuid.uuid4().hex[:8]}")
    os.replace(src, dst)
    log.warning("quarantined corrupt checkpoint step %d -> %s (%s)",
                step, os.path.basename(dst), reason)
    if event_log is not None:
        event_log.emit("quarantine", step=step, cause=reason,
                       path=os.path.basename(dst))
    return dst


def latest_valid_step(ckpt_dir: str, event_log: Any = None,
                      timings: Optional[list] = None,
                      mesh: Any = None,
                      keep: Optional[dict] = None) -> Optional[int]:
    """The newest step that verifies, quarantining every newer one that
    does not, step dirs with a payload file missing included.  None when
    nothing verifies.  ``keep``, when given, receives the arrays of the
    step returned as its verification read them, for
    ``restore_checkpoint(verified=keep)`` to copy.  With a pod ``mesh``,
    rank 0 decides (it alone verifies, keeps and quarantines) and every
    rank gets its answer."""
    if _is_member(mesh):
        found = (latest_valid_step(ckpt_dir, event_log, timings, keep=keep)
                 if mesh.rank == 0 else None)
        return mesh.broadcast_object(found)
    if not os.path.isdir(ckpt_dir):
        return None
    _recover_staging(ckpt_dir)
    listed = set(list_checkpoints(ckpt_dir))
    all_steps = sorted(int(m.group(1)) for name in os.listdir(ckpt_dir)
                       if (m := _STEP_RE.match(name)))
    for step in reversed(all_steps):
        if keep is not None:
            keep.clear()
        problems = ([f"step_{step}: incomplete payload"]
                    if step not in listed
                    else _timed_verify(ckpt_dir, step, timings, keep=keep))
        if not problems:
            return step
        quarantine_checkpoint(ckpt_dir, step, "; ".join(problems),
                              event_log=event_log)
    if keep is not None:
        keep.clear()
    return None


def restore_checkpoint(ckpt_dir: str, like: Any,
                       step: Optional[int] = None,
                       verify: bool = True,
                       event_log: Any = None,
                       timings: Optional[list] = None,
                       mesh: Any = None,
                       verified: Optional[dict] = None) -> Tuple[Any, dict]:
    """Copy a checkpoint into the tensors of ``like`` and return ``(like,
    extra)``.

    ``step=None`` takes the newest step that verifies (quarantining newer
    ones; ``FileNotFoundError`` when none does).  An explicit ``step`` that
    fails verification is quarantined and raises
    ``CheckpointCorruptError``.  ``verify=False`` skips the digests, not
    the structural checks: ``n_arrays``, the treedef and every array's
    shape and dtype must match ``like``'s signature, or ``ValueError`` is
    raised before any tensor is touched.  The copy is in place, under
    ``no_grad``, on each tensor's own device; the restored tree keeps
    ``like``'s non-tensor values (the decay mask).  An explicit step is
    read once: the arrays its verification read are the ones copied, and
    ``verified``, the arrays of ``step`` that ``latest_valid_step(keep=)``
    has just verified, is copied as it is, without a second read.

    With a pod ``mesh`` every rank calls it with its own ``like`` (its
    ``opt.ef`` rows ``(1, ...)``): rank 0 picks and verifies the step and
    copies what it verified; the other ranks read the step after rank 0's
    verdict.  Each rank copies its row of the saved ``(n, ...)``
    residual."""
    t0 = time.perf_counter()
    member = _is_member(mesh)
    root = not member or mesh.rank == 0
    if root and os.path.isdir(ckpt_dir):
        _recover_staging(ckpt_dir)
    arrays: Optional[dict] = verified or None     # a pod's other ranks: {}
    if step is None:
        if verify:
            kept: dict = {}
            step = latest_valid_step(ckpt_dir, event_log=event_log,
                                     timings=timings, mesh=mesh, keep=kept)
            arrays = kept or None
        else:
            step = latest_step(ckpt_dir) if root else None
            if member:
                step = mesh.broadcast_object(step)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoints in {ckpt_dir}")
    elif verify and verified is None:
        problems = None
        if root:
            arrays = {}
            problems = _timed_verify(ckpt_dir, step, timings, keep=arrays)
            if problems:
                quarantine_checkpoint(ckpt_dir, step, "; ".join(problems),
                                      event_log=event_log)
        if member:
            problems = mesh.broadcast_object(problems)
        if problems:
            raise CheckpointCorruptError(
                f"checkpoint step {step} failed verification: "
                + "; ".join(problems))
    t1 = time.perf_counter()
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    flat = [t for _, t in tree_leaves_with_path(like)]
    sig = tree_signature(like)
    rows = set(_ef_indices(like)) if member else set()
    for i in rows:       # the file holds every member's row
        sig["leaves"][i]["shape"][0] = mesh.size
    if meta["n_arrays"] != len(flat):
        raise ValueError(
            f"structure mismatch: checkpoint step {step} holds "
            f"{meta['n_arrays']} arrays, caller structure has {len(flat)}")
    saved = meta.get("treedef")
    if saved is not None and saved != sig["treedef"]:
        raise ValueError(
            f"structure mismatch: checkpoint step {step} treedef\n  "
            f"{saved}\ndoes not match caller structure\n  {sig['treedef']}")
    for i, want in enumerate(sig["leaves"]):
        ent = meta["manifest"].get(f"a{i}", {})
        if [list(ent.get("shape", [])), ent.get("dtype")] != \
                [want["shape"], want["dtype"]]:
            raise ValueError(
                f"structure mismatch: checkpoint step {step} a{i} is "
                f"{ent.get('shape')} {ent.get('dtype')}, caller's is "
                f"{want['shape']} {want['dtype']}")
    if arrays is None:
        arrays = _mapped_members(os.path.join(d, "arrays.npz"))
    with torch.no_grad():
        for i, t in enumerate(flat):
            src = arrays[f"a{i}"]
            if i in rows:
                src = src[mesh.rank: mesh.rank + 1]
            t.copy_(torch.from_numpy(src).reshape(t.shape))
    if any(t.is_cuda for t in flat):
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    if timings is not None:
        timings.append({"op": "restore", "step": step, "s": t2 - t0,
                        "verify_s": t1 - t0, "copy_s": t2 - t1})
    return like, meta["extra"]
