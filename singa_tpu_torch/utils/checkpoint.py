"""Checkpoint / resume: npz snapshots, and the JAX package's orbax steps.

Port of `singa_tpu/utils/checkpoint.py`.  The port writes the no-orbax
format of that module byte for byte: `workspace/checkpoints/step_<N>.npz`
holds the flattened {params, opt_state, step} triple under `|`-joined
keys (`params|attn0/wq`, `opt_state|history|attn0/wq`, `step`), written
to a tmp file, fsynced and renamed into place; `MANIFEST.json` records
each snapshot's size and sha256 and is itself written atomically;
`LAYOUT_VERSION` stamps the parameter layout, before the first
snapshot shows (the JAX package stamps it after the manifest record, so
a reader in between refuses its first save: fault C6).  So a snapshot
that either package writes on this path restores in the other.

It also reads the steps the JAX package writes through orbax, its
default where `orbax.checkpoint` imports: a digit-named directory
holding `_CHECKPOINT_METADATA` (orbax writes it last, the JAX
`_finalized` rule), whose `default/_METADATA` lists every leaf's key
path; a leaf is a zarr array (`utils/zarr.py`, v2 or sharded v3) at the
key path joined with `.`, in the step's OCDBT database
(`utils/ocdbt.py`) or in plain files where the step was written without
OCDBT.  The port reads them with its own decoder of zstd frames and
CRC32C (`utils/zstd.py`), and nothing of JAX, orbax, tensorstore or
ml_dtypes.  The decoder follows the manager's `device`, as the kernels'
wrappers do: for the card (the default) the native one built from
`csrc/zstd_dec.cu`, for the CPU the plain one, never one in place of the
other.  Such a step's health verdict sits in the manifest under the
bare step (`"7"`).  `available_steps` lists both kinds, and a workspace
holding both restores the newest step of either.

`restore` verifies the snapshot against the manifest and walks back to
the previous good one past any corrupt or partial snapshot (on an orbax
step, torn bytes: a CRC32C or a length that does not match, a frame
that does not decode, a missing file; a step in a format it does not
understand raises `OrbaxUnreadableError` rather than being skipped);
with `skip_unhealthy` it also walks back past any snapshot whose health
verdict in the manifest is not "ok" (a snapshot without one counts as
ok).  `save(..., health=)` records a verdict: the Trainer writes the
health monitor's (`core/trainer.py`) and the serving engine reads them
(`serve/engine.py`).  Saves and restores run inside the `ckpt.save` and
`ckpt.restore` spans and consult their fault sites; the `torn` kind at
`ckpt.save` truncates the renamed snapshot to half and records no
manifest entry, a save that "succeeded" with garbage on disk.

Snapshots hold numpy arrays: `save` takes tensors or arrays (moved to
the host; bf16 tensors are stored as f32) and `restore` returns numpy
(an orbax step's bf16 leaves widened to f32, which holds every bf16
value exactly), which the caller places (`Trainer.resume`).
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DeviceLike, resolve_device
from . import faults
from .ocdbt import (FileStore, OcdbtStore, OrbaxTornStepError,
                    OrbaxUnreadableError)
from .zarr import read_array
from .zstd import Codec

# Parameter-layout generation, the JAX package's: bump when a change
# re-orders elements inside a stored parameter without changing its
# shape.  1 — NCHW vision stack; 2 — NHWC vision stack.
LAYOUT_VERSION = 2

_MANIFEST = "MANIFEST.json"


class LayoutMismatchError(RuntimeError):
    pass


# what a torn or partial npz snapshot raises on its way to the arrays
_NPZ_TORN = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _tear(path: str) -> None:
    """Simulate a torn write (fault kind "torn"): truncate the snapshot
    to half — a save that returned success but left garbage on disk."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size // 2)


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:      # numpy has no bfloat16
            v = v.float()
        return v.cpu().numpy()
    return np.asarray(v)


class CheckpointManager:
    """Save/restore the training state triple under
    `workspace/checkpoints` (the reference's ClusterProto.workspace
    layout).  `device` is where the restored state goes: it picks the
    decoder of orbax steps (the card's native one unless the caller asks
    for the CPU); npz snapshots read alike everywhere."""

    def __init__(self, workspace: str, log_fn=print,
                 device: DeviceLike = None):
        self.dir = os.path.abspath(os.path.join(workspace, "checkpoints"))
        self.log = log_fn
        self.device = device
        os.makedirs(self.dir, exist_ok=True)
        # writer-concurrent polling state (fingerprint): the last token
        # handed out, the last manifest stat whose content parsed clean,
        # and how many polls hit a mid-write read and reported no change
        self._last_fp: tuple = ((), None)
        self._man_checked: Optional[tuple] = None
        self._last_steps: List[int] = []
        self.torn_polls = 0

    # -- layout version ----------------------------------------------------
    def _version_path(self) -> str:
        return os.path.join(self.dir, "LAYOUT_VERSION")

    def _write_version(self) -> None:
        _atomic_write(self._version_path(), str(LAYOUT_VERSION).encode())

    def _check_version(self) -> None:
        """Refuse snapshots written under another parameter layout: the
        shapes match but the element order does not."""
        path = self._version_path()
        if not os.path.exists(path):
            got = 1   # pre-versioning checkpoints are the v1 layout
        else:
            with open(path) as f:
                got = int(f.read().strip() or 1)
        if got != LAYOUT_VERSION:
            raise LayoutMismatchError(
                f"checkpoint layout version {got} != current "
                f"{LAYOUT_VERSION}: parameters were stored with a "
                f"different element order; re-train or convert the "
                f"checkpoint")

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, _MANIFEST)

    def _read_manifest(self) -> Dict[str, Any]:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return {}
        except (json.JSONDecodeError, OSError) as e:
            # a corrupt manifest must not take every snapshot with it:
            # entries degrade to "legacy" (load-verified only)
            self.log(f"warning: checkpoint manifest unreadable ({e}); "
                     f"verifying snapshots by load only")
            return {}

    def _manifest_record(self, step: int, path: str,
                         health: Optional[Dict[str, Any]] = None) -> None:
        man = self._read_manifest()
        entry: Dict[str, Any] = {"step": step,
                                 "size": os.path.getsize(path),
                                 "sha256": _sha256_file(path)}
        if health is not None:
            entry["health"] = health
        man[os.path.basename(path)] = entry
        _atomic_write(self._manifest_path(),
                      json.dumps(man, indent=1, sort_keys=True).encode())

    def health_verdict(self, step: int) -> Optional[str]:
        """The health verdict recorded at save time ("ok" / "spike" /
        "diverged" / "nonfinite"), or None for a snapshot saved without
        one (treated as ok by the `skip_unhealthy` walk-back).  An npz
        snapshot's record is keyed by its file name, an orbax step's by
        the bare step."""
        man = self._read_manifest()
        entry = man.get(f"step_{step}.npz")
        if entry is None:
            entry = man.get(str(step))
        if not isinstance(entry, dict):
            return None
        health = entry.get("health")
        return health.get("verdict") if isinstance(health, dict) else None

    def _verify(self, step: int) -> Optional[str]:
        """Path of a checksum-clean snapshot for `step`, else None.
        Snapshots with no manifest entry pass here and are verified by
        the np.load in restore."""
        path = os.path.join(self.dir, f"step_{step}.npz")
        if not os.path.exists(path):
            return None
        entry = self._read_manifest().get(os.path.basename(path))
        if entry is not None:
            if (os.path.getsize(path) != entry.get("size")
                    or _sha256_file(path) != entry.get("sha256")):
                return None
        return path

    # -- save --------------------------------------------------------------
    def save(self, step: int, params: Dict[str, Any],
             opt_state: Dict[str, Any],
             health: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot the state triple.  `health` ({"verdict": ..., ...})
        is recorded in MANIFEST.json, so `restore(skip_unhealthy=True)`
        can walk back past a snapshot taken in a numerically suspect
        window."""
        with obs.span("ckpt.save", step=step,
                      verdict=(health or {}).get("verdict")):
            self._save(step, params, opt_state, health)

    def _save(self, step: int, params: Dict[str, Any],
              opt_state: Dict[str, Any],
              health: Optional[Dict[str, Any]]) -> None:
        if self.latest_step() is not None:
            # never mix layouts in one directory (the marker is
            # per-directory)
            self._check_version()
        act = faults.maybe_fault("ckpt.save")
        state = {"params": params, "opt_state": opt_state,
                 "step": np.asarray(step)}
        arrays = {k: _to_numpy(v) for k, v in _flatten("", state).items()}
        path = os.path.join(self.dir, f"step_{step}.npz")
        # tmp + atomic rename: a crash mid-write leaves a *.tmp the
        # reader never lists, not a torn step_N.npz
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        # the layout marker goes down before the snapshot shows: a
        # reader between the rename and the manifest record (a second
        # of checksumming for a large snapshot) would take a workspace's
        # first save for the unmarked layout 1 and refuse it (fault C6)
        self._write_version()
        os.replace(tmp, path)
        if act == "torn":
            # the rename "succeeded" but the data never reached the
            # disk; no manifest entry either (a crash before it)
            _tear(path)
            return
        self._manifest_record(step, path, health=health)

    # -- listing -----------------------------------------------------------
    def _is_orbax(self, step: int) -> bool:
        """Whether `step` is a finished orbax step directory: digit-named,
        holding `_CHECKPOINT_METADATA`, which orbax writes last (a
        directory without it is a save in flight or the wreck of a
        writer that died mid-save, and is not listed).  A step that is
        also an npz snapshot is read from the npz."""
        return (os.path.isfile(os.path.join(self.dir, str(step),
                                            "_CHECKPOINT_METADATA"))
                and not os.path.exists(
                    os.path.join(self.dir, f"step_{step}.npz")))

    def available_steps(self) -> List[int]:
        """All snapshot steps on disk, npz snapshots and finished orbax
        step directories, ascending (readable or not — restore decides).
        Never raises against a live writer: a listing that fails returns
        the previous one (counted in `torn_polls`)."""
        try:
            steps = set()
            for f in os.listdir(self.dir):
                if f.startswith("step_") and f.endswith(".npz"):
                    steps.add(int(f[5:-4]))
                elif f.isdigit() and self._is_orbax(int(f)):
                    steps.add(int(f))
            steps = sorted(steps)
        except (OSError, ValueError):
            self.torn_polls += 1
            return list(self._last_steps)
        self._last_steps = steps
        return steps

    def latest_step(self) -> Optional[int]:
        """The newest step on disk, or None."""
        steps = self.available_steps()
        return steps[-1] if steps else None

    def fingerprint(self) -> tuple:
        """Cheap change token for hot-reload polling: the snapshot steps
        on disk plus the MANIFEST.json stat (mtime_ns, size).  Never
        raises: a manifest caught mid-write surfaces as "no change" (the
        previous token, counted in `torn_polls`)."""
        try:
            steps = tuple(self.available_steps())
            try:
                st = os.stat(self._manifest_path())
                man = (st.st_mtime_ns, st.st_size)
            except FileNotFoundError:
                man = None
            if man is not None and man != self._man_checked:
                # the stat moved: prove the content is whole first
                with open(self._manifest_path()) as f:
                    json.load(f)
                self._man_checked = man
        except (OSError, ValueError):
            self.torn_polls += 1
            return self._last_fp
        self._last_fp = (steps, man)
        return self._last_fp

    def save_in_flight(self) -> bool:
        """True while the newest snapshot on disk has no manifest entry
        but the manifest holds others, and is a whole zip: a save
        between renaming its snapshot into place (whole, since it was
        written and synced before the rename) and recording its size,
        checksum and health verdict.  A serving poll waits for the
        record rather than take the snapshot for an unverified, healthy
        one.  A torn snapshot (truncated, no record to come) is not in
        flight: the poll goes on, and restore walks past it."""
        steps = self.available_steps()
        if not steps or self._is_orbax(steps[-1]):
            # an orbax step shows once it is finished
            return False
        name = f"step_{steps[-1]}.npz"
        man = self._read_manifest()
        if not man or name in man:
            return False
        try:
            return zipfile.is_zipfile(os.path.join(self.dir, name))
        except OSError:
            return False

    # -- restore -----------------------------------------------------------
    def restore(self, step: Optional[int] = None,
                skip_unhealthy: bool = False
                ) -> Optional[Tuple[Dict, Dict, int]]:
        """(params, opt_state, step) as numpy dicts from the latest (or
        the latest <= `step`) restorable snapshot, npz or orbax, else
        None.  A corrupt or partial snapshot is logged and skipped: the
        next older one is tried.  With `skip_unhealthy`, so is a snapshot
        whose recorded health verdict is not "ok".  Raises
        `OrbaxUnreadableError` on an orbax step in a format this reader
        does not understand."""
        with obs.span("ckpt.restore",
                      skip_unhealthy=skip_unhealthy) as sp:
            out = self._restore(step, skip_unhealthy)
            if out is not None:
                sp.set(step=out[2])
            return out

    def _restore(self, step: Optional[int], skip_unhealthy: bool
                 ) -> Optional[Tuple[Dict, Dict, int]]:
        steps = self.available_steps()
        if step is not None:
            steps = [s for s in steps if s <= step]
        if not steps:
            return None
        self._check_version()
        faults.maybe_fault("ckpt.restore")
        for s in reversed(steps):
            if skip_unhealthy:
                verdict = self.health_verdict(s)
                if verdict is not None and verdict != "ok":
                    self.log(f"warning: checkpoint step {s} has health "
                             f"verdict {verdict!r}; skipping to the "
                             f"previous snapshot")
                    continue
            # an orbax step walks back only on torn bytes: a tree it
            # does not understand raises OrbaxUnreadableError
            torn = (OrbaxTornStepError,) if self._is_orbax(s) else _NPZ_TORN
            try:
                return self._restore_one(s)
            except torn as e:
                # checksum mismatch, a torn zip, member or zarr chunk, a
                # missing key
                self.log(f"warning: checkpoint step {s} is corrupt or "
                         f"partial ({type(e).__name__}: {e}); skipping "
                         f"to the previous snapshot")
        self.log(f"warning: no restorable checkpoint among steps "
                 f"{steps} in {self.dir}")
        return None

    def _restore_one(self, step: int) -> Tuple[Dict, Dict, int]:
        if self._is_orbax(step):
            codec = Codec(native=resolve_device(self.device).type == "cuda")
            state = _read_orbax(os.path.join(self.dir, str(step)), codec)
            return state["params"], state["opt_state"], int(state["step"])
        path = self._verify(step)
        if path is None:
            raise IOError(f"snapshot step_{step}.npz missing or checksum "
                          f"mismatch vs manifest")
        with np.load(path) as data:
            state = _unflatten({k: data[k] for k in data.files})
        return state["params"], state["opt_state"], int(state["step"])


def _read_orbax(stepdir: str, codec: Codec) -> Dict[str, Any]:
    """The state tree of an orbax step directory, as numpy: each leaf of
    `default/_METADATA`'s `tree_metadata` is a zarr array at its key path
    joined with `.`, in the OCDBT database of `default/` (or in plain
    files where the step was written without OCDBT), decoded by
    `codec`.  bf16 leaves come back as f32, which holds each of them
    exactly.  Torn bytes
    raise `OrbaxTornStepError`; a tree or format this reader does not
    understand, `OrbaxUnreadableError`."""
    base = os.path.join(stepdir, "default")
    try:
        with open(os.path.join(base, "_METADATA")) as f:
            meta = json.load(f)
    except (OSError, ValueError) as e:
        raise OrbaxTornStepError(f"{stepdir}: default/_METADATA does not "
                                 f"read ({type(e).__name__}: {e})") from e

    def unreadable(why):
        return OrbaxUnreadableError(f"{stepdir} is an orbax step this "
                                    f"reader does not understand: {why}")
    tree = meta.get("tree_metadata") if isinstance(meta, dict) else None
    if not isinstance(tree, dict):
        raise unreadable("default/_METADATA has no tree_metadata")
    leaves = []
    for entry in tree.values():
        keys = [k.get("key") for k in entry.get("key_metadata", ())]
        if not keys or any(k.get("key_type") != 2
                           for k in entry["key_metadata"]):
            raise unreadable(f"leaf {keys} is not under dict keys alone")
        value = entry.get("value_metadata", {})
        if (value.get("value_type") not in ("jax.Array", "np.ndarray")
                or value.get("skip_deserialize")):
            raise unreadable(f"leaf {keys} is a {value.get('value_type')!r}"
                             f" value, not an array in the kvstore")
        leaves.append([str(k) for k in keys])
    missing = {"params", "opt_state", "step"} - {k[0] for k in leaves}
    if missing:
        raise unreadable(f"the tree lacks {sorted(missing)}")
    try:
        store = (OcdbtStore(base, codec) if meta.get("use_ocdbt", True)
                 else FileStore(base))

        arrays = [read_array(store, ".".join(keys), codec)
                  for keys in leaves]
    except OrbaxUnreadableError as e:
        raise unreadable(str(e)) from e
    root: Dict[str, Any] = {}
    for keys, arr in zip(leaves, arrays):
        d = root
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = arr
    return root


def _flatten(prefix: str, tree) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(f"{prefix}{k}|", v))
    else:
        out[prefix.rstrip("|")] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("|")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def load_pretrained(workspace: str, params: Dict[str, Any],
                    opt_state: Dict[str, Any], device: DeviceLike = None
                    ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
    """kPretrained init: the latest snapshot's params (numpy) over
    `params`, keeping any param absent from the snapshot (a new head);
    its optimizer state and step."""
    restored = CheckpointManager(workspace, device=device).restore()
    if restored is None:
        return params, opt_state, 0
    rp, ro, step = restored
    merged = {**params, **{k: v for k, v in rp.items() if k in params}}
    return merged, ro, step
