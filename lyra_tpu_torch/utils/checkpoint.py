"""Stream-state checkpoint/restore — the port's copy of
lyra_tpu/utils/checkpoint.py.

Draining a serving host for maintenance without dropping its live calls
means snapshotting the per-stream state tree and restoring it on another
host.  Trees are nested dicts of arrays, saved as one .npz with
separator-joined keys (unit separator, since model state names contain
`/`) plus a version/codec-identifier header that is checked on restore.

The format is the JAX package's to the byte (same header key, separator,
empty-dict marker and version check), so a snapshot written by either
package restores in the other in float mode.  The device→host copy goes
through `state_to_numpy`, so leaves carry the JAX package's dtypes; bf16
leaves are stored by their 16-bit pattern and come back from `np.load`
as `|V2`, which `state_from_numpy` takes bit for bit.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np

from lyra_tpu_torch import config
from lyra_tpu_torch.utils.state import state_to_numpy

_HEADER_KEY = "__lyra_tpu_header__"
_SEP = "\x1f"
_EMPTY_DIR = "\x1e.empty"  # marker leaf name preserving empty-dict subtrees
# (\x1e can't occur in real state keys; NUL would be truncated by zip names)
# Data keys are namespaced so no state-dict key can collide with np.savez's
# positional `file` parameter or with the header entry.
_DATA_PREFIX = "d" + _SEP


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree and prefix:
            # Preserve empty-dict subtrees: dropping them would restore a
            # different tree structure than was saved.
            out[prefix + _EMPTY_DIR] = np.zeros(0, np.uint8)
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = tree
        if parts[-1] == _EMPTY_DIR:
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            continue
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _canonical(path: str) -> str:
    # np.savez appends ".npz" itself; keep save/load agreeing on the name.
    return path if path.endswith(".npz") else path + ".npz"


def _check_header(header: Dict[str, Any]) -> None:
    if header["identifier"] != config.VERSION_MINOR:
        raise ValueError(
            f"checkpoint identifier {header['identifier']} incompatible with "
            f"codec identifier {config.VERSION_MINOR}")


def save_state(path: str, state: Any, extra: Dict[str, Any] | None = None) -> None:
    """Snapshot an engine state tree of torch tensors (host copy + .npz).

    The write is atomic (tmp file + rename): a periodic serving snapshot is
    a crash-failover source, so a host dying mid-save must leave the
    previous complete snapshot in place, never a truncated one."""
    path = _canonical(path)
    if not isinstance(state, dict):
        raise TypeError("save_state expects a dict state tree at the root")
    flat = _flatten(state_to_numpy(state))
    header = json.dumps({
        "version": config.version_string(),
        "identifier": config.VERSION_MINOR,
        "extra": extra or {},
    })
    tmp = path + ".tmp.npz"  # explicit suffix so np.savez cannot re-append
    np.savez(tmp, **{_DATA_PREFIX + k: v for k, v in flat.items()},
             **{_HEADER_KEY: np.frombuffer(header.encode(), dtype=np.uint8)})
    os.replace(tmp, path)


def load_state(path: str) -> tuple[Any, Dict[str, Any]]:
    """Restore a numpy state tree (`state_from_numpy` puts it on a device)
    and the extra header; raises on codec-version mismatch."""
    path = _canonical(path)
    with np.load(path) as data:
        flat = {k[len(_DATA_PREFIX):]: data[k] for k in data.files
                if k.startswith(_DATA_PREFIX)}
        if not flat:
            # Legacy snapshot (pre key-namespacing): data keys are bare.
            flat = {k: data[k] for k in data.files if k != _HEADER_KEY}
        header = json.loads(bytes(data[_HEADER_KEY]).decode())
    _check_header(header)
    return _unflatten(flat), header.get("extra", {})


def peek_extra(path: str) -> Dict[str, Any]:
    """Read only a snapshot's extra header (no state arrays): np.load is a
    lazy zip reader, so this stays cheap even for multi-GB snapshots."""
    path = _canonical(path)
    with np.load(path) as data:
        header = json.loads(bytes(data[_HEADER_KEY]).decode())
    _check_header(header)
    return header.get("extra", {})
