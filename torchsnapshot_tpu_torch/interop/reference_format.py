"""Reader for snapshots written by the **reference** torchsnapshot.

The port of ``torchsnapshot_tpu/interop/reference_format.py``. The format
read (all cited from the reference):

- ``.snapshot_metadata`` at the snapshot root: a YAML document
  ``{version, world_size, manifest}`` whose manifest maps
  ``"<rank>/<logical/path>"`` to a tagged-union entry dict
  (manifest.py:14-154);
- entry types ``Tensor`` (location, serializer, dtype, shape, replicated),
  ``ShardedTensor`` (shards: [{offsets, sizes, tensor}]), ``object``
  (location, serializer, obj_type, replicated), and the containers
  ``list``, ``dict`` and ``OrderedDict`` (manifest.py:26-105);
- payloads are ``torch.save`` blobs, one storage object per leaf, under
  ``<rank>/…``, ``replicated/…`` or ``sharded/…`` (io_preparer.py:196-242,
  336-342).

The metadata is parsed as JSON first (what the port's ``convert_back``
writes where PyYAML is absent) and with PyYAML only when that fails; a
block-style YAML document therefore needs PyYAML, and the error says so.

Availability follows the reference's ``get_available_entries``
(manifest.py:157-213): sharded entries merge shards across the saving
ranks; replicated entries resolve for any rank; per-rank entries only
for their owner, with the rank parsed from the whole first path token.

Where the JAX reader returns numpy arrays, this one returns the torch
tensors the payloads hold (on the CPU), so no bfloat16 value needs
``ml_dtypes``; :func:`~._torch_convert.torch_tensor_to_numpy` converts.
"""

import asyncio
import io
import json
import logging
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..flatten import flatten, inflate
from ..io_preparer import dtensor_box, is_dtensor
from ..io_types import IOReq, io_payload
from ..manifest import DictEntry, Entry, ListEntry, OrderedDictEntry
from ..stateful import AppState
from ..storage_plugin import url_to_storage_plugin
from ._torch_convert import torch_dtype_from_name, torch_tensor_to_numpy

logger = logging.getLogger(__name__)

_METADATA_FNAME = ".snapshot_metadata"
_CONTAINER_TYPES = ("list", "dict", "OrderedDict")


def _parse_metadata(text: str) -> Any:
    try:
        return json.loads(text)
    except ValueError:
        pass
    try:
        import yaml
    except ImportError:
        raise RuntimeError(
            "The reference snapshot's metadata is not JSON, and reading its "
            "YAML needs PyYAML, which is not installed."
        ) from None
    return yaml.safe_load(text)


class ReferenceSnapshotReader:
    """Random-access reader over a reference-torchsnapshot snapshot::

        reader = ReferenceSnapshotReader("/path/to/ref_snapshot")
        weight = reader.read("model/linear.weight")      # a CPU tensor, bitwise
        state = reader.load("model")                     # nested state dict
        reader.restore(app_state)                        # into torch templates
        reader.convert("/path/to/native", compression="zlib")
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._storage = None
        self._metadata: Optional[Dict[str, Any]] = None
        self._available_cache: Dict[int, Dict[str, Dict[str, Any]]] = {}

    def close(self) -> None:
        """Release the underlying storage client (idempotent)."""
        if self._storage is not None:
            self._storage.close()
            self._storage = None

    def __enter__(self) -> "ReferenceSnapshotReader":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # ------------------------------------------------------------- metadata

    @property
    def metadata(self) -> Dict[str, Any]:
        if self._metadata is None:
            doc = _parse_metadata(self._read_blob(_METADATA_FNAME).decode("utf-8"))
            if not isinstance(doc, dict) or "manifest" not in doc:
                raise RuntimeError(
                    f"{self.path}/{_METADATA_FNAME} is not a torchsnapshot "
                    f"metadata document."
                )
            self._metadata = doc
        return self._metadata

    @property
    def world_size(self) -> int:
        return int(self.metadata.get("world_size", 1))

    def manifest(self) -> Dict[str, Dict[str, Any]]:
        """The raw rank-prefixed manifest, as saved."""
        return dict(self.metadata["manifest"])

    def available_entries(self, rank: int = 0) -> Dict[str, Dict[str, Any]]:
        """The rank-local view: logical path → entry dict (rank prefix
        stripped, sharded entries merged across saving ranks)."""
        if rank in self._available_cache:
            return dict(self._available_cache[rank])
        grouped: Dict[str, List[Tuple[int, Dict[str, Any]]]] = {}
        for full_path, entry in self.manifest().items():
            rank_token, _, logical = full_path.partition("/")
            try:
                src_rank = int(rank_token)
            except ValueError:
                continue  # not a rank-prefixed path
            grouped.setdefault(logical, []).append((src_rank, entry))

        available: Dict[str, Dict[str, Any]] = {}
        for logical, candidates in grouped.items():
            typ = candidates[0][1].get("type")
            if typ == "ShardedTensor":
                merged: List[Dict[str, Any]] = []
                seen = set()
                for _, entry in candidates:
                    for shard in entry.get("shards", []):
                        key = tuple(shard["offsets"])
                        if key not in seen:
                            seen.add(key)
                            merged.append(shard)
                merged.sort(key=lambda s: tuple(s["offsets"]))
                available[logical] = {"type": "ShardedTensor", "shards": merged}
                continue
            for src_rank, entry in candidates:
                if entry.get("replicated") or src_rank == rank or (
                    typ in _CONTAINER_TYPES and src_rank == candidates[0][0]
                ):
                    available[logical] = entry
                    break
        self._available_cache[rank] = available
        return dict(available)

    # ----------------------------------------------------------------- reads

    def read(self, logical_path: str, rank: int = 0) -> Any:
        """One leaf: a tensor as a CPU tensor, an object unpickled."""
        available = self.available_entries(rank)
        if logical_path not in available:
            preview = ", ".join(sorted(available)[:10])
            raise KeyError(
                f'"{logical_path}" not in the reference snapshot for rank '
                f"{rank}. Available paths include: {preview}"
            )
        return self._read_entry(available[logical_path])

    def load(self, prefix: str = "", rank: int = 0) -> Any:
        """The subtree under ``prefix`` as a nested state dict with tensor
        and object leaves (``load("model")``; ``load("")`` is the whole
        app state keyed by stateful)."""
        available = self.available_entries(rank)
        under = {
            p: e
            for p, e in available.items()
            if not prefix or p == prefix or p.startswith(prefix + "/")
        }
        if not under:
            raise KeyError(f'No entries under "{prefix}" for rank {rank}.')
        containers: Dict[str, Entry] = {}
        flattened: Dict[str, Any] = {}
        for p, e in under.items():
            native = _container_entry(e)
            if native is not None:
                containers[p] = native
            else:
                flattened[p] = self._read_entry(e)
        if not prefix:
            # The top level has no container entry; inflate each stateful.
            top_keys = sorted({p.split("/", 1)[0] for p in under})
            return {k: _inflate_key(k, containers, flattened) for k in top_keys}
        return _inflate_key(prefix, containers, flattened)

    # --------------------------------------------------------------- restore

    def restore(self, app_state: AppState, rank: int = 0) -> None:
        """Restore ``app_state`` in place from the reference snapshot.

        Template-driven, as the reference's restore: each stateful's
        ``state_dict()`` gives structure and placement. A tensor template
        receives the value in place (``copy_``, keeping its device); a
        DTensor template its local box; a numpy template numpy. Saved and
        template dtypes and shapes must match: migration does not cast.
        One process; migration off a reference snapshot is an offline
        step."""
        available = self.available_entries(rank)
        for key in sorted(app_state.keys()):
            stateful = app_state[key]
            container_manifest, flattened = flatten(stateful.state_dict(), prefix=key)
            for logical_path, template in flattened.items():
                if logical_path not in available:
                    raise RuntimeError(
                        f'No entry for "{logical_path}" (rank {rank}) in the '
                        f"reference snapshot (world_size={self.world_size}). "
                        f"Per-rank values resolve only for their saving rank; "
                        f"pass rank=<owner>."
                    )
                value = self._read_entry(available[logical_path])
                flattened[logical_path] = _place_like(value, template, logical_path)
            stateful.load_state_dict(inflate(container_manifest, flattened, prefix=key))

    def convert(self, dest_path: str, rank: int = 0, **take_kwargs: Any) -> Any:
        """Rewrite the snapshot in the native format with
        :meth:`Snapshot.take` (``take_kwargs`` pass through); returns its
        handle. One process: sharded tensors are assembled dense,
        replicated values carried once, and per-rank values of *other*
        ranks raise, naming them, rather than being dropped."""
        from ..snapshot import Snapshot
        from ..utils.train_state import PytreeStateful

        foreign = self._foreign_per_rank_paths(rank)
        if foreign:
            raise RuntimeError(
                f"convert() runs single-process but the snapshot holds "
                f"per-rank values owned by other ranks: "
                f"{', '.join(sorted(foreign)[:10])}. Convert each rank "
                f"separately (rank=<owner>) or restore+retake under the "
                f"original world size."
            )
        tree = self.load("", rank=rank)
        # Dict subclasses (the reference's pickled StateDict) flatten as
        # leaves; plain containers land leaf per object.
        app_state = {key: PytreeStateful(_plainify(sd)) for key, sd in tree.items()}
        return Snapshot.take(dest_path, app_state, **take_kwargs)

    def _foreign_per_rank_paths(self, rank: int) -> List[str]:
        foreign = []
        for full_path, entry in self.manifest().items():
            rank_token, _, logical = full_path.partition("/")
            try:
                src_rank = int(rank_token)
            except ValueError:
                continue
            if src_rank == rank or entry.get("replicated"):
                continue
            if entry.get("type") in ("ShardedTensor",) + _CONTAINER_TYPES:
                continue
            foreign.append(logical)
        return foreign

    # -------------------------------------------------------------- payloads

    def _read_entry(self, entry: Dict[str, Any]) -> Any:
        typ = entry.get("type")
        if typ == "Tensor":
            return self._read_tensor(entry)
        if typ == "ShardedTensor":
            return self._read_sharded(entry)
        if typ == "object":
            return _torch_load(self._read_blob(entry["location"]))
        raise RuntimeError(f"Unrecognized reference entry type: {typ!r}")

    def _read_tensor(self, entry: Dict[str, Any]) -> torch.Tensor:
        if entry.get("serializer") != "torch_save":
            raise RuntimeError(
                f"Unsupported serializer {entry.get('serializer')!r} "
                f"(reference io_preparer.py always writes torch_save)."
            )
        tensor = _torch_load(self._read_blob(entry["location"]))
        expected = torch_dtype_from_name(entry["dtype"])
        if (
            not isinstance(tensor, torch.Tensor)
            or tensor.dtype != expected
            or list(tensor.shape) != list(entry["shape"])
        ):
            got = (
                f"{tensor.dtype}{list(tensor.shape)}"
                if isinstance(tensor, torch.Tensor) else type(tensor).__name__
            )
            raise RuntimeError(
                f"Payload at {entry['location']} decodes as {got} but the "
                f"manifest records {expected}{entry['shape']} — corrupt or "
                f"tampered snapshot."
            )
        return tensor

    def _read_sharded(self, entry: Dict[str, Any]) -> torch.Tensor:
        shards = entry["shards"]
        if not shards:
            raise RuntimeError("ShardedTensor entry with no shards.")
        ndim = len(shards[0]["offsets"])
        global_shape = [
            max(s["offsets"][d] + s["sizes"][d] for s in shards) for d in range(ndim)
        ]
        out = torch.zeros(global_shape, dtype=torch_dtype_from_name(shards[0]["tensor"]["dtype"]))
        for shard in shards:
            sub = self._read_tensor(shard["tensor"])
            sel = tuple(slice(o, o + s) for o, s in zip(shard["offsets"], shard["sizes"]))
            out[sel] = sub.reshape(shard["sizes"])
        return out

    def _read_blob(self, rel_path: str) -> bytes:
        # One storage client for the reader's lifetime (a client a read
        # would redo auth and sessions for every leaf on gs:// or s3://);
        # close() or the context manager releases it.
        if self._storage is None:
            self._storage = url_to_storage_plugin(self.path)
        req = IOReq(path=rel_path)
        asyncio.run(self._storage.read(req))
        return bytes(io_payload(req))


def _torch_load(blob: bytes) -> Any:
    # weights_only=False: torch >= 2.6 defaults to True, which refuses the
    # reference's object entries. The bytes are the snapshot's own.
    return torch.load(io.BytesIO(blob), map_location="cpu", weights_only=False)


def _inflate_key(prefix: str, containers: Dict[str, Entry], flattened: Dict[str, Any]) -> Any:
    def under(p: str) -> bool:
        return p == prefix or p.startswith(prefix + "/")

    sub_c = {p: e for p, e in containers.items() if under(p)}
    sub_f = {p: v for p, v in flattened.items() if under(p)}
    if not sub_c and len(sub_f) == 1 and prefix in sub_f:
        return sub_f[prefix]
    return inflate(sub_c, sub_f, prefix=prefix)


def _plainify(tree: Any) -> Any:
    """Container subclasses as plain dict / OrderedDict / list."""
    if isinstance(tree, OrderedDict):
        return OrderedDict((k, _plainify(v)) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: _plainify(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plainify(v) for v in tree]
    return tree


def _container_entry(entry: Dict[str, Any]) -> Optional[Entry]:
    typ = entry.get("type")
    if typ == "list":
        return ListEntry()
    if typ == "OrderedDict":
        return OrderedDictEntry(keys=list(entry.get("keys", [])))
    if typ == "dict":
        return DictEntry(keys=list(entry.get("keys", [])))
    return None


def _place_like(value: Any, template: Any, path: str) -> Any:
    """Fit a decoded value to a restore template (placement, not casting)."""
    if isinstance(template, torch.Tensor):
        if not isinstance(value, torch.Tensor):
            raise RuntimeError(
                f'"{path}": template is a tensor but the snapshot holds a '
                f"{type(value).__name__}."
            )
        if value.dtype != template.dtype:
            raise RuntimeError(
                f'"{path}": dtype mismatch (snapshot {value.dtype}, template '
                f"{template.dtype}). Cast the template instead — migration "
                f"does not silently convert."
            )
        if tuple(template.shape) != tuple(value.shape):
            raise RuntimeError(
                f'"{path}": shape mismatch (snapshot {list(value.shape)}, '
                f"template {list(template.shape)})."
            )
        with torch.no_grad():
            if not is_dtensor(template):
                template.copy_(value)
            elif dtensor_box(template) is not None:
                offsets, sizes = dtensor_box(template)
                template.to_local().copy_(
                    value[tuple(slice(o, o + n) for o, n in zip(offsets, sizes))]
                )
        return template
    if isinstance(template, np.ndarray):
        if not isinstance(value, torch.Tensor):
            raise RuntimeError(
                f'"{path}": template is a numpy array but the snapshot holds '
                f"a {type(value).__name__}."
            )
        arr = torch_tensor_to_numpy(value)
        if template.dtype != arr.dtype or template.shape != arr.shape:
            raise RuntimeError(
                f'"{path}": snapshot holds {arr.dtype}{list(arr.shape)}, '
                f"template expects {template.dtype}{list(template.shape)}."
            )
        return arr
    return value
