"""RemoteSnapshot: the Snapshot API over the snapserve read plane.

A :class:`RemoteSnapshot` IS a :class:`~torchsnapshot_tpu_torch.Snapshot`
whose path routes reads through a snapserve server — ``restore``,
``read_object``, ``get_manifest``, ``verify``, and the inspect CLI all
work unchanged, because the service hop lives entirely inside the
``snapserve://`` storage plugin. Incremental snapshots work too: base
references resolve relative to the snapserve URL, so base-root reads
ride the same server (and its cache).
"""

import os
from typing import Optional

from ..coord import Coordinator
from ..snapshot import Snapshot
from .client import ADDR_ENV_VAR


def snapserve_url(backend_path: str, addr: str) -> str:
    """``snapserve://<addr>/<backend_path>`` for a backend URL/path."""
    if backend_path.startswith("snapserve://"):
        return backend_path
    return f"snapserve://{addr}/{backend_path}"


class RemoteSnapshot(Snapshot):
    """A snapshot handle whose reads fan in through a snapserve server.

    ``addr`` defaults to ``TPUSNAPSHOT_SNAPSERVE_ADDR``; with neither
    set this degrades to a plain direct :class:`Snapshot` — code can
    construct ``RemoteSnapshot`` unconditionally and let deployment
    config decide whether a read plane exists.
    """

    def __init__(
        self,
        path: str,
        addr: Optional[str] = None,
        coord: Optional[Coordinator] = None,
    ) -> None:
        if addr is None:
            addr = os.environ.get(ADDR_ENV_VAR) or None
        if path.startswith("snapserve://"):
            full = path
            self.backend_path = path.split("://", 1)[1].partition("/")[2]
        elif addr:
            full = snapserve_url(path, addr)
            self.backend_path = path
        else:
            full = path
            self.backend_path = path
        self.server_addr = addr
        super().__init__(full, coord)

    def direct(self) -> Snapshot:
        """A plain direct-backend handle to the same snapshot (ops
        tooling: delete/sweep/verify without loading the read plane)."""
        return Snapshot(self.backend_path, coord=self._coord)
