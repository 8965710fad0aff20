"""snaptier: preemption-tolerant hot checkpoint tier.

``async_take`` acknowledges once each rank's objects are k-replicated
in peer hosts' RAM; a background drain tiers them down to the durable
plugin and records a ``.tierdown`` watermark beside the manifest;
``restore`` prefers the (fingerprint-verified) hot tier and falls back
per-object to the durable tier when peers are dead, stale, or corrupt —
so a preempted job restores at RAM speed instead of storage speed, and
any k-1 simultaneous host losses still restore bit-exact.

Quickstart::

    from torchsnapshot_tpu_torch import hottier

    hottier.enable_hot_tier()          # k from TPUSNAPSHOT_HOT_TIER_K,
                                       # per-host RAM cap from
                                       # TPUSNAPSHOT_HOT_TIER_BYTES
    pending = Snapshot.async_take(path, app_state)   # acks at RAM speed
    ...
    snapshot.restore(app_state)        # served from peer RAM when hot

Layering and the failure model are documented in runtime.py/tier.py.
The port of the JAX package's ``hottier``, with its names, environment
variables, metric names, file names and wire format: a port peer and a
JAX peer serve each other's replicas, and a snapshot taken through either
package's tier restores through the other. The tier itself runs no
kernel: it holds the payload bytes between a take's device-to-host copy
and a restore's host-to-device copy.
"""

from .plugin import TieredPlugin
from .runtime import (
    BYTES_ENV_VAR,
    K_ENV_VAR,
    TIERDOWN_FNAME,
    HotTierRuntime,
    disable_hot_tier,
    drain_now,
    durability_lag_s,
    enable_hot_tier,
    forget_root,
    hot_tier,
    introspect,
    is_enabled,
    is_payload_path,
    reconcile_hot_tier,
    repair_plane,
    repair_tick,
    replication_stats_begin,
    replication_stats_collect,
    reset_pending,
    restore_stats_begin,
    restore_stats_collect,
    runtime,
    wait_drained,
)
from .tier import (
    HostLostError,
    buffered_roots,
    condemn_host,
    host_generation,
    kill_host,
    live_hosts,
    live_replicas,
    register_remote_host,
    remote_host,
    remote_hosts,
    reset_hot_tier,
    revive_host,
    total_buffered_bytes,
    unregister_remote_host,
)
from . import peer, repair, transport  # noqa: F401  (snapwire/snapmend)

__all__ = [
    "BYTES_ENV_VAR",
    "HostLostError",
    "HotTierRuntime",
    "K_ENV_VAR",
    "TIERDOWN_FNAME",
    "TieredPlugin",
    "buffered_roots",
    "condemn_host",
    "disable_hot_tier",
    "drain_now",
    "durability_lag_s",
    "enable_hot_tier",
    "forget_root",
    "host_generation",
    "hot_tier",
    "introspect",
    "is_enabled",
    "is_payload_path",
    "kill_host",
    "live_hosts",
    "live_replicas",
    "peer",
    "reconcile_hot_tier",
    "register_remote_host",
    "remote_host",
    "repair",
    "repair_plane",
    "repair_tick",
    "replication_stats_begin",
    "replication_stats_collect",
    "remote_hosts",
    "reset_hot_tier",
    "reset_pending",
    "restore_stats_begin",
    "restore_stats_collect",
    "revive_host",
    "runtime",
    "total_buffered_bytes",
    "transport",
    "unregister_remote_host",
    "wait_drained",
]
