"""Device placement of the fleet's shards (port of part of
``repro.runtime.sharding``).

Only the fleet router's placement is ported: ``fleet_device_groups``
partitions the local CUDA devices into one contiguous, equal-size, disjoint
group a shard, so a shard's death is a device-group event and the
survivors' slot tensors live elsewhere.  Each shard's engine runs on the
FIRST device of its group (``launch/fleet.py``); data-parallel slots
inside a shard, the reference's ``fleet_meshes``, its logical-axis rules
and the shardings built from them wait for the port's sharded step (ROADMAP
Queue 1 item 9).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

__all__ = ["fleet_device_groups"]


def fleet_device_groups(n_shards: int, devices: Optional[Sequence] = None
                        ) -> Optional[List[list]]:
    """Partition ``devices`` (default: ``cuda:i`` for every visible CUDA
    device) into ``n_shards`` contiguous, equal-size, disjoint groups.

    Leftover devices (when the count does not divide) stay unused rather
    than unbalancing shards.  Returns ``None`` when there are fewer devices
    than shards: every shard then shares the default device (one card, or
    the CPU), and placement is a no-op.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if len(devices) < n_shards:
        return None
    k = len(devices) // n_shards
    return [list(devices[i * k:(i + 1) * k]) for i in range(n_shards)]
