"""PyTorch's host syncs on the event loop. Each one fires SNAP001 where it
sits directly in an ``async def``, and SNAP007 where a sync helper that
the ``async def`` calls runs it. The ``# sync:`` markers name the sync a
line holds; the tests find the lines by them."""

import torch


async def direct(t, event, stream):
    torch.cuda.synchronize()  # sync: torch.cuda.synchronize
    event.synchronize()  # sync: .synchronize
    stream.synchronize()  # sync: .synchronize
    torch.cuda.current_stream().synchronize()  # sync: .synchronize
    t.item()  # sync: .item
    t.cpu()  # sync: .cpu
    t.numpy()  # sync: .numpy
    t.tolist()  # sync: .tolist


def _wait_device():
    torch.cuda.synchronize()  # helper: torch.cuda.synchronize


def _wait_event(event):
    event.synchronize()  # helper: .synchronize


def _read_scalar(t):
    return t.item()  # helper: .item


def _to_host(t):
    return t.cpu()  # helper: .cpu


def _to_array(t):
    return t.numpy()  # helper: .numpy


def _to_list(t):
    return t.tolist()  # helper: .tolist


async def drain_step(t, event):
    _wait_device()
    _wait_event(event)
    _read_scalar(t)
    _to_host(t)
    _to_array(t)
    _to_list(t)
