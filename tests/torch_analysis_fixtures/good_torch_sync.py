"""PyTorch's host syncs kept off the event loop: handed to
``loop.run_in_executor`` or ``asyncio.to_thread`` (as arguments, never
called on the loop), or in plain sync code that no ``async def`` calls.
Neither SNAP001 nor SNAP007 fires here. The ``# sync:`` markers name the
sync a line holds."""

import asyncio

import torch


def host_step(t, event):
    torch.cuda.synchronize()  # sync: torch.cuda.synchronize
    event.synchronize()  # sync: .synchronize
    value = t.item()  # sync: .item
    host = t.cpu()  # sync: .cpu
    array = host.numpy()  # sync: .numpy
    return value, array, t.tolist()  # sync: .tolist


async def through_executor(t, event):
    loop = asyncio.get_running_loop()
    await loop.run_in_executor(None, torch.cuda.synchronize)
    await loop.run_in_executor(None, event.synchronize)
    await loop.run_in_executor(None, t.item)
    await asyncio.to_thread(t.cpu)
    await asyncio.to_thread(t.numpy)
    await asyncio.to_thread(t.tolist)
    return await asyncio.to_thread(host_step, t, event)
