"""Device meshes for the engine's batched device work (port of
pav_tpu.parallel.mesh).

A mesh is an ordered list of ``torch.device``: a batch splits along its
leading axis into ``len(mesh)`` equal contiguous row shards, shard i on
``mesh[i]``, as ``NamedSharding(mesh, P('dp'))`` places it in the reference.
Every batched op of the engine is independent per row, so shards need no
collectives: each runs on its own device and the results concatenate in
order. A mesh may name one device more than once: ``make_mesh(n, 'cpu')``
gives n logical shards on the CPU, the counterpart of the reference tests'
virtual 8-device CPU mesh.
"""

import contextlib

import numpy as np
import torch


def make_mesh(n_devices, device):
    """A mesh of ``n_devices`` shards for ``device``'s type.

    :param device: ``cuda`` gives ``[cuda:0 ... cuda:n-1]``; ``cpu`` gives n
        logical shards on the CPU.
    :raises ValueError: fewer than ``n_devices`` CUDA devices exist (the
        reference silently stays on one device there; a missing device is
        not hidden here), or ``n_devices < 1``.
    """
    n = int(n_devices)
    if n < 1:
        raise ValueError(f'a mesh needs at least one device, got {n}')
    dev = torch.device(device)
    if dev.type == 'cpu':
        return [dev] * n
    if dev.type != 'cuda':
        raise ValueError(f'unsupported mesh device {str(dev)!r} (cuda or cpu)')
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f'a {n}-device mesh needs {n} CUDA devices; '
                         f'torch.cuda.device_count() is {have}')
    return [torch.device('cuda', i) for i in range(n)]


def pad_to_multiple(arr, multiple, axis=0, fill=0):
    """Pad a numpy array along ``axis`` so its length divides ``multiple``.
    Returns (padded, original length)."""
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill), n


def shard_batch(mesh, tensor):
    """Split ``tensor``'s leading axis into ``len(mesh)`` equal contiguous
    parts, part i copied to ``mesh[i]`` (a view where it already lies there).

    :raises ValueError: the leading axis does not divide by the mesh size.
    """
    parts = len(mesh)
    if tensor.shape[0] % parts:
        raise ValueError(f'batch of {tensor.shape[0]} rows does not split '
                         f'into {parts} equal shards')
    rows = tensor.shape[0] // parts
    return [tensor[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(mesh)]


def place_batch(host, mesh=None, device=None):
    """Where a batch of host tensors runs: [(device, [tensor per input])].

    One entry per mesh device, holding its row shard of every input, when
    the mesh size divides the leading axis (the reference's condition for a
    sharded put); otherwise one entry with the whole batch on ``device``.

    :raises ValueError: no mesh that divides the batch, and no device.
    """
    if mesh is not None and host[0].shape[0] % len(mesh) == 0:
        return list(zip(mesh, zip(*(shard_batch(mesh, a) for a in host))))
    if device is None:
        raise ValueError('a batch needs a device (or a mesh that divides it)')
    dev = torch.device(device)
    return [(dev, [a.to(dev) for a in host])]


def on_device(device):
    """Context making ``device`` current for CUDA (its current stream takes
    the launches); a no-op for the CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()
